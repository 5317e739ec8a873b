"""The port's copies of the JAX package's jax-free spec layer, of the
spec driver's schedules, monitors, adversaries, attacks and protocol
variants, of its riders' DAS server, single-flight and light-client
modules, of the tooling's watchdog, event bus, metrics registry,
tracing, fleet aggregator and supervisor, and of the serving tier's
protocol, views, admission, client, front, chaos, view board and
balancer, and of the static analysis's shared rules and reporter: each
copied module's source equals its original with ``pos_evolution_tpu.``
replaced by ``pos_evolution_tpu_torch.`` and nothing else (the view board
and the balancer with one repair each besides, and the analysis core with
its rule list naming the torch rules, listed in ``PATCHED``), and the FakeBLS
signature prefix the copy carries is the one kernel K1's wrapper hashes."""

import os

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "config.py",
    "crypto/bls.py",
    "utils/traversal.py",
    "ssz/__init__.py",
    "ssz/core.py",
    "specs/__init__.py",
    "specs/containers.py",
    "specs/helpers.py",
    "specs/epoch.py",
    "specs/transition.py",
    "specs/genesis.py",
    "specs/validator.py",
    "specs/forkchoice.py",
    "specs/merge.py",
    "specs/deposits.py",
    "specs/slasher.py",
    "specs/weak_subjectivity.py",
    "models/pvm.py",
    "sim/schedule.py",
    "sim/monitors.py",
    "sim/adversary.py",
    "sim/attacks.py",
    "variants/__init__.py",
    "variants/base.py",
    "variants/gasper.py",
    "variants/goldfish.py",
    "variants/rlmd.py",
    "variants/ssf.py",
    "utils/singleflight.py",
    "das/server.py",
    "lightclient/__init__.py",
    "lightclient/containers.py",
    "lightclient/proofs.py",
    "lightclient/verify.py",
    "lightclient/spec.py",
    "lightclient/server.py",
    "lightclient/node.py",
    "utils/watchdog.py",
    "telemetry/events.py",
    "telemetry/registry.py",
    "telemetry/tracing.py",
    "telemetry/fleet.py",
    "resilience/supervision.py",
    "resilience/supervisor.py",
    "profiling/xplane.py",
    "profiling/history.py",
    "crypto/bls12_381.py",
    "serve/protocol.py",
    "serve/state.py",
    "serve/admission.py",
    "serve/client.py",
    "serve/server.py",
    "serve/chaos.py",
    "serve/__init__.py",
    "analysis/lockset.py",
    "analysis/rules_determinism.py",
    "analysis/rules_hygiene.py",
    "analysis/rules_mp.py",
    "analysis/report.py",
]

# copies with a repair, or with the one change the port needs: the original
# with the prefix replaced and each (original text, new text) pair applied,
# and nothing else
_SWEEP = """                self._finish(li, ltier, "lost", now - lsched)
        self.wall_s = time.monotonic() - t_start
"""
_FD = """        self._lock_fd: int | None = None
"""
_LOCK = """    def _flock(self):
        if self._lock_fd is None:
            self._lock_fd = os.open(self.lock_path, os.O_RDWR)
        fcntl.flock(self._lock_fd, fcntl.LOCK_EX)
        return self._lock_fd

    def _funlock(self) -> None:
        fcntl.flock(self._lock_fd, fcntl.LOCK_UN)
"""
PATCHED = {
    # the rule modules all_rules() loads: the torch rules for the JAX rules
    "analysis/core.py": [("""    from . import (lockset, rules_determinism, rules_hygiene,  # noqa: F401
                   rules_jax, rules_mp)
""", """    from . import (lockset, rules_determinism, rules_hygiene,  # noqa: F401
                   rules_mp, rules_torch)
""")],
    "serve/shm.py": [(_FD, _FD + """\
        # flock excludes other open files only, not the threads sharing
        # this one: they take this lock first, which also keeps two first
        # callers from each opening the lock file (the lock held through
        # one descriptor, released through the other, never released)
        self._tlock = threading.Lock()
"""), (_LOCK, """\
    def _flock(self):
        self._tlock.acquire()
        try:
            if self._lock_fd is None:
                self._lock_fd = os.open(self.lock_path, os.O_RDWR)
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX)
        except BaseException:
            self._tlock.release()
            raise
        return self._lock_fd

    def _funlock(self) -> None:
        try:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)
        finally:
            self._tlock.release()
""")],
    "serve/balancer.py": [(_SWEEP, _SWEEP.replace("""        self.wall_s""", """\
        # the sweep reaches only the grid's connections: one a failover
        # displaced from its slot, and a retry the stopped retry thread
        # never sent, still hold arrivals. Lost all the same, so that
        # records == schedule
        now = time.monotonic()
        for li in range(self.n):
            with self._lock:
                if self._resolved[li]:
                    continue
                self.lost += 1
                self.lost_by_reason["unswept"] = \\
                    self.lost_by_reason.get("unswept", 0) + 1
            self._finish(li, int(is_bulk[li]), "lost",
                         now - (t_start + offsets[li]))
        self.wall_s"""))],
}


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_original_with_the_prefix_replaced(path):
    original = _read("pos_evolution_tpu", path)
    copy = _read("pos_evolution_tpu_torch", path)
    assert copy == original.replace("pos_evolution_tpu.", "pos_evolution_tpu_torch.")


@pytest.mark.parametrize("path", sorted(PATCHED))
def test_patched_copy_equals_original_with_its_repairs(path):
    original = _read("pos_evolution_tpu", path).replace(
        "pos_evolution_tpu.", "pos_evolution_tpu_torch.")
    for old, new in PATCHED[path]:
        assert original.count(old) == 1, old
        original = original.replace(old, new)
    assert _read("pos_evolution_tpu_torch", path) == original


@pytest.mark.parametrize("path", COPIES + sorted(PATCHED))
def test_copy_names_no_module_of_the_jax_package(path):
    copy = _read("pos_evolution_tpu_torch", path)
    for line in copy.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped.split()[1], line
            assert stripped.split()[1].split(".")[0] != "pos_evolution_tpu", line


def test_sig_prefix_is_the_one_k1_hashes():
    from pos_evolution_tpu.crypto.bls import FakeBLS as JaxFakeBLS
    from pos_evolution_tpu_torch.crypto.bls import FakeBLS
    from pos_evolution_tpu_torch.ops.aggregation import _PREFIX
    assert FakeBLS.SIG_PREFIX == _PREFIX == JaxFakeBLS.SIG_PREFIX


def test_copied_modules_are_the_ports():
    """The copies import the port's modules: the spec layer's backend,
    merkleizer and config are the port's own."""
    import pos_evolution_tpu_torch.specs.transition as st
    import pos_evolution_tpu_torch.ssz as ssz
    assert ssz.merkleize_chunks.__module__ == "pos_evolution_tpu_torch.ssz.merkle"
    assert st.cfg.__module__ == "pos_evolution_tpu_torch.config"
    from pos_evolution_tpu_torch.specs import containers
    assert containers.BeaconState.__ssz_root__.__module__ == \
        "pos_evolution_tpu_torch.specs.containers"


def test_rider_copies_reach_the_ports_dispatch():
    """The copied DAS server and light-client verifier call the port's
    backend dispatch entries, and the server's scheme contract is the
    port's."""
    from pos_evolution_tpu_torch.das import server
    from pos_evolution_tpu_torch.lightclient import verify
    assert server.verify_das_samples.__module__ == "pos_evolution_tpu_torch.ops.das_verify"
    assert server.CellCommitmentScheme.__module__ == "pos_evolution_tpu_torch.das.commitment"
    assert verify.verify_sync_update_batch.__module__ == "pos_evolution_tpu_torch.ops.sync_verify"
    assert server.cfg.__module__ == "pos_evolution_tpu_torch.config"


def test_serve_copies_reach_the_ports_modules():
    """The copied serving front builds its proofs through the port's DAS
    server and scheme contract, under the port's config."""
    from pos_evolution_tpu_torch.serve import server, shm
    assert server.DasServer.__module__ == "pos_evolution_tpu_torch.das.server"
    assert shm.ServeView.__module__ == "pos_evolution_tpu_torch.serve.state"
    from pos_evolution_tpu_torch.serve.workers import worker_spec
    assert worker_spec.__module__ == "pos_evolution_tpu_torch.serve.workers"
