"""The port's run supervision against the JAX package's on the CPU,
tolerance 0: digests, roots and manifests are exact.

- ``CheckpointManager``: for the same payloads the port writes the JAX
  package's layout and manifest (sha256 and merkle hex), quarantines,
  retains and recovers a displaced ``.old-`` step as it does, and its
  merkle digest equals the JAX package's ``_merkle_hex``; a K2 failure
  raises, on write and on validation, and quarantines nothing;
- ``RunSupervision`` picks its digest by the device, never the name;
- a dense run at n = 256 and a spec run at BASELINE config 1's 1,024
  validators cut to 8 slots (both on the minimal config): the supervised,
  killed and resumed port run (``python -m
  pos_evolution_tpu_torch.resilient_run`` in a subprocess), the
  uninterrupted port run and the JAX package's run with
  ``autocheckpoint=`` end on the same ``state_digest``;
- the new modules and the ``resilient_run`` child run with jax and
  pos_evolution_tpu impossible to import.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.resilience import manager as jmanager  # noqa: E402
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim import Simulation as JaxSim  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxDense  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels, merkle_device  # noqa: E402
from pos_evolution_tpu_torch.resilience import (  # noqa: E402
    CheckpointManager,
    RunSupervision,
    state_digest,
)
from pos_evolution_tpu_torch.resilience import manager as tmanager  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.sim.driver import Simulation  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = TorchBackend("cpu")
DENSE_N, DENSE_EPOCHS = 256, 2          # minimal config: 16 slots
SPEC_N, SPEC_SLOT = 1024, 8             # BASELINE config 1's registry, to slot 8
CHILD_TIMEOUT = 240                     # a subprocess run's own limit, seconds


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensor ops under parallel test workers
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resilient_run(tmp_path, *args):
    """The port's supervised run in a subprocess (device cpu): its
    emission, its result.json and its events."""
    events = tmp_path / "events.jsonl"
    out = tmp_path / "out.json"
    store = tmp_path / "store"
    # the hang timeout is far above a child's start-up (a torch import and a
    # small run take seconds here); the child beats before it imports torch
    cmd = [sys.executable, "-m", "pos_evolution_tpu_torch.resilient_run", "--device", "cpu",
           "--ckpt-dir", str(store), "--events", str(events), "--json", str(out),
           "--hang-timeout", "120", "--backoff", "0.05", *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                                         "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        emission = json.load(f)
    with open(store / "result.json") as f:
        result = json.load(f)
    with open(events) as f:
        evs = [json.loads(line) for line in f]
    return emission, result, evs


def _interrupted_at(evs, step):
    types = [e["type"] for e in evs]
    assert types.count("supervisor_interruption") == 1
    assert [e["step"] for e in evs if e["type"] == "run_resumed"] == [step]
    assert "goodput" in types and types[-1] == "goodput"


# --- the dense driver ------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """The JAX package's supervised dense run and the port's uninterrupted
    one, the construction ``resilient_run --dense`` makes."""
    d = tmp_path_factory.mktemp("jax_dense")
    with jc.use_config(jc.minimal_config()):
        jsim = JaxDense(DENSE_N, cfg=jc.minimal_config(), verify_aggregates=False,
                        check_walk_every=8, autocheckpoint=(8, str(d)))
        while jsim.slot < DENSE_EPOCHS * 8:
            jsim.run_slot()
        jstats = jsim.finish_autocheckpoint()
        jdig = jax_digest(jsim)
    with tc.use_config(tc.minimal_config()):
        sim = DenseSimulation(DENSE_N, cfg=tc.minimal_config(), device="cpu",
                              verify_aggregates=False, check_walk_every=8)
        while sim.slot < DENSE_EPOCHS * 8:
            sim.run_slot()
    return {"jax_digest": jdig, "jax_stats": jstats, "jax_dir": d,
            "port_digest": state_digest(sim)}


def test_dense_uninterrupted_equals_jax_supervised(dense_runs):
    assert dense_runs["port_digest"] == dense_runs["jax_digest"]
    assert dense_runs["jax_stats"]["saves"] == 3   # steps 8, 16 and the final 16


def test_dense_killed_and_resumed_equals_uninterrupted(dense_runs, tmp_path):
    emission, result, evs = _resilient_run(
        tmp_path, "--dense", "--validators", str(DENSE_N), "--epochs", str(DENSE_EPOCHS),
        "--every", "8", "--crash-at-slot", "12")
    assert result["state_digest"] == emission["state_digest"] == dense_runs["port_digest"]
    assert result["slot"] == 16 and result["digest"] == "sha256"
    assert emission["attempts"] == 2 and emission["replayed_slots"] == 4
    _interrupted_at(evs, 8)
    assert result["resume"]["slot"] == 8 and result["resume"]["k2_launches"] == 0
    # the raw columns: nine registry columns, three message columns and the
    # permutation, 79 bytes a validator
    assert [t["raw_bytes"] for t in result["checkpoint_ticks"]] == [79 * DENSE_N]
    assert [w["step"] for w in result["checkpoint_writes"]] == [16, 16]
    # the port's checkpoint bytes (deflate level 1) resume in the JAX package
    payload = (tmp_path / "store" / "step_00000016" / "payload.bin").read_bytes()
    with jc.use_config(jc.minimal_config()):
        assert jax_digest(JaxDense.resume(payload)) == dense_runs["port_digest"]


def test_dense_resume_latest_continues_a_supervised_run(tmp_path):
    """``DenseSimulation.resume_latest`` of the newest valid step of an
    in-process supervised run, continued, equals the run itself; the
    async capture's host copies are frozen."""
    cfg = tc.minimal_config()
    with tc.use_config(cfg):
        sim = DenseSimulation(64, cfg=cfg, device="cpu", check_walk_every=4,
                              autocheckpoint={"every_n_slots": 4, "dir": str(tmp_path),
                                              "retain": 2})
        for _ in range(6):
            sim.run_slot()
        job = sim._checkpoint_async_capture()
        frozen = sim.checkpoint()
        sim.run_slot()                      # the loop moves on before the write
        late = job()
        assert state_digest(DenseSimulation.resume(late, device="cpu")) == \
            state_digest(DenseSimulation.resume(frozen, device="cpu"))
        while sim.slot < 12:
            sim.run_slot()
        sim.supervision.manager.drain()
        resumed = DenseSimulation.resume_latest(tmp_path, device="cpu")
        assert resumed.slot == 12 and resumed.resumed_from["step"] == 12
        assert state_digest(resumed) == state_digest(sim)
        assert sim.supervision.manager.steps() == [8, 12]   # retain=2
        assert sim.checkpoint() == sim.checkpoint()          # the same state, the same bytes


# --- the spec driver ---------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_spec")
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()):
        jsim = JaxSim(SPEC_N, autocheckpoint=(4, str(d)))
        jsim.run_until_slot(SPEC_SLOT)
        jsim.finish_autocheckpoint()
        jdig = jax_digest(jsim)
    with tc.use_config(tc.minimal_config()):
        sim = Simulation(SPEC_N, device="cpu")
        sim.run_until_slot(SPEC_SLOT)
        pdig = state_digest(sim)
    return {"jax_digest": jdig, "port_digest": pdig}


def test_spec_uninterrupted_equals_jax_supervised(spec_runs):
    assert spec_runs["port_digest"] == spec_runs["jax_digest"]


def test_spec_killed_and_resumed_equals_uninterrupted(spec_runs, tmp_path):
    emission, result, evs = _resilient_run(
        tmp_path, "--validators", str(SPEC_N), "--epochs", "1", "--every", "4",
        "--crash-at-slot", "6")
    assert result["state_digest"] == spec_runs["port_digest"]
    assert result["slot"] == SPEC_SLOT + 1 and emission["attempts"] == 2
    _interrupted_at(evs, 4)
    assert {"propose", "attest", "gossip", "deliver", "slot"} <= {e["type"] for e in evs}
    assert result["resume"]["verify"][0]["step"] == 4


def test_spec_resume_latest_refuses_another_config(tmp_path):
    with tc.use_config(tc.minimal_config()):
        sim = Simulation(16, device="cpu", autocheckpoint=(2, str(tmp_path)))
        sim.run_until_slot(2)
        sim.finish_autocheckpoint()
    with tc.use_config(tc.minimal_config().replace(name="other")):
        with pytest.raises(FileNotFoundError):
            Simulation.resume_latest(tmp_path, device="cpu")
    assert CheckpointManager(tmp_path).steps() == [2, 3]    # refused, not quarantined
    with tc.use_config(tc.minimal_config()):
        resumed = Simulation.resume_latest(tmp_path, device="cpu")
        assert resumed.slot == 3 and resumed.metrics == sim.metrics


# --- the checkpoint manager ----------------------------------------------------------

PAYLOADS = [b"", b"\x01", bytes(range(31)), bytes(range(32)), bytes(range(33)),
            bytes(range(256)) * 4, np.arange(1025, dtype=np.int32).tobytes()]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_merkle_hex_equals_jax(i):
    data = PAYLOADS[i]
    assert tmanager._merkle_hex(data, CPU) == jmanager._merkle_hex(data)


def _listing(root):
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, f) for f in sorted(filenames)]
    return out


def _both(tmp_path, **kw):
    fp = {"kind": "dense", "cfg": "0123456789abcdef"}
    return (jmanager.CheckpointManager(tmp_path / "jax", fingerprint=fp, **kw),
            CheckpointManager(tmp_path / "port", fingerprint=fp, backend=CPU, **kw))


@pytest.mark.parametrize("digest", ["sha256", "merkle"])
def test_manager_layout_and_manifest_equal_jax(tmp_path, digest):
    jm, tm = _both(tmp_path, digest=digest, retain=2)
    for step in (3, 5, 9):
        payloads = {"payload.bin": PAYLOADS[step % len(PAYLOADS)] * step,
                    "extra.bin": (lambda s=step: bytes([s]) * 40)}
        jm.save(step, dict(payloads))
        tm.save(step, dict(payloads))
    assert tm.steps() == jm.steps() == [5, 9]                  # retention
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    for step in (5, 9):
        name = f"step_{step:08d}"
        for f in ("manifest.json", "payload.bin", "extra.bin"):
            assert (tmp_path / "port" / name / f).read_bytes() == \
                (tmp_path / "jax" / name / f).read_bytes()
        assert tm.load(step) == jm.load(step)
    assert [w["digest"] for w in tm.step_log] == [digest] * 6
    assert tm.stats()["saves"] == jm.stats()["saves"] == 3
    assert tm.stats()["gc_removed"] == jm.stats()["gc_removed"] == 1


def test_manager_quarantine_equals_jax(tmp_path):
    jm, tm = _both(tmp_path, digest="merkle")
    for m in (jm, tm):
        m.save(1, b"a" * 100)
        m.save(2, b"b" * 100)
        path = os.path.join(m.dir, "step_00000002", "payload.bin")
        with open(path, "r+b") as f:           # a bit flip in the newest step
            f.seek(7)
            f.write(b"c")
    jstep, jpay = jm.latest_valid()
    tstep, tpay = tm.latest_valid()
    assert (tstep, tpay) == (jstep, jpay) == (1, {"payload.bin": b"a" * 100})
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    reason = "quarantine/step_00000002/QUARANTINE_REASON.txt"
    assert (tmp_path / "port" / reason).read_text() == (tmp_path / "jax" / reason).read_text()
    assert tm.stats()["quarantined"] == jm.stats()["quarantined"] == 1
    assert [v["step"] for v in tm.verify_log] == [2, 1]


def test_manager_restores_a_displaced_step_like_jax(tmp_path):
    """A writer killed after displacing a re-saved step to ``.old-`` and
    before the new copy's rename: the next manager restores it."""
    jm, tm = _both(tmp_path)
    for m in (jm, tm):
        m.save(4, b"durable")
        os.replace(os.path.join(m.dir, "step_00000004"),
                   os.path.join(m.dir, ".old-step_00000004-12345"))
        os.makedirs(os.path.join(m.dir, ".tmp-step_00000004-12345"))
    fp = jm.fingerprint
    jm2 = jmanager.CheckpointManager(tmp_path / "jax", fingerprint=fp)
    tm2 = CheckpointManager(tmp_path / "port", fingerprint=fp, backend=CPU)
    assert tm2.steps() == jm2.steps() == [4]
    assert tm2.load(4) == jm2.load(4) == {"payload.bin": b"durable"}
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")


def test_async_writer_carries_the_backend_object(tmp_path):
    """The writer thread hashes on the backend object the manager was given,
    and the async steps equal the sync ones."""
    sync = CheckpointManager(tmp_path / "sync", digest="merkle", backend=CPU)
    asyn = CheckpointManager(tmp_path / "async", digest="merkle", backend=CPU, async_mode=True)
    seen = []
    real = tmanager._merkle_hex

    def spy(data, backend):
        seen.append((backend, threading.current_thread().name))
        return real(data, backend)

    tmanager._DIGESTS["merkle"] = spy
    try:
        for step in (1, 2):
            sync.save(step, PAYLOADS[5] * step)
            asyn.save(step, lambda step=step: PAYLOADS[5] * step)
        asyn.close()
    finally:
        tmanager._DIGESTS["merkle"] = real
    assert all(b is CPU for b, _ in seen)
    assert ("ckpt-writer" in {t for _, t in seen}) and len(seen) == 4
    for step in (1, 2):
        name = f"step_{step:08d}/manifest.json"
        assert (tmp_path / "sync" / name).read_bytes() == (tmp_path / "async" / name).read_bytes()


def test_k2_failure_raises_and_quarantines_nothing(tmp_path, monkeypatch):
    m = CheckpointManager(tmp_path, digest="merkle", backend=CPU)
    m.save(1, b"x" * 100)

    def broken(left, right):
        raise RuntimeError("merkle_level launch failed: CUDA error 700")

    monkeypatch.setattr(merkle_device, "merkle_level", broken)
    with pytest.raises(RuntimeError, match="merkle_level"):
        m.save(2, b"y" * 100)
    with pytest.raises(RuntimeError, match="merkle_level"):
        m.latest_valid()
    assert m.steps() == [1] and not (tmp_path / "quarantine").exists()
    asyn = CheckpointManager(tmp_path / "a", digest="merkle", backend=CPU, async_mode=True)
    asyn.save(1, b"z" * 100)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        asyn.drain()


class _Cuda:
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("backend,digest,want", [
    (CPU, "auto", "sha256"), (_Cuda(), "auto", "merkle"),
    (CPU, "merkle", "merkle"), (_Cuda(), "sha256", "sha256")])
def test_supervision_digest_goes_by_device(tmp_path, backend, digest, want):
    sup = RunSupervision({"every_n_slots": 4, "dir": str(tmp_path), "digest": digest},
                         kind="dense", backend=backend)
    assert sup.manager.digest == want and sup.manager.backend is backend


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """``kernels.launch`` counts under a lock, and ``thread_launches``
    sees only its own thread's launches."""
    monkeypatch.setitem(kernels._entries, "merkle_level", lambda *a: 0)
    monkeypatch.setitem(kernels._entries, "agg_sig", lambda *a: 0)
    before = dict(kernels.launches)
    counted = {}

    def writer():
        with kernels.thread_launches() as c:
            for _ in range(2000):
                kernels.launch("merkle_level")
        counted.update(c)

    t = threading.Thread(target=writer)
    with kernels.thread_launches() as mine:
        t.start()
        for _ in range(2000):
            kernels.launch("merkle_level")
            kernels.launch("agg_sig")
        t.join()
    assert kernels.launches["merkle_level"] - before["merkle_level"] == 4000
    assert kernels.launches["agg_sig"] - before["agg_sig"] == 2000
    assert counted == {"merkle_level": 2000}
    assert mine == {"merkle_level": 2000, "agg_sig": 2000}
    kernels.launches.update(before)


# --- with jax blocked -----------------------------------------------------------------

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "pos_evolution_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {repo!r})
""")


def test_tooling_and_resilient_child_run_with_jax_blocked(tmp_path):
    """The telemetry, profiling and resilience modules import, and the
    ``resilient_run`` child runs a dense run to its end (checkpoints, the
    final step, result.json) with jax and pos_evolution_tpu impossible to
    import."""
    code = _BLOCKER.format(repo=REPO) + textwrap.dedent(f"""
        import importlib, json
        for name in ("telemetry", "telemetry.torchrt", "telemetry.device",
                     "telemetry.events", "telemetry.registry", "telemetry.tracing",
                     "telemetry.fleet", "profiling.ledger", "profiling.phases",
                     "resilience", "resilience.manager", "resilience.runner",
                     "resilience.guard", "resilience.supervisor", "utils.watchdog"):
            importlib.import_module("pos_evolution_tpu_torch." + name)
        from pos_evolution_tpu_torch import resilient_run
        rc = resilient_run.main(["--child", "--dense", "--validators", "64", "--epochs", "1",
                                 "--every", "4", "--device", "cpu",
                                 "--ckpt-dir", {str(tmp_path)!r}])
        assert rc == 0
        with open({str(tmp_path / "result.json")!r}) as f:
            result = json.load(f)
        assert result["slot"] == 8 and result["checkpoint"]["saves"] == 3
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ran", result["state_digest"][:16])
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT, cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ran" in proc.stdout


def test_resilient_run_refuses_unported_flags_and_cpu_default(tmp_path):
    from pos_evolution_tpu_torch import resilient_run
    for flag, item in (("--sharded", "item 3"), ("--degraded-sharded", "item 3"),
                       ("--history", "item 7b")):
        with pytest.raises(SystemExit, match=item):
            resilient_run.main(["--ckpt-dir", str(tmp_path), flag, "2x2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resilient_run.main(["--ckpt-dir", str(tmp_path)])


def test_integrity_guard_reads_tensor_columns():
    """The ported guard reads tensor columns back before its scan (the one
    change from the JAX package's), with the JAX package's findings; on a
    dense run it finds nothing, then the corruption."""
    from pos_evolution_tpu.resilience import scan_columns as jax_scan

    from pos_evolution_tpu_torch.resilience import IntegrityGuard, scan_columns
    cols = {"balance": torch.tensor([1, -2, 3]),
            "msg_block": torch.tensor([-1, 0, 5], dtype=torch.int32),
            "weights": torch.tensor([1.0, float("nan")])}
    found = scan_columns(cols, n_blocks=3)
    assert found == jax_scan({k: v.numpy() for k, v in cols.items()}, n_blocks=3)
    assert len(found) == 3
    cfg = tc.minimal_config()
    with tc.use_config(cfg):
        sim = DenseSimulation(64, cfg=cfg, device="cpu")
        for _ in range(3):
            sim.run_slot()
        guard = IntegrityGuard(1)
        assert guard.check(sim) == []
        sim.registry.balance[5] = -1
        assert guard.check(sim) == ["balance: 1 negative balance(s)"]
