"""The port's copies of the JAX package's jax-free spec layer, of the
spec driver's schedules, monitors, adversaries, attacks and protocol
variants, of its riders' DAS server, single-flight and light-client
modules, and of the tooling's watchdog, event bus, metrics registry,
tracing, fleet aggregator and supervisor: each copied
module's source equals its original with ``pos_evolution_tpu.`` replaced
by ``pos_evolution_tpu_torch.`` and nothing else, and the FakeBLS
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
]


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_original_with_the_prefix_replaced(path):
    original = _read("pos_evolution_tpu", path)
    copy = _read("pos_evolution_tpu_torch", path)
    assert copy == original.replace("pos_evolution_tpu.", "pos_evolution_tpu_torch.")


@pytest.mark.parametrize("path", COPIES)
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
