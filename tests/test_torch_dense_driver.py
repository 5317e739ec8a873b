"""The port's dense simulation driver against the JAX package's
(``sim/dense_driver.DenseSimulation``, single device), bit for bit on the
CPU: an honest run's per-slot metrics, summary and state digest, the
checkpoint byte format, and the options the port refuses."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.resilience import fingerprint_config as jax_fingerprint  # noqa: E402
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxSim  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
from pos_evolution_tpu_torch.resilience import fingerprint_config, state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_variants import dense_rider_from_config  # noqa: E402
from pos_evolution_tpu_torch.sim.faults import DenseFaultPlan  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SEED, EPOCHS = 256, 11, 4
SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4)
KW = dict(seed=SEED, shuffle_rounds=6, check_walk_every=8)


def _port(**kw):
    return DenseSimulation(N, mainnet_config().replace(**SMALL), device="cpu", **{**KW, **kw})


def _summary(sim):
    s = sim.summary()
    s.pop("mesh", None)
    return s


@pytest.fixture(scope="module")
def honest():
    """One honest run in each package, run once for the module."""
    jax_sim = JaxSim(N, cfg=jax_mainnet().replace(**SMALL), **KW)
    jax_sim.run_epochs(EPOCHS)
    before = dict(kernels.launches)
    sim = _port()
    sim.run_epochs(EPOCHS)
    assert kernels.launches == before      # the CPU takes the plain versions
    return {"jax": jax_sim, "port": sim,
            "jax_summary": _summary(jax_sim), "port_summary": _summary(sim),
            "jax_digest": jax_digest(jax_sim), "port_digest": state_digest(sim)}


def test_honest_metrics_equal_jax(honest):
    assert len(honest["port"].metrics) == EPOCHS * SMALL["slots_per_epoch"]
    assert honest["port"].metrics == honest["jax"].metrics


def test_honest_summary_equal_jax(honest):
    s = honest["port_summary"]
    assert s == honest["jax_summary"]
    assert s["finality_reached"] and s["finalized_epoch"] == EPOCHS - 2
    assert s["resident_head_equals_spec_walk"] and s["walk_checks"] == 5
    assert s["aggregates_verified"] == EPOCHS * SMALL["slots_per_epoch"] * 4


def test_honest_state_digest_equal_jax(honest):
    assert honest["port_digest"] == honest["jax_digest"]


@pytest.mark.parametrize("field", ["registry", "msg_block", "msg_epoch", "msg_slot"])
def test_honest_columns_equal_jax(honest, field):
    a, b = getattr(honest["jax"], field), getattr(honest["port"], field)
    pairs = zip(a, b) if field == "registry" else [(a, b)]
    for x, y in pairs:
        x = np.asarray(x)
        assert y.numpy().dtype == x.dtype
        np.testing.assert_array_equal(y.numpy(), x)


def _split(data: bytes):
    buf = io.BytesIO(data)
    (n_head,) = np.frombuffer(buf.read(8), dtype=np.uint64)
    meta = json.loads(buf.read(int(n_head)).decode())
    with np.load(buf) as z:
        return meta, {k: z[k] for k in z.files}


def test_checkpoint_bytes_match_jax_format(honest):
    """The same meta and the same columns, names and dtypes included."""
    jm, ja = _split(honest["jax"].checkpoint())
    pm, pa = _split(honest["port"].checkpoint())
    assert pm == jm
    assert sorted(pa) == sorted(ja)
    for k in ja:
        assert pa[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)


def test_checkpoint_is_a_copy():
    """A capture on the CPU does not alias the columns the loop mutates."""
    sim = _port()
    sim.run_epochs(1)
    data = sim.checkpoint()
    sim.run_epochs(2)
    resumed = DenseSimulation.resume(data, device="cpu")
    assert resumed.slot == SMALL["slots_per_epoch"]
    resumed.run_epochs(2)
    assert resumed.metrics == sim.metrics
    assert state_digest(resumed) == state_digest(sim)


def test_all_pass_plan_is_bit_identical_to_no_plan(honest):
    masked = _port(fault_plan=DenseFaultPlan(seed=9))
    masked.run_epochs(EPOCHS)
    assert masked.metrics == honest["port"].metrics
    assert state_digest(masked) == honest["port_digest"]


def test_plain_flag_gives_the_same_run(honest):
    sim = _port(plain=True)
    sim.run_epochs(2)
    assert sim.metrics == honest["port"].metrics[: len(sim.metrics)]


def test_phase_budget_accounts_for_the_slot():
    sim = _port(phase_profile=2, check_walk_every=4)
    sim.run_epochs(1)
    ph = sim.summary()["dense_phases"]
    assert ph["slots"] == SMALL["slots_per_epoch"] and ph["sampled_slots"] == 4
    assert {"vote_pass", "head_descent", "vote_apply", "aggregate_verify", "shuffle",
            "host_audit", "record"} <= set(ph["phases"])
    assert 90.0 <= ph["accounted_pct"] <= 100.0


def test_fingerprint_config_matches_jax():
    for kw in ({}, SMALL, {"name": "x", "terminal_block_hash": b"\x01" * 32}):
        assert fingerprint_config(mainnet_config().replace(**kw)) == \
            jax_fingerprint(jax_mainnet().replace(**kw))


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "item 3"),
])
def test_unported_options_raise(kw, item):
    with pytest.raises(ValueError, match=item):
        _port(**kw)


@pytest.mark.parametrize("kw", [
    {"telemetry": "telemetry"},
    {"flight_recorder": "flight_recorder"},
    {"autocheckpoint": "autocheckpoint"},
])
def test_tooling_options_build(kw, tmp_path):
    """Telemetry, the flight recorder and autocheckpoint (item 7a) build
    and run a slot."""
    from pos_evolution_tpu_torch.telemetry import FlightRecorder, Telemetry
    tel = Telemetry()
    value = {"telemetry": tel, "flight_recorder": FlightRecorder(tel),
             "autocheckpoint": (1, str(tmp_path))}[next(iter(kw))]
    sim = _port(**{next(iter(kw)): value})
    sim.run_slot()
    assert sim.slot == 1


def test_unported_supervision_and_riders_raise(tmp_path):
    """Resuming from a store with no valid step raises; the KZG DAS rider
    (item 5b) builds, on the run's device and config."""
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        DenseSimulation.resume_latest(tmp_path / "empty", device="cpu")
    sim = _port(riders=[dense_rider_from_config({"kind": "das", "scheme": "kzg"})])
    scheme = sim.riders[0].engine.scheme
    assert scheme.name == "kzg" and scheme.device.type == "cpu" and scheme.cfg is sim.cfg
    assert sim.riders[0].describe()["scheme"] == "kzg"
    assert dense_rider_from_config(None) is None


def test_resume_refuses_another_variant(honest):
    data = honest["port"].checkpoint()
    with pytest.raises(ValueError, match="variant"):
        DenseSimulation.resume(data, device="cpu", expect_variant="ssf")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseSimulation(N, mainnet_config().replace(**SMALL))


def test_entry_point_prints_one_json_summary():
    proc = subprocess.run(
        [sys.executable, "-m", "pos_evolution_tpu_torch.sim.dense_driver", "--n", "256",
         "--epochs", "1", "--shuffle-rounds", "4", "--phase-profile", "4",
         "--device", "cpu"], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["slots"] == 32 and out["device"] == "cpu"
    assert len(out["state_digest"]) == 64 and out["dense_phases"]["sampled_slots"] == 8
