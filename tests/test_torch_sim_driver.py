"""The port's spec driver (``sim/driver.Simulation``) against the JAX
package's on the CPU, tolerance 0: the port on its CPU torch backend, the
JAX package on its numpy backend and on its jax backend, the same runs
giving identical per-slot records (head root, justified and finalized
epochs, participation, blocks) — honest with and without the resident
fork choice; faulted with a crash window and its checkpoint-sync rejoin
and an equivocator under the default monitors, in one run; Goldfish,
RLMD-GHOST and SSF; the three attacks of the JAX package's tour; and
that run's checkpoint carried across in both directions and resumed
with fresh monitors. Both packages' configs are set for each test; each
run is made once per module and held against the others."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu import sim as jsim  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.sim import attacks as jattacks  # noqa: E402
from pos_evolution_tpu.variants import (  # noqa: E402
    GoldfishVariant as JGoldfish,
    RlmdGhostVariant as JRlmd,
    SsfVariant as JSsf,
)
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch import sim as tsim  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.sim import attacks as tattacks  # noqa: E402
from pos_evolution_tpu_torch.variants import (  # noqa: E402
    GoldfishVariant as TGoldfish,
    RlmdGhostVariant as TRlmd,
    SsfVariant as TSsf,
)

JAX_BACKENDS = ("numpy", "jax")
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _minimal_cpu():
    """Both packages on the minimal config, the port on its CPU backend
    with one intra-op thread; the JAX package's backend is set per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu"):
        yield
    torch.set_num_threads(n)
    jax_set_backend("numpy")


def _spe() -> int:
    return jc.minimal_config().slots_per_epoch


def _once(key, make):
    """The run for ``key``, made once per module."""
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _summary(sim) -> dict:
    """Per-slot records and each group's final view."""
    groups = []
    for g in sim.groups:
        s = g.store
        groups.append((g.crashed, int(s.justified_checkpoint.epoch),
                       bytes(s.justified_checkpoint.root), int(s.finalized_checkpoint.epoch),
                       len(s.blocks), sorted(s.equivocating_indices),
                       None if g.resident is None else g.resident.degraded))
    return {"metrics": sim.metrics, "groups": groups, "slot": sim.slot,
            "violations": sim.monitor_violations}


def _record(sim, monitors) -> dict:
    """``_summary`` and the accountable-safety monitor's evidence (SSZ
    bytes) and implicated validators."""
    acc = next(m for m in monitors if type(m).__name__ == "AccountableSafetyMonitor")
    return {**_summary(sim), "evidence": [bytes(type(e).serialize(e)) for e in acc.evidence],
            "implicated": sorted(acc.implicated)}


def _controlled(pkg) -> set:
    """The equivocator's validators: slot 2's proposer (so it also signs
    two blocks) and 4 more, about 1/16 of 64."""
    from importlib import import_module
    base = pkg.__name__.rsplit(".", 1)[0]
    gen, h, v = (import_module(f"{base}.specs.{m}") for m in ("genesis", "helpers", "validator"))
    state, _ = gen.make_genesis(64)
    return {int(h.get_beacon_proposer_index(v.advance_state_to_slot(state, 2)))} | set(range(4))


def _chaos(pkg) -> dict:
    """A faulted and adversarial run's schedule, adversaries and monitors,
    fresh: drops, duplicates and reorders, view group 1 down for epoch 1
    and back by checkpoint sync, an equivocator, the default monitors
    (as ``chip_smoke.py``'s phase 36 runs it at 1,024)."""
    spe = _spe()
    plan = pkg.FaultPlan(seed=3, drop_p=0.1, duplicate_p=0.15, reorder_p=0.1,
                         crashes=(pkg.CrashWindow(1, spe, 2 * spe),))
    return {"schedule": pkg.faulty_schedule(64, plan, n_groups=2),
            "adversaries": [pkg.Equivocator(_controlled(pkg))],
            "monitors": pkg.default_monitors()}


def _chaos_run(pkg, **kw) -> dict:
    """The chaos run to the end of epoch 3, checkpointed at slot
    ``spe + 2`` (group 1 down): the checkpoint, whether group 1 was down
    then, and the final record."""
    spe = _spe()
    c = _chaos(pkg)
    sim = pkg.Simulation(64, accelerated_forkchoice=True, **c, **kw)
    sim.run_until_slot(spe + 2)
    data, down = sim.checkpoint(), sim.groups[1].crashed
    sim.run_until_slot(3 * spe)
    return {"checkpoint": data, "down": down, "record": _record(sim, c["monitors"])}


def _resumed(pkg, data, **kw) -> dict:
    """``data`` resumed with fresh adversaries and monitors (monitors are
    not simulation state) and run to the end of epoch 3; its record, made
    once per package and checkpoint."""
    return _once(("resumed", pkg.__name__, data), lambda: _resume(pkg, data, **kw))


def _resume(pkg, data, **kw) -> dict:
    if pkg is jsim:
        jax_set_backend("numpy")
    c = _chaos(pkg)
    resume = convert.simulation_to_port if pkg is tsim else jsim.Simulation.resume
    sim = resume(data, **c, **kw)
    assert sim.groups[1].crashed and sim.checkpoint() == data, "the same bytes written back"
    sim.run_until_slot(3 * _spe())
    return _record(sim, c["monitors"])


def _jax(key, backend, make):
    """The JAX package's run for ``key`` on ``backend``, made once per module."""
    def run():
        jax_set_backend(backend)
        return make()
    return _once(("jax", backend, key), run)


def _summary_of(record) -> dict:
    return {k: record[k] for k in ("metrics", "groups", "slot")}


# --- honest runs ----------------------------------------------------------------


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("accelerated", [False, True], ids=["spec_walk", "resident"])
def test_honest_run_equals_jax(backend, accelerated):
    def port():
        sim = tsim.Simulation(64, accelerated_forkchoice=accelerated, device="cpu")
        sim.run_epochs(5)
        return _summary(sim)

    want = _once(("honest", accelerated), port)
    jax_set_backend(backend)
    ref = jsim.Simulation(64, accelerated_forkchoice=accelerated)
    ref.run_epochs(5)
    assert _summary(ref) == want
    assert want["metrics"][-1]["finalized_epoch"] >= 3
    assert len(want["metrics"]) == 5 * _spe() + 1


# --- faults, a crash window and its rejoin, an equivocator under the monitors ----


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_faulted_run_with_crash_rejoin_equals_jax(backend):
    want = _once("chaos", lambda: _chaos_run(tsim, device="cpu"))
    got = _jax("chaos", backend, lambda: _chaos_run(jsim))
    assert want["down"] and not want["record"]["groups"][1][0], "group 1 crashes and rejoins"
    assert got["checkpoint"] == want["checkpoint"]
    assert _summary_of(got["record"]) == _summary_of(want["record"])
    assert len(want["record"]["metrics"]) == 3 * _spe() + 1
    assert not any(g[-1] for g in want["record"]["groups"]), "no resident store degraded"


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_equivocator_with_monitors_equals_jax(backend):
    want = _once("chaos", lambda: _chaos_run(tsim, device="cpu"))["record"]
    got = _jax("chaos", backend, lambda: _chaos_run(jsim))["record"]
    assert want["evidence"] and want["implicated"], "the double votes produce evidence"
    assert all(g[5] for g in want["groups"]), "the slashings reach every view"
    assert (got["evidence"], got["implicated"], got["violations"]) == \
        (want["evidence"], want["implicated"], want["violations"])
    assert got == want


# --- the successor variants -------------------------------------------------------


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("variant", ["goldfish", "rlmd", "ssf"])
def test_variant_run_equals_jax(backend, variant):
    t_cls, j_cls = {"goldfish": (TGoldfish, JGoldfish), "rlmd": (TRlmd, JRlmd),
                    "ssf": (TSsf, JSsf)}[variant]

    def port():
        v = t_cls()
        sim = tsim.Simulation(64, variant=v, device="cpu")
        sim.run_epochs(2)
        return _summary(sim), v.state_blob(sim)

    want = _once(("variant", variant), port)
    jax_set_backend(backend)
    v = j_cls()
    ref = jsim.Simulation(64, variant=v)
    ref.run_epochs(2)
    assert (_summary(ref), v.state_blob(ref)) == want


# --- the attacks of the tour --------------------------------------------------------


def _plain(result):
    return dataclasses.asdict(result) if dataclasses.is_dataclass(result) else result


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("attack", ["ex_ante_reorg", "bouncing_step", "balancing"])
def test_attack_equals_jax(backend, attack):
    def run(mod, use_cfg, cfg):
        if attack == "ex_ante_reorg":
            return _plain(mod.run_ex_ante_reorg())
        if attack == "bouncing_step":
            return _plain(mod.run_bouncing_attack_step())
        # pre-boost Gasper, as the tour runs it (the attack asserts it)
        with use_cfg(cfg().replace(proposer_score_boost_percent=0)):
            return _plain(mod.run_balancing_attack(64, n_epochs=3, corrupted_fraction=0.3))

    want = _once(("attack", attack), lambda: run(tattacks, tc.use_config, tc.cfg))
    jax_set_backend(backend)
    assert run(jattacks, jc.use_config, jc.cfg) == want
    if attack == "balancing":
        assert want["head_L"] != want["head_R"]


# --- checkpoints across the packages ---------------------------------------------


def test_jax_checkpoint_resumes_in_the_port():
    """The JAX package's chaos checkpoint (group 1 down) resumed in the
    port with fresh adversaries and monitors equals the same resumed in
    the JAX package in everything, the views' equivocator sets, the
    violations and the evidence included."""
    data = _jax("chaos", "numpy", lambda: _chaos_run(jsim))["checkpoint"]
    want = _resumed(jsim, data)
    assert _resumed(tsim, data, device="cpu") == want
    assert want["evidence"] and all(g[5] for g in want["groups"])


def test_port_checkpoint_resumes_in_jax():
    """The port's chaos checkpoint resumed in the JAX package continues as
    in the port; both resumed runs equal the uninterrupted one in every
    per-slot record and view checkpoint (a fresh monitor holds no vote of
    before the checkpoint, so it may pair fewer equivocations into
    slashings: only the views' equivocator sets, the violations and the
    evidence may differ), in both packages alike."""
    chaos = _once("chaos", lambda: _chaos_run(tsim, device="cpu"))
    got = _resumed(jsim, chaos["checkpoint"])
    port = _resumed(tsim, chaos["checkpoint"], device="cpu")
    assert got == port
    full = chaos["record"]
    assert 0 < len(port["evidence"]) < len(full["evidence"]), \
        "a fresh monitor holds no vote of before the checkpoint"
    assert port["metrics"] == full["metrics"]
    assert [g[:5] + g[6:] for g in port["groups"]] == [g[:5] + g[6:] for g in full["groups"]]


# --- the port's own contract -------------------------------------------------------


def test_knobs_not_ported_raise_naming_their_item(tmp_path):
    for kw, item in (({"profile": "p"}, "item 7b"), ({"compile_cache": "c"}, "item 7b"),
                     ({"serve": True}, "item 4d")):
        with pytest.raises(ValueError, match=item):
            tsim.Simulation(16, device="cpu", **kw)
    # supervision (item 7a) is ported: an empty store has nothing to resume
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        tsim.Simulation.resume_latest(tmp_path / "empty", device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        tsim.Simulation(16, device="cpu", sharded=True)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from pos_evolution_tpu_torch.backend import set_backend
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.Simulation(16, device="cuda")
    set_backend("torch", device="cpu")   # the thread's backend: Simulation(device=None)
    sim = tsim.Simulation(16)
    assert sim.backend.device.type == "cpu"
    from pos_evolution_tpu_torch.sim import driver
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["16", "--epochs", "1"])


def test_entry_point_on_the_cpu():
    from pos_evolution_tpu_torch.sim.driver import run_scale

    def audit_every_query(e, sim):      # from epoch 2 on
        for g in sim.groups:
            g.resident.selfcheck_every = 1

    out = run_scale(64, epochs=3, device="cpu", on_epoch=audit_every_query)
    sim = out.pop("sim")
    assert out["resident_head_equals_spec_walk"] and out["resident_head_equals_host_walk"]
    assert out["degraded"] == [False] and out["incidents"] == [[]]
    assert out["justified_epoch"] >= 2 and len(out["per_epoch_s"]) == 3
    assert out["k2_launches"] == 0 and out["state_roots"] > 0     # no K2 on the CPU
    st = out["resident_stats"][0]
    assert st["device_heads"] + st["memo_hits"] == out["head_queries"] > 0
    assert st["flushes"] > 0 and np.isfinite(out["init_s"])
    assert sim.groups[0].resident.selfcheck_every == 1


def test_entry_point_refuses_a_degraded_run(monkeypatch, capsys):
    """A run whose resident store degraded answered from the host spec
    walk: the entry point exits non-zero and prints no timings."""
    from pos_evolution_tpu_torch.ops import resident
    from pos_evolution_tpu_torch.sim import driver

    def fail(self, store):
        raise RuntimeError("no device")

    monkeypatch.setattr(resident.ResidentForkChoice, "_device_head", fail)
    monkeypatch.setattr(tc, "mainnet_config", tc.minimal_config)    # 8 slots an epoch
    with pytest.raises(SystemExit, match="degraded.*no device"):
        driver.main(["16", "--epochs", "1", "--device", "cpu"])
    assert capsys.readouterr().out == ""
