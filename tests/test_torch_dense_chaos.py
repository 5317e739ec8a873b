"""The port's dense driver under faults, adversaries and partitions
against the JAX package's, bit for bit on the CPU: the chaos composition
of ``tests/test_dense_chaos.py`` (drops, delays, a crash window, an
equivocator, the default monitors), the two partitioned networks, a
checkpoint resumed across the two packages in both directions, and the
host modules copied from ``sim/faults.py``, ``sim/dense_adversary.py``
and ``sim/dense_monitors.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim import dense_adversary as jadv  # noqa: E402
from pos_evolution_tpu.sim import dense_monitors as jmon  # noqa: E402
from pos_evolution_tpu.sim import faults as jfaults  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxSim  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_adversary as tadv  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_monitors as tmon  # noqa: E402
from pos_evolution_tpu_torch.sim import faults as tfaults  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402

SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4)


def _run(pkg, n, seed, *, epochs=None, make_plan, make_adversaries, monitor_kw, **kw):
    """One run of package ``pkg`` ("jax" or "port") with its own classes."""
    faults, adv, mon = (jfaults, jadv, jmon) if pkg == "jax" else (tfaults, tadv, tmon)
    common = dict(seed=seed, shuffle_rounds=6, fault_plan=make_plan(faults),
                  adversaries=make_adversaries(adv),
                  monitors=mon.default_dense_monitors(**monitor_kw), **kw)
    if pkg == "jax":
        sim = JaxSim(n, cfg=jax_mainnet().replace(**SMALL), **common)
    else:
        sim = DenseSimulation(n, mainnet_config().replace(**SMALL), device="cpu", **common)
    if epochs:
        sim.run_epochs(epochs)
    return sim


def _violations(sim):
    return [(v["monitor"], v["kind"], v["slot"]) for v in sim.monitor_violations]


def _record(sim):
    s = sim.summary()
    s.pop("mesh", None)
    digest = jax_digest(sim) if isinstance(sim, JaxSim) else state_digest(sim)
    return {"metrics": sim.metrics, "violations": list(sim.monitor_violations),
            "implicated": [np.flatnonzero(m.implicated).tolist() for m in sim.monitors
                           if hasattr(m, "implicated")],
            "summary": s, "digest": digest}


# --- (b) the chaos composition ---------------------------------------------------

CHAOS_N, CHAOS_SEED = 384, 21


def _chaos(pkg, epochs=None):
    return _run(pkg, CHAOS_N, CHAOS_SEED, epochs=epochs,
                make_plan=lambda f: f.DenseFaultPlan(
                    seed=CHAOS_SEED, drop_p=0.1, delay_p=0.08, gst_slot=10,
                    crashes=(f.DenseCrashWindow(300, 340, 3, 9),)),
                make_adversaries=lambda a: [a.DenseEquivocator(controlled=range(24), seed=2)],
                monitor_kw=dict(parity_every=4), check_walk_every=0)


@pytest.fixture(scope="module")
def chaos():
    jax_sim, sim = _chaos("jax", 3), _chaos("port", 3)
    return {"jax": jax_sim, "port": sim, "jax_record": _record(jax_sim),
            "port_record": _record(sim)}


@pytest.mark.parametrize("key", ["metrics", "violations", "implicated", "summary", "digest"])
def test_chaos_run_equals_jax(chaos, key):
    assert chaos["port_record"][key] == chaos["jax_record"][key]


def test_chaos_run_exercises_the_composition(chaos):
    sim = chaos["port"]
    assert len(sim.roots) > len(sim.metrics) + 1      # equivocating siblings
    assert chaos["port_record"]["implicated"][0]       # double voters implicated
    assert chaos["port_record"]["summary"]["resident_head_equals_spec_walk"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resumes_across_packages(chaos, writer, reader):
    """A checkpoint taken after epoch 1 by one package resumes in the other
    and ends equal to the uninterrupted run."""
    half = _chaos(writer, 1)
    data = half.checkpoint()
    if reader == "jax":
        resumed = JaxSim.resume(data)
    else:
        resumed = DenseSimulation.resume(data, device="cpu")
    resumed.run_epochs(3)
    ref = chaos["jax"]
    assert resumed.metrics == ref.metrics
    assert _violations(resumed) == _violations(ref)
    assert np.array_equal(np.asarray(resumed.monitors[0].implicated),
                          np.asarray(ref.monitors[0].implicated))
    digest = jax_digest(resumed) if reader == "jax" else state_digest(resumed)
    assert digest == chaos["jax_record"]["digest"]


# --- (c) the partitioned networks ------------------------------------------------

PARTITIONS = {
    "balancer": dict(n=384, seed=17, epochs=4, monitor_kw=dict(bound_epochs=2, parity_every=4),
                     make_plan=lambda f: f.DenseFaultPlan(partition="delay"),
                     make_adversaries=lambda a: [a.DenseBalancer(controlled=range(120))]),
    "split_voter": dict(n=384, seed=7, epochs=5, monitor_kw=dict(parity_every=4),
                        make_plan=lambda f: f.DenseFaultPlan(partition="full"),
                        make_adversaries=lambda a: [a.DenseSplitVoter(controlled=range(128))]),
}


@pytest.fixture(scope="module", params=sorted(PARTITIONS))
def partitioned(request):
    kw = dict(PARTITIONS[request.param])
    n, seed = kw.pop("n"), kw.pop("seed")
    runs = [_run(pkg, n, seed, n_groups=2, verify_aggregates=False, check_walk_every=4, **kw)
            for pkg in ("jax", "port")]
    return request.param, [_record(s) for s in runs], runs


@pytest.mark.parametrize("key", ["metrics", "violations", "implicated", "summary", "digest"])
def test_partitioned_run_equals_jax(partitioned, key):
    _, (jax_rec, port_rec), _ = partitioned
    assert port_rec[key] == jax_rec[key]


def test_partitioned_run_shows_its_attack(partitioned):
    name, (_, rec), (_, sim) = partitioned
    if name == "balancer":
        assert all(v.cur_just[0] == 0 for v in sim.views)
        assert {v["kind"] for v in rec["violations"]} == {"liveness_violation"}
        assert sim.adversaries[0].infeasible_slots == []
    else:
        assert sim.views[0].finalized != sim.views[1].finalized
        fins = [v for v in rec["violations"] if v.get("checkpoint") == "finalized"]
        assert fins and fins[0]["kind"] == "accountable_fault"
        assert fins[0]["slashable_stake"] * 3 == fins[0]["total_stake"]


# --- the copied host modules on seeded grids ------------------------------------

@pytest.mark.parametrize("seed,key,n", [(0, (20, 3, 0), 1), (7, (20, 3, 1), 4096),
                                         (2**40, (21, 99, 0), 1000), (-5, (), 17)])
def test_stateless_draws_match_jax(seed, key, n):
    np.testing.assert_array_equal(tfaults.stateless_unit_array(seed, *key, n=n),
                                  jfaults.stateless_unit_array(seed, *key, n=n))
    assert tfaults.stateless_word(seed, *key) == jfaults.stateless_word(seed, *key)
    assert tfaults.stateless_unit(seed, *key) == jfaults.stateless_unit(seed, *key)


@pytest.mark.parametrize("drop_p,delay_p,gst", [(0.1, 0.08, 10), (0.0, 0.3, None),
                                                (0.5, 0.0, 4), (0.0, 0.0, None)])
def test_fault_plan_masks_match_jax(drop_p, delay_p, gst):
    crashes = [(10, 50, 2, 6), (40, 90, 5, 7)]
    plans = [f.DenseFaultPlan(seed=3, drop_p=drop_p, delay_p=delay_p, gst_slot=gst,
                              crashes=tuple(f.DenseCrashWindow(*c) for c in crashes))
             for f in (jfaults, tfaults)]
    for slot in range(12):
        for view in (0, 1):
            for a, b in zip(plans[0].delivery_masks(slot, view, 300),
                            plans[1].delivery_masks(slot, view, 300)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(plans[0].crashed_mask(slot, 64),
                                      plans[1].crashed_mask(slot, 64))
    assert plans[1].describe() == plans[0].describe()
    assert tfaults.DenseFaultPlan.from_config(plans[0].describe()) == plans[1]


def test_strategies_and_monitors_describe_as_jax():
    pairs = [
        (lambda m: m.DenseEquivocator(controlled=[1, 2, 3, 9], p_fork=0.3, seed=4)),
        (lambda m: m.DenseWithholder(controlled=range(10, 20), fork_slot=3, release_slot=6)),
        (lambda m: m.DenseExAnteReorg(controlled=range(5), fork_slot=2, span=3)),
        (lambda m: m.DenseSplitVoter(controlled=range(7))),
        (lambda m: m.DenseBalancer(controlled=[0, 5])),
    ]
    for make in pairs:
        want = make(jadv).describe()
        got = make(tadv)
        assert got.describe() == want
        assert tadv.dense_adversary_from_config(want).describe() == want
    jm = jmon.default_dense_monitors(bound_epochs=3, parity_every=2)
    tm = tmon.default_dense_monitors(bound_epochs=3, parity_every=2)
    assert [m.describe() for m in tm] == [m.describe() for m in jm]
    assert [tmon.dense_monitor_from_config(m.describe()).describe() for m in jm] == \
        [m.describe() for m in jm]
