"""The port's dense protocol variants against the JAX package's, bit for
bit on the CPU: short Goldfish, RLMD-GHOST and SSF runs and the ex-ante
reorg under Gasper with and without proposer boost, then the host
oracles the variants and the driver read (the tallies, ``head_host``,
``rebuild_buckets``, ``masked_stake_host``, ``expiry_kernel``) on seeded
grids."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.config import mainnet_config as jax_mainnet  # noqa: E402
from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu.ops import forkchoice as jfc  # noqa: E402
from pos_evolution_tpu.ops import variant_tally as jvt  # noqa: E402
from pos_evolution_tpu.resilience import state_digest as jax_digest  # noqa: E402
from pos_evolution_tpu.sim import dense_adversary as jadv  # noqa: E402
from pos_evolution_tpu.sim import dense_variants as jvar  # noqa: E402
from pos_evolution_tpu.sim.dense_driver import DenseSimulation as JaxSim  # noqa: E402
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.ops import epoch as tep  # noqa: E402
from pos_evolution_tpu_torch.ops import forkchoice as tfc  # noqa: E402
from pos_evolution_tpu_torch.ops import variant_tally as tvt  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_adversary as tadv  # noqa: E402
from pos_evolution_tpu_torch.sim import dense_variants as tvar  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402

N = 256
SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4)
# (variant describe(), adversary or None): the three per-slot variants
# honest, and the ex-ante reorg against Gasper without and with boost
RUNS = {
    "goldfish": ({"kind": "goldfish"}, False),
    "rlmd": ({"kind": "rlmd"}, False),
    "ssf": ({"kind": "ssf"}, False),
    "gasper_exante": ({"kind": "gasper", "boost_percent": 0}, True),
    "gasper_boost_exante": ({"kind": "gasper", "boost_percent": 40}, True),
}


def _sim(pkg, variant, exante):
    adv_mod = jadv if pkg == "jax" else tadv
    adversaries = ([adv_mod.DenseExAnteReorg(controlled=np.arange(int(N * 0.4)), fork_slot=2,
                                             span=2)] if exante else [])
    kw = dict(seed=11, shuffle_rounds=6, verify_aggregates=False, check_walk_every=4,
              variant=variant, adversaries=adversaries)
    if pkg == "jax":
        return JaxSim(N, cfg=jax_mainnet().replace(**SMALL), **kw)
    return DenseSimulation(N, mainnet_config().replace(**SMALL), device="cpu", **kw)


@pytest.fixture(scope="module", params=sorted(RUNS))
def variant_run(request):
    variant, exante = RUNS[request.param]
    out = []
    for pkg in ("jax", "port"):
        sim = _sim(pkg, variant, exante)
        sim.run_epochs(2)
        s = sim.summary()
        s.pop("mesh", None)
        out.append({"sim": sim, "metrics": sim.metrics, "summary": s,
                    "decisions": sim.variant.decisions,
                    "variant_state": sim.variant.state_meta(),
                    "digest": jax_digest(sim) if pkg == "jax" else state_digest(sim)})
    return request.param, out


@pytest.mark.parametrize("key", ["metrics", "summary", "decisions", "variant_state", "digest"])
def test_variant_run_equals_jax(variant_run, key):
    _, (jax_rec, port_rec) = variant_run
    assert port_rec[key] == jax_rec[key]


def test_variant_run_decides(variant_run):
    name, (_, rec) = variant_run
    s = rec["summary"]
    assert s["resident_head_equals_spec_walk"]
    if name in ("goldfish", "rlmd", "ssf"):
        assert s["variant"] == name and s["variant_decisions"] > 0
    else:
        assert rec["sim"].adversaries[0].released


def test_slot_tallies_match_jax(variant_run):
    name, (jax_rec, port_rec) = variant_run
    jsim, tsim = jax_rec["sim"], port_rec["sim"]
    for slot in (tsim.slot - 1, tsim.slot):
        np.testing.assert_array_equal(tvar.slot_vote_tally(tsim, 0, slot),
                                      jvar.slot_vote_tally(jsim, 0, slot))
        np.testing.assert_array_equal(tvar.slot_ack_tally(tsim, 0, slot),
                                      jvar.slot_ack_tally(jsim, 0, slot))
        assert tvar.variant_tally_parity(tsim, 0, slot)


def test_variant_describe_round_trips_as_jax():
    for kind in ("gasper", "goldfish", "rlmd", "ssf"):
        for boost in (0, 40):
            want = jvar.dense_variant_from_config({"kind": kind, "boost_percent": boost})
            got = tvar.dense_variant_from_config(want.describe())
            assert got.describe() == want.describe()
            assert tvar.dense_variant_from_config(kind).describe() == \
                jvar.dense_variant_from_config(kind).describe()


# --- the host oracles on seeded grids --------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_tally_oracles_match_jax(seed):
    rng = np.random.default_rng(seed)
    k, nb = 500, 40
    block = rng.integers(-1, nb + 3, k)
    vslot = rng.integers(0, 30, k)
    weight = rng.integers(1, 33, k) * 10**9
    active = rng.random(k) < 0.8
    lo, hi = sorted(rng.integers(0, 30, 2))
    np.testing.assert_array_equal(
        tvt.windowed_vote_tally_host(block, vslot, weight, active, lo, hi, nb),
        jvt.windowed_vote_tally_host(block, vslot, weight, active, lo, hi, nb))
    np.testing.assert_array_equal(tvt.link_tally_host(block, weight, active, nb),
                                  jvt.link_tally_host(block, weight, active, nb))
    for x in (0, 1, 2, 3, 255, 256, 257, 2**20 + 1):
        assert tvt.next_pow2(x) == jvt.next_pow2(x) == tfc.next_pow2(x) == jfc.next_pow2(x)


def _tree(rng, cap):
    parent = np.array([-1] + [rng.integers(max(0, i - 4), i) for i in range(1, cap)], np.int32)
    real = np.ones(cap, bool)
    real[cap - cap // 8:] = False
    return parent, real, rng.permutation(cap).astype(np.int32), rng.random(cap) < 0.8


@pytest.mark.parametrize("seed", range(6))
def test_head_host_and_buckets_match_jax(seed):
    rng = np.random.default_rng(seed)
    cap, n = 64, 3000
    parent, real, rank, viable = _tree(rng, cap)
    msg = rng.integers(-1, cap, n).astype(np.int32)
    eff = rng.integers(16, 33, n).astype(np.int64) * 10**9
    buckets = tfc.rebuild_buckets(torch.from_numpy(msg), torch.from_numpy(eff), cap)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(
        jfc.rebuild_buckets(jnp.asarray(msg), jnp.asarray(eff), cap)))
    vw = buckets.numpy()
    start = int(rng.integers(0, 4))
    bidx = int(rng.integers(-1, cap)) if seed % 2 else -1
    bamt = 40 * 32 * 10**9
    got = tfc.head_host(parent, real, rank, viable, start, vw, bidx, bamt)
    assert got == jfc.head_host(parent, real, rank, viable, start, vw, bidx, bamt)
    dev, _ = tfc.head_from_buckets(torch.from_numpy(parent), torch.from_numpy(real),
                                   torch.from_numpy(rank), torch.from_numpy(viable), start,
                                   buckets, bidx, bamt, cap)
    assert int(dev) == got


@pytest.mark.parametrize("seed", range(3))
def test_masked_stake_and_expiry_match_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(5000) < 0.3
    eff = rng.integers(16, 33, 5000).astype(np.int64) * 10**9
    assert tep.masked_stake_host(mask, eff) == jep.masked_stake_host(mask, eff)
    mb = rng.integers(-1, 50, 4096).astype(np.int32)
    ms = rng.integers(0, 20, 4096).astype(np.int64)
    got = tvar.expiry_kernel(torch.from_numpy(mb), torch.from_numpy(ms), 5, 9)
    want = jvar.expiry_kernel()(jnp.asarray(mb), jnp.asarray(ms), jnp.int64(5), jnp.int64(9))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
