"""The port's epoch sweep and config against the JAX package: every
``EpochResult`` field bit for bit, across genesis, finalization cases,
inactivity leak and slashings; ``mainnet_config`` field by field."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu import config as jcfg  # noqa: E402
from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu_torch import config as tcfg  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.ops import epoch as tep  # noqa: E402

GWEI = 10**9
FAR = 2**62


def _registry(seed, n=3000, current=10, vector_half=4096):
    rng = np.random.default_rng(seed)
    act = rng.integers(0, current + 2, n).astype(np.int64)
    act[rng.random(n) < 0.05] = FAR
    exit_ = np.where(rng.random(n) < 0.1, rng.integers(0, current + 3, n), FAR).astype(np.int64)
    slashed = rng.random(n) < 0.05
    withdrawable = np.where(slashed & (rng.random(n) < 0.5), current + vector_half,
                            np.where(rng.random(n) < 0.1, rng.integers(0, current + 3, n),
                                     FAR)).astype(np.int64)
    return jep.DenseRegistry(
        effective_balance=rng.integers(15, 33, n).astype(np.int64) * GWEI,
        balance=rng.integers(0, 34 * GWEI, n).astype(np.int64),
        activation_epoch=act,
        exit_epoch=exit_,
        withdrawable_epoch=withdrawable,
        slashed=slashed,
        prev_flags=np.where(rng.random(n) < 0.8, 7, rng.integers(0, 8, n)).astype(np.uint8),
        cur_flags=np.where(rng.random(n) < 0.8, 7, rng.integers(0, 8, n)).astype(np.uint8),
        inactivity_scores=rng.integers(0, 60, n).astype(np.int64),
    )


# (current, finalized, bits, prev_justified, cur_justified, slashings_sum)
CASES = [
    (0, 0, [False] * 4, 0, 0, 0),
    (1, 0, [True, False, False, False], 0, 0, 0),
    (2, 0, [False] * 4, 0, 1, 0),
    (10, 8, [False] * 4, 8, 9, 0),
    (10, 7, [True, True, False, False], 7, 8, 5 * GWEI),
    (10, 7, [True, True, True, False], 7, 7, 0),
    (10, 7, [False, True, True, False], 7, 9, 0),
    (20, 5, [True, False, True, True], 17, 18, 300 * GWEI),
]


def _compare(reg_np, args, cfg_name="mainnet"):
    jc = getattr(jcfg, f"{cfg_name}_config")()
    tc = getattr(tcfg, f"{cfg_name}_config")()
    cur, fin, bits, pj, cj, sl = args
    want = jep.process_epoch_dense(jep.DenseRegistry(*(jnp.asarray(x) for x in reg_np)),
                                   cur, fin, jnp.asarray(np.array(bits)), pj, cj, sl, jc)
    got = tep.process_epoch_dense(convert.registry_to_torch(reg_np, "cpu"), cur, fin,
                                  np.array(bits), pj, cj, sl, tc)
    got_np = convert.to_numpy(got)
    for f in tep.DenseRegistry._fields:
        w, g = np.asarray(getattr(want.registry, f)), getattr(got_np.registry, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in tep.EpochResult._fields[1:]:
        np.testing.assert_array_equal(getattr(got_np, f), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("args", CASES)
def test_epoch_matches_jax(args):
    _compare(_registry(args[0] + 100, current=args[0]), args)


@pytest.mark.parametrize("seed", [1, 2])
def test_epoch_matches_jax_minimal_config(seed):
    args = (10, 7, [True, True, False, False], 7, 8, 40 * GWEI)
    _compare(_registry(seed, current=10, vector_half=32), args, "minimal")


def test_low_participation_registry_matches_jax():
    reg = _registry(5)
    reg = reg._replace(prev_flags=np.zeros_like(reg.prev_flags),
                       cur_flags=np.zeros_like(reg.cur_flags))
    _compare(reg, (10, 8, [True, False, False, False], 8, 9, 0))


def test_isqrt_matches_jax_and_python():
    import math
    vals = [0, 1, 2, 3, 4, 15, 16, 17, 2**52 - 1, 2**52 + 1, (2**31 - 1) ** 2,
            (2**31 - 1) ** 2 - 1, (3037000499) ** 2, 2**62, 2**63 - 1]
    x = np.array(vals, np.int64)
    got = tep.isqrt_i64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jep.isqrt_i64(jnp.asarray(x))))
    # exact where the fixup's (s + 1)^2 fits int64; Gwei totals stay far below
    exact = [i for i, v in enumerate(vals) if v <= 2**62]
    assert [got[i] for i in exact] == [math.isqrt(vals[i]) for i in exact]


@pytest.mark.parametrize("name", ["mainnet", "minimal"])
def test_config_matches_jax(name):
    j = getattr(jcfg, f"{name}_config")()
    t = getattr(tcfg, f"{name}_config")()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert tf == jf


def test_flag_constants_match_jax():
    for name in ("TIMELY_SOURCE_FLAG_INDEX", "TIMELY_TARGET_FLAG_INDEX",
                 "TIMELY_HEAD_FLAG_INDEX", "PARTICIPATION_FLAG_WEIGHTS",
                 "WEIGHT_DENOMINATOR", "PROPOSER_WEIGHT", "SYNC_REWARD_WEIGHT",
                 "FAR_FUTURE_EPOCH", "ETH_TO_GWEI"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tep.FAR_FUTURE_I64 == int(jep.FAR_FUTURE_I64)
