"""The port's dense fork choice against the JAX package (bit for bit):
boost, no boost, non-viable leaves, unreal slots, a non-root justified
start, and the min_vote_epoch expiry window."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import forkchoice as jfc  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.ops import forkchoice as tfc  # noqa: E402

CAP, N = 32, 2000


def _store(seed, *, boost=True, viable=0.7, unreal=0, justified=0, equal_votes=False):
    rng = np.random.default_rng(seed)
    parent = np.array([-1] + [rng.integers(max(0, i - 4), i) for i in range(1, CAP)],
                      np.int32)
    real = np.ones(CAP, bool)
    if unreal:
        real[CAP - unreal:] = False
    weight = np.full(N, 32 * 10**9, np.int64) if equal_votes else \
        rng.integers(16, 33, N).astype(np.int64) * 10**9
    return jfc.DenseStore(
        parent=parent,
        slot=np.arange(CAP, dtype=np.int32),
        rank=rng.permutation(CAP).astype(np.int32),
        real=real,
        leaf_viable=rng.random(CAP) < viable,
        justified_idx=np.int32(justified),
        msg_block=rng.integers(-1, CAP, N).astype(np.int32),
        msg_epoch=rng.integers(0, 6, N).astype(np.int64),
        weight=weight,
        boost_idx=np.int32(rng.integers(0, CAP) if boost else -1),
        boost_amount=np.int64(40 * 32 * 10**9),
    )


def _compare(np_store, min_vote_epoch=None):
    jstore = jfc.DenseStore(*(jnp.asarray(x) for x in np_store))
    mve = None if min_vote_epoch is None else jnp.int64(min_vote_epoch)
    h_j, w_j = jfc.head_and_weights(jstore, CAP, mve)
    tstore = convert.store_to_torch(jstore, "cpu")
    h_t, w_t = tfc.head_and_weights(tstore, CAP, min_vote_epoch)
    assert h_t.dtype == torch.int32 and w_t.dtype == torch.int64
    assert int(h_t) == int(h_j)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    return int(h_t)


@pytest.mark.parametrize("seed", range(6))
def test_head_and_weights_match_jax(seed):
    _compare(_store(seed))


@pytest.mark.parametrize("case", [
    dict(boost=False),
    dict(viable=0.2),
    dict(viable=0.0),
    dict(unreal=5),
    dict(justified=3),
    dict(equal_votes=True, boost=False),
])
def test_head_cases_match_jax(case):
    _compare(_store(11, **case))


@pytest.mark.parametrize("mve", [0, 2, 5, 9])
def test_min_vote_epoch_matches_jax(mve):
    _compare(_store(21), min_vote_epoch=mve)


def test_head_from_buckets_matches_jax():
    st = _store(31)
    rng = np.random.default_rng(31)
    votes = rng.integers(0, 10**12, CAP).astype(np.int64)
    args = (st.parent, st.real, st.rank, st.leaf_viable, st.justified_idx)
    h_j, w_j = jfc.head_from_buckets(*(jnp.asarray(x) for x in args), jnp.asarray(votes),
                                     jnp.asarray(st.boost_idx), jnp.asarray(st.boost_amount),
                                     CAP)
    h_t, w_t = tfc.head_from_buckets(*(torch.from_numpy(np.asarray(x)) for x in args),
                                     torch.from_numpy(votes), torch.tensor(int(st.boost_idx)),
                                     torch.tensor(int(st.boost_amount)), CAP)
    assert int(h_t) == int(h_j)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def test_descent_reaches_the_deepest_leaf_of_a_chain():
    """A chain needs capacity - 1 steps: the fixed-length loop must cover it."""
    st = _store(41, boost=False)._replace(
        parent=np.arange(-1, CAP - 1, dtype=np.int32),
        leaf_viable=np.ones(CAP, bool))
    assert _compare(st) == CAP - 1
