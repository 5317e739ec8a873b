"""The port's swap-or-not shuffle against the JAX package and the spec's
per-index shuffle (bit for bit)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.config import minimal_config, use_config  # noqa: E402
from pos_evolution_tpu.ops import shuffle as jshuf  # noqa: E402
from pos_evolution_tpu.specs.helpers import compute_shuffled_index  # noqa: E402
from pos_evolution_tpu_torch.ops import shuffle as tshuf  # noqa: E402

SEED = bytes(range(32))


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000, 4096])
def test_permutation_matches_jax(n):
    rounds = 10
    np.testing.assert_array_equal(tshuf.host_pivots(SEED, n, rounds),
                                  jshuf.host_pivots(SEED, n, rounds))
    want = np.asarray(jshuf.shuffle_permutation_jax(SEED, n, rounds))
    got = tshuf.shuffle_permutation(SEED, n, rounds, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


def test_matches_spec_per_index():
    n = 300
    with use_config(minimal_config()) as cfg:
        perm = tshuf.shuffle_permutation(SEED, n, cfg.shuffle_round_count, "cpu")
        for i in (0, 1, 150, 255, 256, 299):
            assert int(perm[i]) == compute_shuffled_index(i, n, SEED)


def test_negative_pivot_difference_wraps_like_python():
    """(pivot - idx) % n with pivot < idx: torch.remainder follows the
    divisor's sign, as Python's % and jnp's % do."""
    n = 10
    pivot = torch.tensor(3, dtype=torch.int64)
    idx = torch.arange(n, dtype=torch.int64)
    assert torch.remainder(pivot - idx, n).tolist() == [(3 - i) % n for i in range(n)]


def test_empty_registry():
    assert tshuf.shuffle_permutation(SEED, 0, 10, "cpu").numel() == 0


def test_partial_index_slice_matches_full():
    """Each index's trajectory is independent: a slice of [0, n) gives the
    same values as the full permutation."""
    n, rounds = 600, 10
    pivots = torch.as_tensor(tshuf.host_pivots(SEED, n, rounds))
    full = tshuf.shuffle_permutation(SEED, n, rounds, "cpu")
    part = tshuf._shuffle_rounds(tshuf._seed_words(SEED), pivots,
                                 torch.arange(100, 400, dtype=torch.int32), n, rounds)
    assert torch.equal(part, full[100:400])
