"""The port's SHA-256 and word helpers against hashlib and the JAX package.

All of it is integer math: the comparisons are bit for bit (tolerance 0).
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import sha256 as jsha  # noqa: E402
from pos_evolution_tpu.utils.benchtime import checksum_tree as jax_checksum_tree  # noqa: E402
from pos_evolution_tpu_torch import device as tdev  # noqa: E402
from pos_evolution_tpu_torch.ops import sha256 as tsha  # noqa: E402


def _pad(msgs: np.ndarray) -> np.ndarray:
    """(N, L) uint8 -> (N, 16*blocks) uint32 padded big-endian words."""
    n, length = msgs.shape
    total = ((length + 9 + 63) // 64) * 64
    padded = np.zeros((n, total), np.uint8)
    padded[:, :length] = msgs
    padded[:, length] = 0x80
    padded[:, -8:] = np.frombuffer((length * 8).to_bytes(8, "big"), np.uint8)
    return padded.view(">u4").astype(np.uint32)


def _rand_words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("length", [0, 32, 55, 56, 64, 100])
def test_sha256_words_matches_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (9, length), dtype=np.uint8)
    got = tdev.words_to_numpy(tsha.sha256_words(torch.from_numpy(_pad(msgs).astype(np.int64))))
    for i in range(msgs.shape[0]):
        assert tdev.words_to_bytes(got[i]) == hashlib.sha256(msgs[i].tobytes()).digest()


def test_compress_matches_jax():
    rng = np.random.default_rng(1)
    state = _rand_words(rng, (64, 8))
    block = _rand_words(rng, (64, 16))
    want = np.asarray(jsha.sha256_compress(jnp.asarray(state), jnp.asarray(block)))
    got = tdev.words_to_numpy(tsha.sha256_compress(
        tdev.words_to_torch(state, "cpu"), tdev.words_to_torch(block, "cpu")))
    np.testing.assert_array_equal(got, want)


def test_compress_broadcasts_a_shared_block():
    """(A, 1, 16) blocks against (A, C, 8) states equal the per-lane hash."""
    rng = np.random.default_rng(2)
    state = _rand_words(rng, (3, 5, 8))
    block = _rand_words(rng, (3, 1, 16))
    got = tsha.sha256_compress(tdev.words_to_torch(state, "cpu"), tdev.words_to_torch(block, "cpu"))
    full = tsha.sha256_compress(tdev.words_to_torch(state, "cpu"),
                                tdev.words_to_torch(np.repeat(block, 5, axis=1), "cpu"))
    assert torch.equal(got, full)


def test_pair_words_matches_jax_and_hashlib():
    rng = np.random.default_rng(3)
    left, right = _rand_words(rng, (16, 8)), _rand_words(rng, (16, 8))
    want = np.asarray(jsha.sha256_pair_words(jnp.asarray(left), jnp.asarray(right)))
    got = tdev.words_to_numpy(tsha.sha256_pair_words(
        tdev.words_to_torch(left, "cpu"), tdev.words_to_torch(right, "cpu")))
    np.testing.assert_array_equal(got, want)
    msg = tdev.words_to_bytes(left[0]) + tdev.words_to_bytes(right[0])
    assert tdev.words_to_bytes(got[0]) == hashlib.sha256(msg).digest()


def test_constants_match_jax():
    np.testing.assert_array_equal(tsha._K, jsha._K)
    np.testing.assert_array_equal(tsha.H0, jsha.H0)


def test_word_forms_round_trip():
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF], np.uint32)
    t = tdev.words_to_torch(edge, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tdev.u32(t).numpy(), edge.astype(np.int64))
    assert torch.equal(tdev.i32(tdev.u32(t)), t)
    np.testing.assert_array_equal(tdev.words_to_numpy(tdev.u32(t)), edge)
    assert tdev.bytes_to_words(tdev.words_to_bytes(edge)).tolist() == edge.tolist()


def test_checksum_matches_jax():
    rng = np.random.default_rng(4)
    leaves = {
        "balances": rng.integers(0, 2**40, 257).astype(np.int64),
        "neg": rng.integers(-2**40, 0, 33).astype(np.int64),
        "words": _rand_words(rng, (5, 8)),
        "flags": rng.integers(0, 8, 19).astype(np.uint8),
        "ok": rng.random(11) < 0.5,
    }
    want = int(jax_checksum_tree({k: jnp.asarray(v) for k, v in leaves.items()}))
    got = tdev.checksum_tree([torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                              for v in leaves.values()])
    assert got == want
