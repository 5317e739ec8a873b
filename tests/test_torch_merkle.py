"""The port's merkleization (``ssz/merkle.py``, ``ops/merkle_device.py``)
and K2's plain version against the JAX package and hashlib.

All of it is integer math: roots, levels and proofs must be equal byte for
byte (tolerance 0). The JAX side runs on its host (numpy) path, and its
Pallas kernel once in interpret mode.
"""

import hashlib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import merkle_device as jmd  # noqa: E402
from pos_evolution_tpu.ops import pallas_sha256 as jpallas  # noqa: E402
from pos_evolution_tpu.ssz import incremental as jinc  # noqa: E402
from pos_evolution_tpu.ssz import merkle as jmerkle  # noqa: E402
from pos_evolution_tpu_torch.convert import chunks_to_torch  # noqa: E402
from pos_evolution_tpu_torch.device import (  # noqa: E402
    rows_to_words,
    words_to_bytes,
    words_to_numpy,
    words_to_rows,
    words_to_torch,
)
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
from pos_evolution_tpu_torch.ops import merkle_device as md  # noqa: E402
from pos_evolution_tpu_torch.ops.sha256 import _rotr  # noqa: E402
from pos_evolution_tpu_torch.ssz import incremental as inc  # noqa: E402
from pos_evolution_tpu_torch.ssz import merkle as tm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _words(rows):
    return chunks_to_torch(rows, "cpu")


def _rows_np(words):
    return words_to_rows(words).numpy()


# --- K2's plain version ---------------------------------------------------------------

def test_merkle_level_matches_pallas_interpret():
    """One 512-pair tile through the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    n = jpallas.TILE
    left, right = _rows(rng, n), _rows(rng, n)
    msgs = np.concatenate([jmd._rows_to_words(left), jmd._rows_to_words(right)], axis=1)
    want = np.asarray(jpallas.merkle_level_pallas(jnp.asarray(msgs.T), interpret=True)).T
    got = md._merkle_level(_words(left), _words(right))
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    np.testing.assert_array_equal(words_to_numpy(got), want)


@pytest.mark.parametrize("n", [1, 3, 64])
def test_merkle_level_matches_hashlib(n):
    rng = np.random.default_rng(n)
    left, right = _rows(rng, n), _rows(rng, n)
    before = dict(kernels.launches)
    got = md.merkle_level(_words(left), _words(right))
    assert kernels.launches == before          # CPU tensors take the plain version
    for i in range(n):
        want = hashlib.sha256(left[i].tobytes() + right[i].tobytes()).digest()
        assert words_to_bytes(words_to_numpy(got[i])) == want


def test_merkle_level_strided_views_and_empty():
    """The even and odd rows of one level (row stride 16 words), and N = 0."""
    rng = np.random.default_rng(9)
    layer = _words(_rows(rng, 10))
    got = md.merkle_level(layer[0::2], layer[1::2])
    assert torch.equal(got, md._merkle_level(layer[0::2].contiguous(),
                                             layer[1::2].contiguous()))
    empty = md.merkle_level(layer[:0], layer[:0])
    assert empty.shape == (0, 8)


def test_kernel_pad_schedule_is_the_padding_block_schedule():
    """The __constant__ table in csrc/merkle_level.cu is the expanded
    schedule of the padding block of a 64-byte message."""
    src = open(os.path.join(REPO, "pos_evolution_tpu_torch", "csrc", "merkle_level.cu")).read()
    body = re.search(r"kPadSchedule\[64\] = \{(.*?)\};", src, re.S).group(1)
    table = [int(x, 16) for x in re.findall(r"0x([0-9A-F]{8})u", body)]
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    assert table == w


def test_rows_words_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    rows = _rows(rng, 33)
    rows[0] = 0xFF
    words = rows_to_words(torch.from_numpy(rows))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(words), jmd._rows_to_words(rows))
    np.testing.assert_array_equal(_rows_np(words), rows)
    np.testing.assert_array_equal(_rows_np(words), jmd._words_to_rows(jmd._rows_to_words(rows)))


def test_zero_hashes_match_jax():
    assert len(tm.ZERO_HASHES) == len(jmerkle.ZERO_HASHES) == tm.MAX_DEPTH + 1
    assert tm.ZERO_HASHES == [z.tobytes() for z in jmerkle.ZERO_HASHES]
    np.testing.assert_array_equal(tm.ZERO_WORDS, jmd._rows_to_words(jmerkle.ZERO_HASHES))


# --- whole trees and proofs -------------------------------------------------------------

@pytest.mark.parametrize("count,limit", [(0, None), (0, 8), (1, None), (1, 2**40), (5, None),
                                         (7, 16), (33, 64), (64, None), (100, 2**38)])
def test_merkleize_matches_jax(count, limit):
    rng = np.random.default_rng(count * 7 + (limit or 0) % 13)
    rows = _rows(rng, count)
    want = jmerkle.merkleize_chunks(rows, limit)
    assert tm.merkleize_chunks(_words(rows), limit) == want
    assert md.merkleize(_words(rows), limit) == want
    assert jmd.merkleize(rows, limit) == want


def test_merkleize_rejects_over_limit():
    with pytest.raises(ValueError, match="exceed"):
        tm.merkleize_chunks(_words(_rows(np.random.default_rng(2), 5)), 4)


@pytest.mark.parametrize("count,depth", [(1, 0), (11, 4), (16, 4), (5, 7)])
def test_tree_levels_match_jax(count, depth):
    rng = np.random.default_rng(count + depth)
    rows = _rows(rng, count)
    got = md.tree_levels(_words(rows), depth)
    want = jmerkle._tree_levels(rows, depth)
    assert len(got) == len(want) == depth + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_rows_np(g), w)


def test_proofs_match_jax():
    rng = np.random.default_rng(3)
    depth = 5
    rows = _rows(rng, 21)
    words = _words(rows)
    root = jmerkle.merkleize_chunks(rows, 1 << depth)
    idx = [0, 3, 3, 4, 20, 17]

    got_leaves, got_br = md.build_multiproof_paths(words, idx, depth)
    want_leaves, want_br = jmd.build_multiproof_paths_host(rows, idx, depth)
    np.testing.assert_array_equal(_rows_np(got_leaves), want_leaves)
    np.testing.assert_array_equal(_rows_np(got_br.reshape(-1, 8)).reshape(want_br.shape), want_br)

    proof = md.multiproof(words, idx, depth)
    assert proof == jmerkle.build_multiproof(rows, idx, depth)
    assert proof == tm.build_multiproof(words, idx, depth)
    assert tm.multiproof_helper_gindices(idx, depth) == \
        jmerkle.multiproof_helper_gindices(idx, depth)
    leaves = [rows[i].tobytes() for i in idx]
    assert tm.verify_multiproof(leaves, idx, proof, depth, root)
    assert jmerkle.verify_multiproof(leaves, idx, proof, depth, root)
    bad = list(leaves)
    bad[1] = bytes(32)
    assert not tm.verify_multiproof(bad, idx, proof, depth, root)   # duplicate disagrees
    assert not tm.verify_multiproof(leaves, idx, proof[:-1], depth, root)
    assert not tm.verify_multiproof(leaves, idx, proof, depth, bytes(32))

    for i in (0, 7, 20):
        branch = tm.merkle_tree_branch(words, i, depth)
        assert branch == jmerkle.merkle_tree_branch(rows, i, depth)
        assert tm.is_valid_merkle_branch(rows[i].tobytes(), branch, depth, i, root)
        assert jmerkle.is_valid_merkle_branch(rows[i].tobytes(), branch, depth, i, root)
        assert not tm.is_valid_merkle_branch(rows[i].tobytes(), branch, depth, i ^ 1, root)


def test_mix_in_length_matches_jax():
    root = bytes(range(32))
    for length in (0, 1, 2**20, 2**40 - 1):
        assert tm.mix_in_length(root, length) == jmerkle.mix_in_length(root, length)


@pytest.mark.parametrize("size", [0, 1, 31, 32, 33, 100, 256])
def test_digest_bytes_matches_jax(size):
    blob = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert md.DIGEST_ALGO == jmd.DIGEST_ALGO
    got = md.digest_bytes(blob, "cpu")
    assert got == jmd.digest_bytes(blob)
    assert md.digest_bytes(np.frombuffer(blob, np.uint8), "cpu") == got


def test_digest_bytes_binds_the_length():
    """Zero padding to a whole chunk does not collide: the length is mixed in."""
    a = b"\x07" * 40
    assert md.digest_bytes(a, "cpu") != md.digest_bytes(a + b"\x00", "cpu")
    assert md.digest_bytes(a + b"\x00", "cpu") == jmd.digest_bytes(a + b"\x00")


@pytest.mark.parametrize("n,depth", [(8, 3), (16, 6)])
def test_merkleize_words_device_matches_jax(n, depth):
    rng = np.random.default_rng(n + depth)
    rows = _rows(rng, n)
    zero = jmd._rows_to_words(jmerkle.ZERO_HASHES[: depth + 1])
    want = np.asarray(jpallas.merkleize_words_device(
        jnp.asarray(jmd._rows_to_words(rows)), depth, zero, use_pallas=False))
    got = md.merkleize_words_device(_words(rows), depth)
    np.testing.assert_array_equal(words_to_numpy(got), want)
    assert words_to_bytes(want) == jmerkle.merkleize_chunks(rows, 1 << depth)
    with pytest.raises(ValueError, match="power of two"):
        md.merkleize_words_device(_words(rows[:3]), depth)


# --- lockstep batching ---------------------------------------------------------------

def test_level_sweeper_mixed_dirty_clean():
    """Four trees (clean, dirty, growing, first build) in one sweeper: every
    root equals a tree driven alone and the JAX package's, the clean tree
    adds no job, and the rounds are the deepest tree's level count."""
    rng = np.random.default_rng(8)
    data = [_rows(rng, n) for n in (40, 40, 24, 16)]
    solo = [inc.ChunkTree(64) for _ in data]
    batched = [inc.ChunkTree(64) for _ in data]
    for trees in (solo, batched):
        for tree, rows in zip(trees[:3], data[:3]):
            tree.root(_words(rows))
    data[1] = data[1].copy()
    data[1][5] ^= 0xFF
    data[2] = np.concatenate([data[2], _rows(rng, 8)])

    want = [tree.root(_words(rows)) for tree, rows in zip(solo, data)]
    assert want == [jinc.ChunkTree(64).root(rows) for rows in data]
    before = md.stats()
    sweeper = md.LevelSweeper()
    fins = [tree.root(_words(rows), sweeper) for tree, rows in zip(batched, data)]
    sweeper.run()
    got = [fin() for fin in fins]
    after = md.stats()
    assert got == want
    assert after["batched_jobs"] == before["batched_jobs"] + 3
    assert after["batched_launches"] - before["batched_launches"] == 6
    assert after["sweeps"] - before["sweeps"] == 6


def test_level_sweeper_plain_flag_gives_the_same_roots():
    rng = np.random.default_rng(10)
    rows = _rows(rng, 37)
    roots = []
    for plain in (False, True):
        tree = inc.ChunkTree(2**20)
        sweeper = md.LevelSweeper(plain=plain)
        fin = tree.root(_words(rows), sweeper)
        sweeper.run()
        roots.append(fin())
    assert roots[0] == roots[1] == jmerkle.merkleize_chunks(rows, 2**20)


def test_zero_words_per_device_cache():
    z = tm.zero_words(torch.device("cpu"))
    assert z is tm.zero_words(torch.device("cpu"))
    assert torch.equal(z, words_to_torch(tm.ZERO_WORDS, "cpu"))
