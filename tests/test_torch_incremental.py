"""The port's incremental trees (``ssz/incremental.py``) against the JAX
package's ``ChunkTree``/``RegistryTree``, full merkleization and
``ValidatorRegistry.__ssz_root__``, under randomized mutation; and the
byte order of packed uint chunks. Tolerance 0: roots are equal bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.ops import epoch as jep  # noqa: E402
from pos_evolution_tpu.ops import merkle_device as jmd  # noqa: E402
from pos_evolution_tpu.specs.containers import (  # noqa: E402
    FAR_FUTURE_EPOCH,
    Validator,
    ValidatorRegistry,
    _RegistrySedes,
    _U64ListSedes,
)
from pos_evolution_tpu.ssz import incremental as jinc  # noqa: E402
from pos_evolution_tpu.ssz.merkle import merkleize_chunks  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.device import words_to_numpy  # noqa: E402
from pos_evolution_tpu_torch.ops.epoch import (  # noqa: E402
    FAR_FUTURE_I64,
    i64_to_epoch_bits,
    i64_to_epochs,
)
from pos_evolution_tpu_torch.ssz import incremental as inc  # noqa: E402

LIMIT = 2**40


def _rows(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _words(rows):
    return convert.chunks_to_torch(rows, "cpu")


# --- ChunkTree ----------------------------------------------------------------------

@pytest.mark.parametrize("limit", [None, 1, 16, 1024, 2**35])
def test_chunk_tree_randomized_mutations(limit):
    """Appends, shrinks, point writes, rewrites and no-op rounds: the port's
    tree equals the JAX tree and full merkleization every round."""
    rng = np.random.default_rng(0xC0 + (limit or 0) % 97)
    tree, jtree = inc.ChunkTree(limit), jinc.ChunkTree(limit)
    cap = min(limit if limit is not None else 64, 64)
    chunks = _rows(rng, int(rng.integers(0, min(cap, 12) + 1)))
    for round_ in range(30):
        move = rng.integers(0, 5)
        if move == 0 and chunks.shape[0] < cap:
            chunks = np.concatenate([chunks, _rows(rng, int(rng.integers(1, 4)))])[:cap]
        elif move == 1 and chunks.shape[0] > 0:
            chunks = chunks[:int(rng.integers(0, chunks.shape[0] + 1))]
        elif move == 2 and chunks.shape[0] > 0:
            k = int(rng.integers(1, chunks.shape[0] + 1))
            chunks = chunks.copy()
            chunks[rng.choice(chunks.shape[0], size=k, replace=False)] = _rows(rng, k)
        elif move == 3:
            chunks = _rows(rng, int(rng.integers(0, cap + 1)))
        want = merkleize_chunks(chunks, limit)
        assert tree.root(_words(chunks)) == want, f"round {round_} n={chunks.shape[0]}"
        assert jtree.root(chunks) == want


def test_chunk_tree_levels_match_jax_after_updates():
    rng = np.random.default_rng(4)
    tree, jtree = inc.ChunkTree(2**20), jinc.ChunkTree(2**20)
    chunks = _rows(rng, 45)
    for step in range(3):
        assert tree.root(_words(chunks)) == jtree.root(chunks)
        assert len(tree.levels) == len(jtree.levels)
        for g, w in zip(tree.levels, jtree.levels):
            np.testing.assert_array_equal(words_to_numpy(g), jmd._rows_to_words(w))
        chunks = chunks.copy()
        chunks[rng.integers(0, 45, 3)] ^= 0x5A
    assert tree.dirty <= 3


def test_chunk_tree_cache_hit_counts_nothing():
    rng = np.random.default_rng(5)
    tree = inc.ChunkTree(64)
    chunks = _rows(rng, 9)
    r1 = tree.root(_words(chunks))
    before = inc.stats()
    assert tree.root(_words(chunks.copy())) == r1
    after = inc.stats()
    assert after["dirty_chunks"] == before["dirty_chunks"]
    assert after["htr_cache_hit"] == before["htr_cache_hit"] + 1
    assert tree.dirty == 0


def test_chunk_tree_limit_overflow_raises():
    with pytest.raises(ValueError, match="exceed"):
        inc.ChunkTree(2).root(_words(_rows(np.random.default_rng(1), 3)))


def test_abandoned_sweep_rebuilds():
    """A tree registered on a sweeper that never runs must rebuild next time,
    not serve its old root as a cache hit."""
    from pos_evolution_tpu_torch.ops.merkle_device import LevelSweeper
    rng = np.random.default_rng(6)
    chunks = _rows(rng, 20)
    tree = inc.ChunkTree(64)
    tree.root(_words(chunks))
    chunks[3] ^= 1
    tree.root(_words(chunks), LevelSweeper())     # registered, never run
    assert tree.root(_words(chunks)) == merkleize_chunks(chunks, 64)


# --- RegistryTree -----------------------------------------------------------------

def _jax_registry(rng, n):
    reg = ValidatorRegistry(n)
    reg.pubkeys[:] = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    reg.withdrawal_credentials[:] = _rows(rng, n)
    reg.effective_balance[:] = rng.integers(0, 2**35, n).astype(np.uint64)
    reg.slashed[:] = rng.random(n) < 0.1
    reg.activation_eligibility_epoch[:] = rng.integers(0, 100, n).astype(np.uint64)
    reg.activation_epoch[:] = rng.integers(0, 2**40, n).astype(np.uint64)
    exiting = rng.random(n) < 0.3     # the rest stay at FAR_FUTURE_EPOCH
    reg.exit_epoch[exiting] = rng.integers(2**31, 2**33, int(exiting.sum())).astype(np.uint64)
    reg.withdrawable_epoch[exiting] = reg.exit_epoch[exiting] + np.uint64(256)
    return reg


def test_registry_tree_randomized_mutations():
    rng = np.random.default_rng(21)
    jreg = _jax_registry(rng, 40)
    tree, jtree = inc.RegistryTree(), jinc.RegistryTree()
    full = _RegistrySedes()
    for round_ in range(12):
        reg = convert.validator_registry_to_torch(jreg, "cpu")
        want = full.htr(jreg)
        assert want == jreg.__ssz_root__()
        assert tree.root(reg, LIMIT) == want, f"round {round_}"
        assert jtree.root(jreg, LIMIT) == want
        move = round_ % 4
        rows = rng.choice(len(jreg), size=3, replace=False)
        if move == 0:
            jreg.effective_balance[rows] = rng.integers(0, 2**35, 3).astype(np.uint64)
        elif move == 1:
            jreg.slashed[rows] = True
            jreg.exit_epoch[rows] = np.uint64(FAR_FUTURE_EPOCH)
            jreg.withdrawable_epoch[rows] = rng.integers(0, 2**20, 3).astype(np.uint64)
        elif move == 2:
            jreg.withdrawal_credentials[rows] = _rows(rng, 3)
            jreg.pubkeys[rows[0]] ^= 0x11
        else:
            v = Validator()
            v.effective_balance = 32 * 10**9
            jreg.append(v)
    assert tree.root(convert.validator_registry_to_torch(jreg, "cpu"), LIMIT) == full.htr(jreg)
    assert tree.dirty_rows == 1          # the last round appended one validator


def test_registry_tree_no_change_is_a_cache_hit():
    jreg = _jax_registry(np.random.default_rng(22), 17)
    reg = convert.validator_registry_to_torch(jreg, "cpu")
    tree = inc.RegistryTree()
    r1 = tree.root(reg, LIMIT)
    before = inc.stats()
    assert tree.root(convert.validator_registry_to_torch(jreg, "cpu"), LIMIT) == r1
    after = inc.stats()
    assert tree.dirty_rows == 0
    assert after["validator_root_passes"] == before["validator_root_passes"]
    assert after["htr_cache_hit"] == before["htr_cache_hit"] + 1


def test_validator_roots_match_jax():
    jreg = _jax_registry(np.random.default_rng(23), 30)
    reg = convert.validator_registry_to_torch(jreg, "cpu")
    np.testing.assert_array_equal(words_to_numpy(inc._validator_roots_rows(reg)),
                                  jmd._rows_to_words(jreg.validator_roots()))
    idx = torch.tensor([29, 0, 7])
    np.testing.assert_array_equal(words_to_numpy(inc._validator_roots_rows(reg, idx)),
                                  jmd._rows_to_words(jinc._validator_roots_rows(jreg, idx.numpy())))


def test_validator_registry_round_trip():
    jreg = _jax_registry(np.random.default_rng(24), 12)
    reg = convert.validator_registry_to_torch(jreg, "cpu")
    assert reg.exit_epoch.dtype == torch.int64
    assert int(reg.exit_epoch[~torch.from_numpy(jreg.exit_epoch < 2**62)][0]) == -1
    back = convert.validator_registry_to_numpy(reg)
    for f, a in back.items():
        b = getattr(jreg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# --- byte order ---------------------------------------------------------------------

def _edge_u64(rng, n):
    vals = rng.integers(0, 2**64, n, dtype=np.uint64)
    vals[:6] = [0, 1, 2**31, 2**32 - 1, 2**63 + 5, FAR_FUTURE_EPOCH]
    return vals


@pytest.mark.parametrize("n", [0, 1, 3, 4, 9])
def test_pack_u64_chunks_byte_order(n):
    """A uint64 v fills bytes 0-7 of its chunk: word 0 = bswap32(low 32
    bits), word 1 = bswap32(high 32 bits). Values at and past 2^31, 2^63
    and the FAR_FUTURE pattern."""
    vals = _edge_u64(np.random.default_rng(n), max(n, 6))[:n]
    got = inc._pack_uint_chunks(torch.from_numpy(vals.view(np.int64)), 8)
    want = jmd._rows_to_words(jinc._pack_uint_chunks(vals, 8))
    np.testing.assert_array_equal(words_to_numpy(got), want.reshape(-1, 8))
    assert got.shape == (-(-n // 4), 8)
    if n:
        v = int(vals[0])
        assert words_to_numpy(got)[0, 0] == int.from_bytes((v & 0xFFFFFFFF).to_bytes(4, "little"),
                                                           "big")
        assert words_to_numpy(got)[0, 1] == int.from_bytes((v >> 32).to_bytes(4, "little"), "big")


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100])
def test_pack_u8_chunks(n):
    flags = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    got = inc._pack_uint_chunks(torch.from_numpy(flags), 1)
    want = jmd._rows_to_words(jinc._pack_uint_chunks(flags, 1))
    np.testing.assert_array_equal(words_to_numpy(got), want.reshape(-1, 8))


def test_u64_list_root_matches_sedes():
    vals = _edge_u64(np.random.default_rng(7), 21)
    sedes = _U64ListSedes(np.uint64, LIMIT)
    tree = inc.ChunkTree(LIMIT // 4)
    root = inc.mix_in_length(tree.root(inc._pack_uint_chunks(
        torch.from_numpy(vals.view(np.int64)), 8)), 21)
    assert root == sedes.htr(vals)


def test_i64_to_epochs_matches_jax():
    """``i64_to_epochs`` keeps the JAX contract (host uint64, from numpy or
    a tensor); ``i64_to_epoch_bits`` is its int64 bit-pattern tensor form."""
    col = np.array([0, 1, 2**32, FAR_FUTURE_I64, 2**62 - 1, 12345], np.int64)
    want = jep.i64_to_epochs(col)
    for arg in (col, torch.from_numpy(col)):
        got = i64_to_epochs(arg)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    bits = i64_to_epoch_bits(torch.from_numpy(col)).numpy().view(np.uint64)
    np.testing.assert_array_equal(bits, want)
    assert bits[3] == np.uint64(FAR_FUTURE_EPOCH)
