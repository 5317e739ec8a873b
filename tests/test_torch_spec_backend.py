"""Each entry of the port's backend object (``backend/torch_backend.py``)
against its twin in the JAX package's ``jax_backend`` on the CPU, at
tolerance 0, on inputs made from numpy seeds: the shuffle (and the
identity at 0 rounds, where ``jax_backend`` raises and the numpy backend
gives the identity), the weight and segment sums, the subtree weights, the
variant and link tallies, the epoch sweep, the block sweep and the chain
apply, the merkle entries, sync and DAS verification, the reconstruction
check, the Fr NTT and the G1 MSM. The port's side runs on a CPU-device
backend (the kernels' plain versions)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.backend.jax_init import ensure_x64  # noqa: E402

ensure_x64()

import pos_evolution_tpu.das  # noqa: E402,F401  (before ops.das_verify: its import order)
from pos_evolution_tpu import config as jc  # noqa: E402
from pos_evolution_tpu.backend import jax_backend as jb  # noqa: E402
from pos_evolution_tpu.backend import numpy_backend as nb  # noqa: E402
from pos_evolution_tpu.backend import set_backend as jax_set_backend  # noqa: E402
from pos_evolution_tpu.kzg import curve as jcurve  # noqa: E402
from pos_evolution_tpu.kzg import fr as jfr  # noqa: E402
from pos_evolution_tpu.kzg.setup import trusted_setup as jsetup  # noqa: E402
from pos_evolution_tpu.ops import das_verify as jdv  # noqa: E402
from pos_evolution_tpu.ops import sync_verify as jsv  # noqa: E402
from pos_evolution_tpu.ops import transition as jtr  # noqa: E402
from pos_evolution_tpu.specs import genesis as jgen  # noqa: E402
from pos_evolution_tpu.ssz import merkle as jmerkle  # noqa: E402
from pos_evolution_tpu.ssz.hash import sha256_batch  # noqa: E402
from pos_evolution_tpu_torch import config as tc  # noqa: E402
from pos_evolution_tpu_torch.backend import use_backend  # noqa: E402
from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend  # noqa: E402
from pos_evolution_tpu_torch.das import erasure as tera  # noqa: E402
from pos_evolution_tpu_torch.kzg.setup import trusted_setup as tsetup  # noqa: E402
from pos_evolution_tpu_torch.ops import das_verify as tdv  # noqa: E402
from pos_evolution_tpu_torch.ops import sync_verify as tsv  # noqa: E402
from pos_evolution_tpu_torch.ops import transition as ttr  # noqa: E402
from pos_evolution_tpu_torch.specs import genesis as tgen  # noqa: E402


@pytest.fixture(autouse=True)
def _minimal():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ttr.reset_session()
    jtr.reset_session()
    jax_set_backend("numpy")
    with jc.use_config(jc.minimal_config()), tc.use_config(tc.minimal_config()), \
            use_backend("torch", device="cpu") as b:
        yield b
    torch.set_num_threads(n)
    jax_set_backend("numpy")


@pytest.fixture
def tb(_minimal) -> TorchBackend:
    return _minimal


def test_the_backend_object():
    b = TorchBackend("cpu")
    assert b.accelerated_epoch and b.device == torch.device("cpu")
    assert b.name == "torch:cpu"
    with pytest.raises(NotImplementedError, match="item 3"):
        b.enable_sharded(4)


@pytest.mark.parametrize("n,rounds", [(1, 10), (100, 10), (1000, 90), (300, 0), (0, 5)])
def test_shuffle_permutation(tb, n, rounds):
    seed = bytes(range(32))
    got = tb.shuffle_permutation(seed, n, rounds)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, nb.shuffle_permutation(seed, n, rounds))
    if rounds == 0:
        np.testing.assert_array_equal(got, np.arange(n, dtype=np.uint64))
        with pytest.raises(IndexError):            # the JAX backend's hazard, not copied
            jb.shuffle_permutation(seed, n, rounds)
    elif n:
        np.testing.assert_array_equal(got, jb.shuffle_permutation(seed, n, rounds))


def test_weight_and_segment_sums(tb):
    rng = np.random.default_rng(1)
    eff = (rng.integers(0, 33, 50) * 10**9).astype(np.uint64)
    masks = rng.random((6, 50)) < 0.5
    got = tb.committee_weight_sums(eff, masks)
    np.testing.assert_array_equal(got, nb.committee_weight_sums(eff, masks))
    np.testing.assert_array_equal(got, jb.committee_weight_sums(eff, masks))
    for dtype in (np.int64, np.uint64):
        vals = rng.integers(0, 2**40, 80).astype(dtype)
        ids = rng.integers(0, 9, 80)
        got = tb.segment_sum(vals, ids, 9)
        want = jb.segment_sum(vals, ids, 9)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_subtree_weights(tb):
    rng = np.random.default_rng(2)
    parent = np.array([-1] + [int(rng.integers(0, i)) for i in range(1, 40)])
    w = rng.integers(0, 10**9, 40)
    np.testing.assert_array_equal(tb.subtree_weights(parent, w), jb.subtree_weights(parent, w))


def test_variant_and_link_tallies(tb):
    rng = np.random.default_rng(3)
    k = 200
    block_idx = rng.integers(-1, 12, k)
    vote_slot = rng.integers(0, 40, k)
    weight = rng.integers(0, 2**35, k)
    active = rng.random(k) < 0.8
    got = tb.variant_tally(block_idx, vote_slot, weight, active, 5, 30, 12)
    np.testing.assert_array_equal(got, jb.variant_tally(block_idx, vote_slot, weight, active,
                                                        5, 30, 12))
    link_idx = rng.integers(-1, 7, k)
    np.testing.assert_array_equal(tb.link_tally(link_idx, weight, active, 7),
                                  jb.link_tally(link_idx, weight, active, 7))


def test_epoch_sweep(tb):
    js, _ = jgen.make_genesis(64)
    ts, _ = tgen.make_genesis(64)
    for s in (js, ts):
        r = np.random.default_rng(5)
        s.slot = 4 * 8 - 1
        s.balances = r.integers(31 * 10**9, 33 * 10**9, 64).astype(np.uint64)
        s.previous_epoch_participation = r.integers(0, 8, 64).astype(np.uint8)
        s.current_epoch_participation = r.integers(0, 8, 64).astype(np.uint8)
        s.justification_bits = np.array([True, False, True, False])
    got = tb.epoch_sweep(ts, tc.minimal_config())
    want = jb.epoch_sweep(js, jc.minimal_config())
    for f in got.registry._fields:
        g, w = getattr(got.registry, f), np.asarray(getattr(want.registry, f))
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


def test_block_sweep_and_multi_block_apply(tb):
    rng = np.random.default_rng(6)
    js, _ = jgen.make_genesis(64)
    ts, _ = tgen.make_genesis(64)
    for s in (js, ts):
        s.slot = 9
    rows = [(np.sort(rng.choice(64, 20, replace=False)).astype(np.int64), [0, 1], True),
            (np.sort(rng.choice(64, 9, replace=False)).astype(np.int64), [0, 1, 2], False)]
    jb.block_sweep(js, rows)
    tb.block_sweep(ts, rows)
    for f in ("balances", "previous_epoch_participation", "current_epoch_participation"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    calls = []
    tb.multi_block_apply(ts, [], pre_block=calls.append, on_applied=calls.append)
    assert calls == []


def test_merkle_entries(tb):
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (33, 32)).astype(np.uint8)
    right = rng.integers(0, 256, (33, 32)).astype(np.uint8)
    np.testing.assert_array_equal(tb.merkle_level(left, right), jb.merkle_level(left, right))
    for count, limit in ((0, 4), (1, None), (13, 16), (40, 2**10)):
        rows = rng.integers(0, 256, (count, 32)).astype(np.uint8)
        assert tb.merkleize(rows, limit) == jb.merkleize(rows, limit)
    leaves = rng.integers(0, 256, (21, 32)).astype(np.uint8)
    idx = [0, 5, 20, 5]
    got = tb.build_multiproof_paths(leaves, idx, 6)
    want = jb.build_multiproof_paths(leaves, idx, 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sync_update_verify(tb):
    from pos_evolution_tpu.crypto.bls import FakeBLS
    rng = np.random.default_rng(8)
    b, s = 6, 16
    pubkeys = rng.integers(0, 256, (b, s, 48)).astype(np.uint8)
    bits = rng.random((b, s)) < 0.7
    messages = rng.integers(0, 256, (b, 32)).astype(np.uint8)
    signatures = np.zeros((b, 96), np.uint8)
    for i in range(b):
        pks = [pubkeys[i, j].tobytes() for j in np.nonzero(bits[i])[0]]
        if pks and i != 2:                         # update 2 forged
            signatures[i] = np.frombuffer(FakeBLS.Aggregate(
                [FakeBLS._sig_for(pk, messages[i].tobytes()) for pk in pks]), np.uint8)

    def group(depth):
        leaf = rng.integers(0, 256, (b, 32)).astype(np.uint8)
        branch = rng.integers(0, 256, (b, depth, 32)).astype(np.uint8)
        index = rng.integers(0, 1 << depth, b).astype(np.int64)
        root = jsv.merkle_roots_host(leaf, branch, index)
        root[1, 0] ^= 1
        return leaf, branch, index, root, rng.random(b) < 0.8

    fin, sc = group(6), group(5)
    fields = dict(pubkeys=pubkeys, bits=bits, weights=rng.integers(0, 2**40, (b, s)),
                  messages=messages, signatures=signatures,
                  fin_leaf=fin[0], fin_branch=fin[1], fin_index=fin[2], fin_root=fin[3],
                  fin_present=fin[4], sc_leaf=sc[0], sc_branch=sc[1], sc_index=sc[2],
                  sc_root=sc[3], sc_present=sc[4])
    got = tb.sync_update_verify(tsv.SyncUpdateBatch(**fields))
    want = jb.sync_update_verify(jsv.SyncUpdateBatch(**fields))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_das_verify_and_reconstruct(tb):
    rng = np.random.default_rng(9)
    cells = rng.integers(0, 256, (16, 64)).astype(np.uint8)
    leaves = sha256_batch(cells)
    root = np.frombuffer(jmerkle.merkleize_chunks(leaves), np.uint8)
    pick = rng.integers(0, 16, 12)
    branches = np.stack([np.frombuffer(b"".join(jmerkle.merkle_tree_branch(leaves, int(i), 4)),
                                       np.uint8).reshape(4, 32) for i in pick])
    fields = dict(cells=cells[pick].copy(), branches=branches, indices=pick.astype(np.int64),
                  commitments=np.tile(root, (12, 1)))
    fields["cells"][3, 0] ^= 1
    got = tb.das_verify(tdv.DasSampleBatch(**{k: v.copy() for k, v in fields.items()}))
    want = jb.das_verify(jdv.DasSampleBatch(**fields))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert not got["ok"][3] and got["ok"].sum() == 11
    grid = tera.extend_blob(rng.integers(0, 256, (8, 64)).astype(np.uint8))
    present = np.zeros(16, bool)
    present[rng.choice(16, 9, replace=False)] = True
    ok, data = tb.das_reconstruct(grid, present)
    jok, jdata = jb.das_reconstruct(grid, present)
    assert ok is True and bool(jok) is True
    np.testing.assert_array_equal(data, np.asarray(jdata))


def test_fr_ntt(tb):
    rng = np.random.default_rng(10)
    vals = jfr.encode([int(x) for x in rng.integers(0, 2**62, 16)]).reshape(2, 8, jfr.L)
    for inverse in (False, True):
        got = tb.fr_ntt(vals, inverse)
        want = np.asarray(jb.fr_ntt(vals, inverse))
        assert got.shape == want.shape
        assert jfr.decode(got) == jfr.decode(want)


def test_g1_msm(tb):
    """The MSM over a setup's powers against the JAX package's host
    Pippenger, the route its numpy backend takes for the same call (the
    ``jax_backend`` twin's double-and-add compile takes minutes on the
    CPU; the JAX package's own tests hold the two equal)."""
    coeffs = [3, 5, 0, 2**200 + 7]
    want = jcurve.g1_lincomb(jsetup(8).powers_g1[:4], coeffs)
    assert tb.g1_msm(tsetup(8), coeffs) == want
    assert tb.g1_msm(tsetup(8), [0, 0]) is None
    with pytest.raises(ValueError):
        tb.g1_msm(tsetup(8), list(range(9)))
