"""K11's bucket route on the CPU: the plain version of
``ops/pairing.g1_msm_fixed`` (the signed-window bucket MSM over a setup's
window tables) against the old plain ladder and fold, the port's host
Pippenger and the JAX package's, at small sizes. K10's passes are in
``tests/test_torch_k10.py``."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.kzg import curve as jcurve  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as oracle  # noqa: E402
from pos_evolution_tpu_torch.kzg import curve, fr  # noqa: E402
from pos_evolution_tpu_torch.kzg import setup as tsetup  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, pairing  # noqa: E402

R = fr.MODULUS
CSRC = Path(__file__).resolve().parents[1] / "pos_evolution_tpu_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain field op is hundreds of small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket_case(n: int, c: int, seed: int):
    """(points, inf, the oracle points, 2 blobs of scalars) of n lanes with
    the edges: a zero scalar, 1, r - 1, an infinity point, lanes 0 and 2 the
    same point and scalar (P = Q in every bucket they share), lanes 1 and 3 s
    and r - s on one point (P = -Q); point 5 = 2^c point 4, lane 4's window-1
    digit equal to lane 5's window-0 digit (one power's table entry meets
    another's in one bucket: P = Q from two windows) and, in blob 1, its
    negation (P = -Q from two windows)."""
    rng = np.random.default_rng(seed)
    base = [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    pts = [base[j % 8] for j in range(n)]
    blobs = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)] for _ in range(2)]
    if n >= 4:
        pts[2], pts[3] = pts[0], pts[1]
        blobs[0][2] = blobs[0][0]
        blobs[0][1], blobs[0][3] = 777, R - 777
        blobs[1][1], blobs[1][2], blobs[1][3] = 0, 1, R - 1
    if n >= 64:
        pts[40] = None
        pts[5] = oracle.ec_mul(pts[4], 1 << c)
        d = 3
        blobs[0][4] = d << c                         # window 1: d; window 0: 0
        blobs[0][5] = d                              # window 0: d
        blobs[1][4] = d << c
        blobs[1][5] = (1 << c) - d                   # window 0: -d (and a carry of 1)
    enc, inf = pairing.g1_encode_points(pts)
    return enc, inf, pts, blobs


def _scalars(blobs):
    return torch.stack([fr.ints_to_digits(s) for s in blobs])


def _raw_digits(vals):
    """[n, 22] digits of ints below 2^256, not reduced mod r."""
    return torch.from_numpy(np.stack([fr.to_limbs(v) for v in vals]).astype(np.int32))


@pytest.mark.parametrize("n", [1, 4, 64, 200])
def test_bucket_msm_equals_the_ladder_and_both_pippengers(n):
    """The bucket route's plain version (c = 5) equals the old plain ladder
    and fold's affine sums, the port's host Pippenger and the JAX
    package's, on every edge case."""
    c = 5
    enc, inf, pts, blobs = _bucket_case(n, c, 70 + n)
    scs = _scalars(blobs)
    tables = pairing.g1_window_tables(enc, inf, c)
    got = pairing.g1_decode_points(*pairing.g1_msm_fixed(tables, scs))
    ladder = pairing.g1_decode_points(*pairing.g1_msm(enc, inf, scs))
    assert got == ladder
    assert got == [curve.g1_lincomb(pts, s) for s in blobs]
    assert got == [jcurve.g1_lincomb(pts, s) for s in blobs]


def test_bucket_msm_at_the_kernels_window():
    """One case at the kernel route's own window (c = 13, W = 20, 4,096
    buckets a blob) against the host Pippenger and the ladder."""
    c = pairing.MSM_WINDOW
    enc, inf, pts, blobs = _bucket_case(64, c, 9)
    scs = _scalars(blobs)
    tables = pairing.g1_window_tables(enc, inf, c)
    stages = {}
    got = pairing.g1_decode_points(*pairing.g1_msm_fixed(tables, scs, stages=stages))
    assert got == [curve.g1_lincomb(pts, s) for s in blobs]
    assert stages["totals"].shape == (2, 1 << (c - 1), 3, fp.L)


def _doubling_case():
    """128 lanes of one point: blob 0 every scalar 1 (bucket 1 holds 128
    equal entries, so the fill's chunks of 32 give equal runs that the totals
    add: P = Q), blob 1 scalars 1 and 2 on two lanes (buckets 1 and 2 hold
    the same point, siblings in the reduce's tree: P = Q)."""
    p = oracle.ec_mul(oracle.G1_GEN, 12345)
    pts = [p] * 128
    blobs = [[1] * 128, [1, 2] + [0] * 126]
    enc, inf = pairing.g1_encode_points(pts)
    return enc, inf, pts, blobs


def test_bucket_adds_that_double():
    """The totals' and the tree's adds meet P = Q and double (U1, S1, Z1 Z2);
    the sums equal the oracle, and ``_g1_add_bucket_plain`` equals
    ``g1_add_jac`` wherever P != Q."""
    enc, inf, pts, blobs = _doubling_case()
    tables = pairing.g1_window_tables(enc, inf, 4)
    got = pairing.g1_decode_points(*pairing.g1_msm_fixed(tables, _scalars(blobs)))
    assert got == [curve.g1_lincomb(pts, s) for s in blobs]
    rng = np.random.default_rng(4)
    a = [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(3)]

    def jac(p, z):
        return np.stack([fp.to_limbs(v) for v in (p[0] * z * z % oracle.Q,
                                                   p[1] * z ** 3 % oracle.Q, z)])

    zero = np.zeros((3, fp.L), np.int32)
    neg = (a[1][0], oracle.Q - a[1][1])
    cases = [(jac(a[0], 5), jac(a[2], 7)), (jac(a[1], 3), jac(neg, 4)), (zero, jac(a[2], 2)),
             (jac(a[2], 2), zero), (zero, zero)]
    p = torch.from_numpy(np.stack([c[0] for c in cases]).astype(np.int32))
    q = torch.from_numpy(np.stack([c[1] for c in cases]).astype(np.int32))
    assert torch.equal(pairing._g1_add_bucket_plain(p, q), pairing.g1_add_jac(p, q))
    same = torch.from_numpy(np.stack([jac(a[0], 3), jac(a[0], 9)]).astype(np.int32))
    dbl = pairing._g1_add_bucket_plain(same[:1], same[1:])
    aff, is_inf = pairing.g1_to_affine(dbl)
    assert pairing.g1_decode_points(fp.canon(aff), is_inf) == [oracle.ec_mul(a[0], 2)]


@pytest.mark.parametrize("c", [2, 4, 5, 8, 13, 15, 16])
def test_recode_rebuilds_every_scalar(c):
    """sum_w d_w 2^(c w) rebuilds each scalar exactly, with every digit in
    [-2^(c-1), 2^(c-1)] and no carry left: 0, 1, r - 1, random scalars,
    those that carry through every window into the top one, and 256-bit
    values above r (lazy residues in [r, 2r), 2^256 - 1): c W > 256 leaves the
    top window room for any carry, also where c divides 256."""
    w = pairing.msm_windows(c)
    assert w * c > 256 and (w - 1) * c <= 256
    rng = np.random.default_rng(c)
    vals = [0, 1, R - 1, R - 2, (1 << (c * (w - 1))) - 1, (1 << 254) - 1,
            (1 << (c - 1)) + 1, ((1 << c) - 1) << c]
    vals = [v % R for v in vals] + [int.from_bytes(rng.bytes(32), "little") % R
                                    for _ in range(40)]
    vals += [R, 2 * R - 1, (1 << 256) - 1, (1 << 256) - (1 << (c - 1))]
    dig, cnt = pairing._recode_plain(_raw_digits(vals)[None], c)
    d = dig[0].numpy().astype(object)
    assert dig.shape == (1, w, len(vals))
    assert (np.abs(dig.numpy()) <= 1 << (c - 1)).all()
    assert [sum(int(d[k, j]) << (c * k) for k in range(w)) for j in range(len(vals))] == vals
    mags = np.abs(dig[0].numpy())
    want = np.stack([np.bincount(mags[k], minlength=(1 << (c - 1)) + 1)[1:] for k in range(w)])
    np.testing.assert_array_equal(cnt[0].numpy(), want)


def test_sort_is_stable_by_bucket_window_lane():
    """The entries sit in bucket order and, inside a bucket, in (window,
    lane) order, signs in bit 31; the starts and window offsets agree."""
    c, n_tab = 4, 12
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(2 * 10)]
    dig, cnt = pairing._recode_plain(fr.ints_to_digits(vals).reshape(2, 10, fr.L), c)
    start, offsets = pairing._scan_plain(cnt)
    ent = pairing._scatter_plain(dig, n_tab, 1 << (c - 1))
    w = pairing.msm_windows(c)
    for g in range(2):
        want = sorted((abs(int(dig[g, k, j])), k * n_tab + j, int(dig[g, k, j]) < 0)
                      for k in range(w) for j in range(10) if dig[g, k, j])
        e = ent[g, :len(want)].numpy().astype(np.int64)
        assert [(int(v) & 0x7FFFFFFF, int(v) < 0) for v in e] == [(k, s) for _, k, s in want]
        assert (ent[g, len(want):] == 0).all() and int(start[g, -1]) == len(want)
        for b in range(1, 1 << (c - 1)):
            assert int(start[g, b]) == sum(1 for m, _k, _s in want if m <= b)
        for k in range(w):
            for b in range(1 << (c - 1)):
                assert int(offsets[g, k, b]) == int(start[g, b]) + sum(
                    1 for m, key, _s in want if m == b + 1 and key // n_tab < k)


def test_chunks_split_runs_and_totals_join_them():
    """The fill's chunks of MSM_CHUNK sorted entries split the buckets that
    are longer (c = 4: ~500 entries a bucket) and start runs inside a chunk;
    the totals join the runs: each bucket's sum equals the host's sum of its
    entries +-T[w, j], and the reduce the host Pippenger's."""
    c, chunk = 4, pairing.MSM_CHUNK
    enc, inf, pts, blobs = _bucket_case(64, c, 12)
    tables = pairing.g1_window_tables(enc, inf, c)
    dig, cnt = pairing._recode_plain(_scalars(blobs), c)
    start, _off = pairing._scan_plain(cnt)
    ent = pairing._scatter_plain(dig, tables.n, tables.buckets)
    part, bsum = pairing._fill_plain(tables, ent, start)
    totals = pairing._totals_plain(part, bsum, start)
    st = start.numpy().astype(np.int64)
    assert ((st[:, 1:] - 1) // chunk > st[:, :-1] // chunk).any()
    assert (st[:, 1:-1] % chunk != 0).any()
    table_pts = pairing.g1_decode_points(tables.points.reshape(-1, 2, fp.L),
                                         tables.inf.reshape(-1))
    aff, is_inf = pairing.g1_to_affine(totals)
    for g in range(2):
        keys = [int(v) for v in ent[g].numpy()]
        want = [curve.g1_lincomb([table_pts[k & 0x7FFFFFFF] for k in keys[st[g, b]:st[g, b + 1]]],
                                 [R - 1 if k < 0 else 1 for k in keys[st[g, b]:st[g, b + 1]]])
                for b in range(tables.buckets)]
        assert pairing.g1_decode_points(fp.canon(aff[g]), is_inf[g]) == want
    total = pairing._reduce_plain(totals)
    aff, is_inf = pairing.g1_to_affine(total)
    assert pairing.g1_decode_points(fp.canon(aff), is_inf) == [
        curve.g1_lincomb(pts, s) for s in blobs]


def test_window_tables_of_the_setup_equal_the_oracle():
    """``device_setup(64, 0, "cpu").window_tables()``: every T[w, j] equals
    the oracle's 2^(c w) [tau^j]G, memoized with the setup."""
    setup = tsetup.device_setup(64, 0, "cpu")
    tables = setup.window_tables()
    c = tables.c
    assert c == tsetup.msm_window(64) and setup.window_tables() is tables
    jac = [curve.to_jac(p) for p in setup.powers_g1()]
    for w in range(pairing.msm_windows(c)):
        assert pairing.g1_decode_points(tables.points[w], tables.inf[w]) == \
            curve.batch_to_affine(jac), w
        for _ in range(c):
            jac = [curve.jac_double(p) for p in jac]


def test_kernel_constants_equal_python():
    """The totals launch's subtree (csrc/g1_bucket.cuh's kSubMax) is
    ``pairing.MSM_SUBTREE``, which sizes its output; the fill's chunk
    (kChunk) is ``pairing.MSM_CHUNK``, the plain versions'; the recode's and
    the scatter's windows are ``msm_windows``'."""
    head = (CSRC / "g1_bucket.cuh").read_text()
    assert int(re.search(r"kSubMax = (\d+)", head).group(1)) == pairing.MSM_SUBTREE
    assert int(re.search(r"kChunk = (\d+)", head).group(1)) == pairing.MSM_CHUNK
    cu = (CSRC / "g1_bucket.cu").read_text()
    assert cu.count("256 / c + 1") == 2 and "(256 + c - 1) / c" not in cu
    assert all(pairing.msm_windows(c) == 256 // c + 1 for c in range(2, 17))


def test_bucket_route_refuses_bad_operands():
    c = 4
    enc, inf, _pts, blobs = _bucket_case(4, c, 1)
    tables = pairing.g1_window_tables(enc, inf, c)
    with pytest.raises(ValueError, match="scalars must be"):
        pairing.g1_msm_fixed(tables, _scalars(blobs)[..., :20])
    with pytest.raises(ValueError, match="scalars must be"):
        pairing.g1_msm_fixed(tables, torch.cat([_scalars(blobs)] * 2, dim=1))
    with pytest.raises(ValueError, match="window tables"):
        pairing.WindowTables(c, tables.points[1:], tables.inf[1:])
    with pytest.raises(ValueError, match="scalars on"):
        pairing.g1_msm_fixed(tables, _scalars(blobs).to("meta"))


@pytest.mark.parametrize("c", [4, 8])
def test_bucket_msm_takes_lazy_scalars(c):
    """Scalars in [r, 2^256) (lazy residues, where c divides 256 too) give
    the sum of their residues mod r: the top window takes every carry."""
    enc, inf, pts, blobs = _bucket_case(4, c, 5)
    tables = pairing.g1_window_tables(enc, inf, c)
    lazy = [[v + R for v in blobs[0]], [(1 << 256) - 1 - v for v in blobs[1]]]
    scs = torch.stack([_raw_digits(s) for s in lazy])
    got = pairing.g1_decode_points(*pairing.g1_msm_fixed(tables, scs))
    assert got == [curve.g1_lincomb(pts, [v % R for v in s]) for s in lazy]
