"""The port's verify preamble (``pos_evolution_tpu_torch/ops/g2prep.py``)
on the CPU: G1 and G2 decompression against the oracle (an invalid x
flagged), the host unpack and candidate scan against the JAX package's
functions, the per-element scalar ladder against ``ec_mul``, and
``hash_to_g2_finish`` against ``oracle.hash_to_g2``. The slow tier holds
``hash_to_g2_finish`` equal, digit for digit, to the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import g2prep as jg  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as o  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, kernels  # noqa: E402
from pos_evolution_tpu_torch.ops import g2prep as gp  # noqa: E402
from pos_evolution_tpu_torch.ops.pairing import g2_affine_encode  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESSAGES = [b"", b"attestation-7"]


def _no_sqrt_x(curve_rhs, start):
    """The first x >= start with no point on the curve (rhs a non-square)."""
    x = start
    while curve_rhs(x) is not None:
        x += 1
    return x


def _g1_rhs_root(x):
    y2 = (pow(x, 3, o.Q) + 4) % o.Q
    y = pow(y2, (o.Q + 1) // 4, o.Q)
    return y if y * y % o.Q == y2 else None


def test_g1_decompress_matches_oracle():
    pts = [o.ec_mul(o.G1_GEN, k) for k in (1, 2, 12345, 2**61 + 3)]
    comp = [o.g1_compress(p) for p in pts]
    bad_x = _no_sqrt_x(_g1_rhs_root, 5)
    xs = np.stack([fp.to_limbs(int.from_bytes(c, "big") & ((1 << 381) - 1)) for c in comp]
                  + [fp.to_limbs(bad_x)])
    signs = np.array([bool(int.from_bytes(c, "big") & (1 << 381)) for c in comp] + [False])
    before = dict(kernels.launches)
    aff, ok = gp.g1_decompress_batch(torch.from_numpy(xs), torch.from_numpy(signs))
    assert kernels.launches == before
    assert ok.tolist() == [True] * 4 + [False]
    for i, c in enumerate(comp):
        x, y = o.g1_decompress(c)
        assert fp.from_limbs(aff[i, 0]) == x and fp.from_limbs(aff[i, 1]) == y


def test_g2_decompress_matches_oracle():
    pts = [o.ec_mul(o.G2_GEN, k) for k in (1, 5, 2**62 - 7)]
    rows = np.stack([np.frombuffer(o.g2_compress(p), np.uint8) for p in pts])
    xl, sg, inf, bad = gp.g2_compressed_to_limbs(rows)
    assert not inf.any() and not bad.any()
    xb = _no_sqrt_x(lambda v: o.fq2_sqrt(o.Fq2(3, v).sq() * o.Fq2(3, v) + o.Fq2(4, 4)), 1)
    xl = np.concatenate([xl, np.stack([fp.to_limbs(3), fp.to_limbs(xb)])[None]])
    sg = np.concatenate([sg, [False]])
    aff, ok = gp.g2_decompress_batch(torch.from_numpy(xl), torch.from_numpy(sg))
    assert ok.tolist() == [True] * 3 + [False]
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(aff[i].numpy(), g2_affine_encode(o.g2_decompress(r.tobytes())))


def test_sign_helpers_match_oracle():
    rng = np.random.default_rng(3)
    ys = [0, 1, (o.Q - 1) // 2, (o.Q + 1) // 2, o.Q - 1] + \
        [int.from_bytes(rng.bytes(48), "big") % o.Q for _ in range(6)]
    t = torch.from_numpy(np.stack([fp.to_limbs(y) for y in ys]))
    assert gp.fp_y_is_large(t).tolist() == [o._y_is_large(y) for y in ys]
    assert gp.fp_is_odd(t).tolist() == [bool(y & 1) for y in ys]
    pairs = [(ys[i], ys[-1 - i]) for i in range(len(ys))] + [(5, 0), (0, 5)]
    t2 = torch.from_numpy(np.stack([np.stack([fp.to_limbs(a), fp.to_limbs(b)]) for a, b in pairs]))
    want = [(b, a) > ((o.Q - b) % o.Q, (o.Q - a) % o.Q) for a, b in pairs]
    assert gp.fq2_y_is_large(t2).tolist() == want


def test_host_functions_equal_jax():
    rows = [np.frombuffer(o.g2_compress(o.ec_mul(o.G2_GEN, k)), np.uint8) for k in (3, 9)]
    junk = np.zeros(96, np.uint8)
    junk[0] = 0x60                                        # inf + sign, no compression
    inf_row = np.frombuffer(o.g2_compress(None), np.uint8)
    noncanon = rows[0].copy()
    noncanon[48:] = np.frombuffer((o.Q + 1).to_bytes(48, "big"), np.uint8)
    data = np.stack(rows + [junk, inf_row, noncanon])
    for got, want in zip(gp.g2_compressed_to_limbs(data), jg.g2_compressed_to_limbs(data)):
        np.testing.assert_array_equal(got, want)
    msgs = MESSAGES + [bytes(range(32)), b"\xff" * 32]
    for got, want in zip(gp.hash_to_g2_candidates(msgs), jg.hash_to_g2_candidates(msgs)):
        np.testing.assert_array_equal(got, want)
    for name in ("_SQRT_FQ_BITS", "_SQRT_FQ2_BITS", "_COFACTOR_BITS", "_HALF_Q",
                 "_EIGHTH_ROOTS", "_FQ2_B"):
        np.testing.assert_array_equal(getattr(gp, name), np.asarray(getattr(jg, name)))


def test_scalar_batch_matches_ec_mul():
    """Data bits, MSB first, a zero scalar giving infinity."""
    base = o.ec_mul(o.G2_GEN, 3)
    scalars = [0b101100111011, 1, 0, 0b111111111111]
    bits = torch.tensor([[(s >> (11 - j)) & 1 for j in range(12)] for s in scalars], dtype=torch.bool)
    q = torch.from_numpy(np.stack([g2_affine_encode(base)] * 4))
    aff, inf = gp.g2_jac_to_affine(gp.g2_mul_scalar_batch(q, bits))
    assert inf.tolist() == [False, False, True, False]
    for i, s in enumerate(scalars):
        if s:
            np.testing.assert_array_equal(aff[i].numpy(), g2_affine_encode(o.ec_mul(base, s)))


def test_g2_add_cancellation_and_infinity():
    p = o.ec_mul(o.G2_GEN, 4)
    pj = gp.g2_affine_to_jac(torch.from_numpy(np.stack([g2_affine_encode(p)] * 3)))
    neg = gp.g2_affine_to_jac(torch.from_numpy(np.stack([g2_affine_encode(o.ec_neg_g2(p))] * 3)))
    zero = torch.zeros_like(pj)
    out = gp.g2_add_jac(torch.stack([pj[0], pj[1], zero[2]]), torch.stack([neg[0], zero[1], pj[2]]))
    aff, inf = gp.g2_jac_to_affine(out)
    assert inf.tolist() == [True, False, False]
    for i in (1, 2):
        np.testing.assert_array_equal(aff[i].numpy(), g2_affine_encode(p))


@pytest.fixture(scope="module")
def finished():
    x, picks = gp.hash_to_g2_candidates(MESSAGES)
    with torch.inference_mode():
        aff, ok = gp.hash_to_g2_finish(torch.from_numpy(x))
    return x, aff, ok


def test_hash_to_g2_finish_matches_oracle(finished):
    _, aff, ok = finished
    assert ok.tolist() == [True, True]
    for i, m in enumerate(MESSAGES):
        np.testing.assert_array_equal(aff[i].numpy(), g2_affine_encode(o.hash_to_g2(m)))


def test_oracle_patch_counts_and_replaces_rows(finished, monkeypatch):
    """Rows whose cofactor clearing lands at infinity take the oracle's
    map; the count is reported, the other rows stay."""
    _, aff, ok = finished
    flagged = torch.tensor([True, False])
    patched, n = gp.oracle_patch(torch.zeros_like(aff), flagged, MESSAGES)
    assert n == 1 and not patched[0].any()
    np.testing.assert_array_equal(patched[1].numpy(), g2_affine_encode(o.hash_to_g2(MESSAGES[1])))
    assert gp.oracle_patch(aff, ok, MESSAGES)[1] == 0
    monkeypatch.setattr(gp, "hash_to_g2_finish", lambda x: (aff, flagged))
    np.testing.assert_array_equal(gp.hash_to_g2_batch(MESSAGES, "cpu").numpy(), aff.numpy())


@pytest.mark.slow
def test_hash_to_g2_finish_equals_jax(finished):
    x, aff, ok = finished
    jaff, jok = jg.hash_to_g2_finish(jnp.asarray(x))
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    assert np.asarray(jok).tolist() == ok.tolist()
