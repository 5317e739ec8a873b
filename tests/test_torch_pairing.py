"""The port's pairing (``pos_evolution_tpu_torch/ops/pairing.py``) on the
CPU: the Miller loop and final exponentiation against the oracle's
pairing cubed (the x-chain hard part gives e(P, Q)^3), with infinity
masks and bilinearity; G1 Jacobian aggregation against oracle sums; and
``fast_aggregate_verify_batch`` against ``PyBLS.FastAggregateVerify``.

The slow tier holds the same functions equal, digit for digit, to the JAX
package's ``miller_loop``, ``final_exponentiation`` and
``fast_aggregate_verify_batch`` on the same inputs (XLA:CPU compiles of
the JAX pairing take minutes, as its own slow tests do)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.crypto.bls12_381 import PyBLS  # noqa: E402
from pos_evolution_tpu.ops import pairing as jp  # noqa: E402
from pos_evolution_tpu_torch import convert  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as o  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, kernels, tower  # noqa: E402
from pos_evolution_tpu_torch.ops import pairing as tp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P1 = o.ec_mul(o.G1_GEN, 5)
Q1 = o.ec_mul(o.G2_GEN, 7)


def _g1(points):
    return torch.from_numpy(np.stack([tp.g1_affine_encode(p) for p in points]))


def _g2(points):
    return torch.from_numpy(np.stack([tp.g2_affine_encode(q) for q in points]))


def _jac(points):
    """Oracle affine G1 points (None = infinity) -> Jacobian [n, 3, 32]."""
    out = np.zeros((len(points), 3, fp.L), np.int32)
    for i, p in enumerate(points):
        if p is not None:
            out[i, :2] = tp.g1_affine_encode(p)
            out[i, 2] = fp.ONE
    return torch.from_numpy(out)


def _affine(jac, i):
    """Jacobian row i -> oracle affine point (None at infinity)."""
    x, y, z = (fp.from_limbs(jac[i, k]) % o.Q for k in range(3))
    if z == 0:
        return None
    zi = pow(z, o.Q - 2, o.Q)
    return (x * zi * zi % o.Q, y * zi * zi * zi % o.Q)


@pytest.fixture(scope="module")
def pairings():
    """One batched pairing over (P, Q), (2P, Q), (P, 2Q), (P, Q) masked to
    infinity, and its Miller values."""
    with torch.inference_mode():
        p = _g1([P1, o.ec_mul(P1, 2), P1, P1])
        q = _g2([Q1, Q1, o.ec_mul(Q1, 2), Q1])
        inf = torch.tensor([False, False, False, True])
        before = dict(kernels.launches)
        f = tp.miller_loop(p, q, inf)
        e = tp.final_exponentiation(f)
        assert kernels.launches == before             # the CPU takes the plain versions
        return p, q, inf, f, e


def test_pairing_matches_oracle_cubed(pairings):
    *_, f, e = pairings
    assert f.shape == (4, 12, fp.L) and e.dtype == torch.int32
    want = o.pairing(P1, Q1)
    assert tower.fq12_decode(e, 0) == want * want * want
    assert tower.fq12_decode(f, 3) == o.FQ12_ONE and tower.fq12_decode(e, 3) == o.FQ12_ONE


def test_bilinearity(pairings):
    *_, e = pairings
    e1, e2, e3 = (tower.fq12_decode(e, i) for i in range(3))
    assert e2 == e3 == e1 * e1
    assert e1 != o.FQ12_ONE


def test_g1_add_cases_match_oracle():
    """General add, P == Q (doubling), P == -Q (infinity), either operand
    at infinity."""
    a, b = P1, o.ec_mul(o.G1_GEN, 11)
    lhs = [a, a, a, None, a, None]
    rhs = [b, a, o.ec_neg(a), b, None, None]
    got = tp.g1_add_jac(_jac(lhs), _jac(rhs))
    for i, (x, y) in enumerate(zip(lhs, rhs)):
        assert _affine(got, i) == o.ec_add(x, y), i
    dbl = tp.g1_double_jac(_jac([a]))
    assert _affine(dbl, 0) == o.ec_double(a)


def test_g1_sum_masked_and_affine():
    pts = [o.ec_mul(o.G1_GEN, k) for k in (3, 5, 7)]
    mask = torch.tensor([[True, True, True], [True, False, True], [False, False, False],
                         [False, True, False]])
    agg = tp.g1_sum_masked(_g1(pts).expand(4, 3, 2, fp.L), mask)
    aff, inf = tp.g1_to_affine(agg)
    for i, row in enumerate(mask.tolist()):
        want = None
        for p, m in zip(pts, row):
            if m:
                want = o.ec_add(want, p)
        assert _affine(agg, i) == want
        assert bool(inf[i]) == (want is None)
        if want is not None:
            assert (fp.from_limbs(aff[i, 0]) % o.Q, fp.from_limbs(aff[i, 1]) % o.Q) == want


def _favb_case():
    """B = 4 aggregates of C = 3 over 4 keys: valid, a signature over
    another message, an empty bitlist, and a signature at infinity."""
    sks = [11, 22, 33, 44]
    pk_bytes = [PyBLS.SkToPk(sk) for sk in sks]
    pk_table = np.stack([tp.g1_affine_encode(o.g1_decompress(b)) for b in pk_bytes])
    msgs = [b"attestation-%d" % i for i in range(4)]
    committees = np.array([[0, 1, 2], [1, 2, 3], [0, 2, 3], [3, 0, 1]], dtype=np.int32)
    bits = np.array([[True, True, True], [True, False, True], [False, False, False],
                     [True, True, False]])
    sigs = [PyBLS.Aggregate([PyBLS.Sign(sks[0], msgs[0]), PyBLS.Sign(sks[1], msgs[0]),
                             PyBLS.Sign(sks[2], msgs[0])]),
            PyBLS.Aggregate([PyBLS.Sign(sks[1], msgs[2]), PyBLS.Sign(sks[3], msgs[2])]),
            PyBLS.Sign(sks[0], msgs[2]),
            o.g2_compress(None)]
    sig_pts = [o.g2_decompress(s) for s in sigs]
    msg_g2 = np.stack([tp.g2_affine_encode(o.hash_to_g2(m)) for m in msgs])
    sig_g2 = np.stack([tp.g2_affine_encode(s) for s in sig_pts])
    sig_inf = np.array([s is None for s in sig_pts])
    want = [PyBLS.FastAggregateVerify([pk_bytes[v] for v, b in zip(committees[i], bits[i]) if b],
                                      msgs[i], sigs[i]) for i in range(4)]
    assert want == [True, False, False, False]
    return (pk_table, committees, bits, msg_g2, sig_g2, sig_inf), want


@pytest.fixture(scope="module")
def favb():
    args, want = _favb_case()
    with torch.inference_mode():
        stages = {}
        got = tp.fast_aggregate_verify_batch(
            convert.limbs_to_torch(args[0], "cpu"), *(torch.from_numpy(a) for a in args[1:3]),
            *(convert.limbs_to_torch(a, "cpu") for a in args[3:5]), torch.from_numpy(args[5]),
            stages=stages)
    return args, want, got, stages


def test_fast_aggregate_verify_matches_pybls(favb):
    _, want, got, stages = favb
    assert got.dtype == torch.bool and got.tolist() == want
    assert set(stages) == {"agg", "pk_aff", "miller", "final"}
    assert stages["miller"].shape == (8, 12, fp.L)


def test_fast_aggregate_verify_requires_1d_batch():
    t = torch.zeros((1, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D batch"):
        tp.fast_aggregate_verify_batch(torch.zeros((4, 2, fp.L), dtype=torch.int32), t,
                                       t.bool(), None, None, None)


def test_encoders_equal_jax():
    for p in (P1, None):
        np.testing.assert_array_equal(tp.g1_affine_encode(p), jp.g1_affine_encode(p))
    for q in (Q1, None):
        np.testing.assert_array_equal(tp.g2_affine_encode(q), jp.g2_affine_encode(q))
    for name in ("_LOOP_BITS", "_X_BITS", "_XP1_BITS"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp.LINE_SLOTS == jp.LINE_SLOTS


# --- slow tier: digit for digit against the JAX package's pairing -------------------

@pytest.mark.slow
def test_miller_and_final_exp_equal_jax(pairings):
    p, q, inf, f, e = pairings
    jf = jp.miller_loop(jnp.asarray(p.numpy()), jnp.asarray(q.numpy()), jnp.asarray(inf.numpy()))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(e.numpy(), np.asarray(jp.final_exponentiation(jf)))


@pytest.mark.slow
def test_fast_aggregate_verify_equals_jax(favb):
    args, want, got, _ = favb
    jgot = jp.fast_aggregate_verify_batch(*(jnp.asarray(a) for a in args))
    assert np.asarray(jgot).tolist() == got.tolist() == want
