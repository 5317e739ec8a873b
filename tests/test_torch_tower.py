"""The port's extension tower (``pos_evolution_tpu_torch/ops/tower.py``):
``alg_mul`` (the plain version of kernel K5) against the JAX package's
jitted ``tower.alg_mul`` digit for digit, its structure tensors and plans
equal to JAX's, and the other Fq2/Fq6/Fq12 ops, the Frobenius maps, the
cyclotomic squaring and short pow ladders against the port's copy of the
exact oracle (equal to the original, ``test_torch_fp.py``). On the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import tower as jt  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as o  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, kernels, tower  # noqa: E402
from pos_evolution_tpu_torch.ops.pairing import LINE_SLOTS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q = o.Q


def _vals(rng, n, top=2 * Q):
    return [int.from_bytes(rng.bytes(49), "big") % top for _ in range(n)]


def _elems(seed, shape, top=2 * Q):
    """int32 digits [*shape, 32] of seeded values in [0, top)."""
    rng = np.random.default_rng(seed)
    vals = _vals(rng, int(np.prod(shape)), top)
    return np.stack([fp.to_limbs(v) for v in vals]).reshape(*shape, fp.L)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fq12(seed):
    rng = np.random.default_rng(seed)
    c = _vals(rng, 12, Q)
    f2 = [o.Fq2(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return o.Fq12(o.Fq6(*f2[:3]), o.Fq6(*f2[3:]))


def _fq2(seed):
    rng = np.random.default_rng(seed)
    a, b = _vals(rng, 2, Q)
    return o.Fq2(a, b)


def _enc12(xs):
    return _t(np.stack([tower.fq12_encode(x) for x in xs]))


def test_structure_tensors_and_plans_equal():
    for d in (2, 6, 12):
        np.testing.assert_array_equal(getattr(tower, f"_T{d}"), getattr(jt, f"_T{d}"))
    for d, slots in ((2, None), (6, None), (12, None), (12, LINE_SLOTS)):
        tpos, tneg, offset, m = tower._plan(d, slots)
        jpos, jneg, joff = jt._plan(d, slots)
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(tneg, jneg)
        np.testing.assert_array_equal(offset, joff)
        assert fp.from_limbs(offset) == m * Q
    np.testing.assert_array_equal(tower._G1C, np.asarray(jt._G1C))
    np.testing.assert_array_equal(tower._G2C, np.asarray(jt._G2C))


@pytest.mark.parametrize("d,slots", [(2, None), (6, None), (12, None), (12, LINE_SLOTS)])
def test_alg_mul_matches_jax(d, slots):
    dy = d if slots is None else len(slots)
    x, y = _elems(d, (5, d)), _elems(d + 100, (5, dy))
    x[0] = fp.to_limbs(2 * Q - 1)                 # the widest lazy operands
    y[0] = fp.to_limbs(2 * Q - 1)
    x[1] = 0
    before = dict(kernels.launches)
    got = tower.alg_mul(_t(x), _t(y), slots)
    assert kernels.launches == before
    want = jax.jit(lambda a, b: jt.alg_mul(a, b, slots))(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a broadcast right operand (a gamma constant, an eighth root)
    got_b = tower.alg_mul(_t(x), _t(y[2]).expand(5, dy, fp.L), slots)
    np.testing.assert_array_equal(got_b.numpy(), tower.alg_mul(
        _t(x), _t(np.broadcast_to(y[2], y.shape)), slots).numpy())


def test_alg_mul_rejects_bad_shapes():
    x = _t(_elems(1, (2, 12)))
    with pytest.raises(ValueError, match="alg_mul"):
        tower.alg_mul(x, x[:, :6])
    with pytest.raises(ValueError, match="alg_mul"):
        tower.alg_mul(x[:, :4], x[:, :4])


def test_fq2_ops_match_oracle():
    xs = [_fq2(s) for s in range(4)] + [o.Fq2(0, 0), o.Fq2(1, 0)]
    ys = [_fq2(s + 10) for s in range(4)] + [_fq2(20), _fq2(21)]
    X = _t(np.stack([tower.fq2_encode(x) for x in xs]))
    Y = _t(np.stack([tower.fq2_encode(y) for y in ys]))
    mul, sq = tower.fq2_mul(X, Y), tower.fq2_sq(X)
    conj, xi, inv = tower.fq2_conj(X), tower.fq2_mul_xi(X), tower.fq2_inv(X)
    m5, m8 = tower.fq2_muli(X, 5), tower.fq2_muli(X, 8)
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert tower.fq2_decode(mul, i) == x * y
        assert tower.fq2_decode(sq, i) == x.sq()
        assert tower.fq2_decode(conj, i) == x.conj()
        assert tower.fq2_decode(xi, i) == x * o.XI
        assert tower.fq2_decode(inv, i) == (x.inv() if not x.is_zero() else o.Fq2(0))
        assert tower.fq2_decode(m5, i) == x * 5 and tower.fq2_decode(m8, i) == x * 8
    assert not tower.fq2_muli(X, 0).any()


def test_fq6_fq12_ops_match_oracle():
    xs, ys = [_fq12(1), _fq12(2)], [_fq12(3), o.FQ12_ONE]
    X, Y = _enc12(xs), _enc12(ys)
    a6 = X[:, 0:6]
    mul, sq, conj, inv = tower.fq12_mul(X, Y), tower.fq12_sq(X), tower.fq12_conj(X), \
        tower.fq12_inv(X)
    v6, inv6 = tower.fq6_mul_v(a6), tower.fq6_inv(a6)
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert tower.fq12_decode(mul, i) == x * y
        assert tower.fq12_decode(sq, i) == x * x
        assert tower.fq12_decode(conj, i) == x.conj()
        assert tower.fq12_decode(inv, i) == x.inv()
        assert tower.fq6_decode(v6, i) == x.a.mul_by_v()
        assert tower.fq6_decode(inv6, i) == x.a.inv()
    assert tower.fq12_decode(tower.alg_one(12, (1,)), 0) == o.FQ12_ONE
    assert tower.alg_is_zero(tower.alg_zero(12, (2,))).all()
    assert tower.alg_eq(X, _t(np.stack([tower.fq12_encode(x) for x in xs]))).all()
    e = tower.embed(X[:, [0, 1, 8]], 12, (0, 1, 8))
    assert torch.equal(e[:, [0, 1, 8]], X[:, [0, 1, 8]]) and not e[:, 2:8].any()


def test_frobenius_matches_oracle():
    x = _fq12(5)
    X = _enc12([x])
    assert tower.fq12_decode(tower.fq12_frob1(X), 0) == x.pow(Q)
    assert tower.fq12_decode(tower.fq12_frob2(X), 0) == x.pow(Q * Q)


def test_cyclotomic_sq_and_pow_ladders():
    """In the cyclotomic subgroup (an easy-part output) Granger-Scott
    squaring equals the dense square; short static ladders equal pow."""
    x = _fq12(6)
    f1 = x.conj() * x.inv()
    f2 = f1.pow(Q * Q) * f1                         # in the cyclotomic subgroup
    F2 = _enc12([f2, o.FQ12_ONE])
    cyc = tower.fq12_cyclotomic_sq(F2)
    assert tower.fq12_decode(cyc, 0) == f2 * f2
    assert tower.fq12_decode(cyc, 1) == o.FQ12_ONE
    bits = np.array([b == "1" for b in bin(0b1011001)[2:]])
    assert tower.fq12_decode(tower.fq12_pow_bits_cyclotomic(F2, bits), 0) == f2.pow(0b1011001)
    X = _enc12([x])
    assert tower.fq12_decode(tower.fq12_pow_bits(X, bits), 0) == x.pow(0b1011001)


def test_codecs_roundtrip():
    x = _fq12(7)
    enc = tower.fq12_encode(x)
    np.testing.assert_array_equal(enc, jt.fq12_encode(x))
    assert tower.fq12_decode(enc) == x == tower.fq12_decode(_t(enc))
    assert tower.fq6_decode(tower.fq6_encode(x.b)) == x.b
    assert tower.fq2_decode(tower.fq2_encode(x.a.c)) == x.a.c
