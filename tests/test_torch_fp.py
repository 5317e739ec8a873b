"""The port's base field (``pos_evolution_tpu_torch/ops/fp.py``) against the
JAX package's jitted ``ops/fp.py``, digit for digit (lazy residues
included, tolerance 0), and the port's copy of the BLS12-381 oracle
against the original. The port runs on the CPU, through the plain
versions of kernels K3 and K4."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.crypto import bls12_381 as jo  # noqa: E402
from pos_evolution_tpu.ops import fp as jfp  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as to  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, kernels  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain field ops are thousands of tiny tensor ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q = jo.Q
CSRC = Path(__file__).resolve().parents[1] / "pos_evolution_tpu_torch" / "csrc"
# 0, 1, p-1, p, 2p-1, a long FFF ripple, and operands whose product nears 4p^2
EDGES = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1, 2 * Q - 2, (1 << 372) - 1,
         ((1 << 384) - 1) % (2 * Q)]


def _limbs(vals, n=fp.L):
    return np.stack([fp.to_limbs(v, n) for v in vals])


def _residues(seed, n, top=2 * Q, edges=True):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(49), "big") % top for _ in range(n)]
    if edges:
        vals[:len(EDGES)] = EDGES[:n]
    return _limbs(vals)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def operands():
    a = _residues(1, 40)
    b = np.concatenate([_residues(2, 40)[::-1][:31], _limbs([2 * Q - 1] * 9)])
    return a, b


def test_constants_equal():
    for name in ("P", "TWO_P", "MU", "ZERO", "ONE"):
        _eq(getattr(fp, name), getattr(jfp, name))
    assert (fp.BITS, fp.MASK, fp.L, fp.CONV) == (jfp.BITS, jfp.MASK, jfp.L, jfp.CONV)
    _eq(fp._P_MINUS_2_BITS, jfp._P_MINUS_2_BITS)


def test_kernel_header_constants():
    """csrc/fp381.cuh's word constants are p, 2p and floor(2^768 / p)."""
    text = (CSRC / "fp381.cuh").read_text()
    for name, value, words in (("kP", Q, 12), ("kTwoP", 2 * Q, 12), ("kMu", 2**768 // Q, 13)):
        body = re.search(rf"{name}\[{words}\] = \{{([^}}]*)\}}", text).group(1)
        got = [int(w, 16) for w in re.findall(r"0x([0-9A-F]+)u", body)]
        assert got == [(value >> (32 * i)) & 0xFFFFFFFF for i in range(words)], name


def test_limb_codec():
    for v in EDGES:
        _eq(fp.to_limbs(v), jfp.to_limbs(v))
        assert fp.from_limbs(fp.to_limbs(v)) == v == fp.from_limbs(_t(fp.to_limbs(v)))
    assert fp.from_limbs(np.full(3, 2**20)) == jfp.from_limbs(np.full(3, 2**20))


@pytest.mark.parametrize("m,n", [(32, 32), (33, 33), (32, 33)])
def test_conv_digits(m, n):
    rng = np.random.default_rng(m * n)
    a = rng.integers(0, 4096, (5, m)).astype(np.int32)
    b = rng.integers(0, 4096, (5, n)).astype(np.int32)
    got = fp.conv_digits(_t(a), _t(b))
    _eq(got, jax.jit(jfp.conv_digits)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("length,out_len", [(32, 32), (33, 33), (63, 64), (65, 66)])
def test_carry_norm(length, out_len):
    """Digit sums up to 2^29 (the convolution bound), the top two digits
    small so the value fits, plus the all-FFF ripple."""
    rng = np.random.default_rng(length)
    x = rng.integers(0, 2**29, (6, length), dtype=np.int64).astype(np.int32)
    x[:, -2:] = rng.integers(0, 2**11, (6, 2))
    x[0] = fp.MASK
    x[0, 0] = fp.MASK + 1
    x[0, -1] = 0
    got = fp.carry_norm(_t(x), out_len)
    _eq(got, jax.jit(jfp.carry_norm, static_argnums=1)(jnp.asarray(x), out_len))
    assert all(fp.from_limbs(got[i]) == fp.from_limbs(x[i]) for i in range(6))


@pytest.mark.parametrize("n", [32, 33, 64])
def test_sub_digits_and_cond_sub(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 4096, (7, n)).astype(np.int32)
    y = rng.integers(0, 4096, (7, n)).astype(np.int32)
    y[0] = x[0]                                    # equal: no borrow
    y[1] = x[1]
    y[1, 0] = min(x[1, 0] + 1, 4095)               # borrow rippling up from digit 0
    d, uf = fp.sub_digits(_t(x), _t(y))
    jd, juf = jax.jit(jfp.sub_digits)(jnp.asarray(x), jnp.asarray(y))
    _eq(d, jd)
    _eq(uf, juf)
    _eq(fp.cond_sub(_t(x), _t(y[3])), jfp.cond_sub(jnp.asarray(x), y[3]))


def test_barrett_reduce():
    """64-digit values below p * 2^384, and a 33-digit tower sum."""
    rng = np.random.default_rng(9)
    vals = [int.from_bytes(rng.bytes(96), "big") % (Q << 384) for _ in range(8)]
    vals += [(2 * Q - 1) ** 2, Q * Q, 0, (Q << 384) - 1]
    x = _limbs(vals, 64)
    _eq(fp.barrett_reduce(_t(x)), jax.jit(jfp.barrett_reduce)(jnp.asarray(x)))
    y = _limbs([v % (1 << 396) for v in vals], 33)
    _eq(fp.barrett_reduce(_t(y)), jax.jit(jfp.barrett_reduce)(jnp.asarray(y)))


@pytest.mark.parametrize("op", ["modmul", "modadd", "modsub"])
def test_binary_ops(op, operands):
    a, b = operands
    before = dict(kernels.launches)
    got = getattr(fp, op)(_t(a), _t(b))
    assert kernels.launches == before               # the CPU takes the plain version
    _eq(got, getattr(jfp, op + "_jit")(jnp.asarray(a), jnp.asarray(b)))
    py = {"modmul": lambda x, y: x * y, "modadd": lambda x, y: x + y,
          "modsub": lambda x, y: x - y}[op]
    for i in range(len(a)):
        v = fp.from_limbs(got[i])
        assert 0 <= v < 2 * Q and v % Q == py(fp.from_limbs(a[i]), fp.from_limbs(b[i])) % Q


def test_any_canonical_digits():
    """Digit vectors of any 384-bit value, outside [0, 2p): the same digits
    as JAX all the same (the kernels' contract is the formula)."""
    a = _residues(3, 12, top=2**384)
    b = _residues(4, 12, top=2**384, edges=False)
    for op in ("modmul", "modadd", "modsub"):
        _eq(getattr(fp, op)(_t(a), _t(b)),
            getattr(jfp, op + "_jit")(jnp.asarray(a), jnp.asarray(b)))
    _eq(fp.canon(_t(a)), jax.jit(jfp.canon)(jnp.asarray(a)))


def test_broadcast_shapes():
    a = _residues(5, 12).reshape(4, 1, 3, fp.L)
    b = _residues(6, 6).reshape(1, 2, 3, fp.L)
    got = fp.modmul(_t(a), _t(b))
    assert got.shape == (4, 2, 3, fp.L)
    _eq(got, fp.modmul(_t(np.broadcast_to(a, (4, 2, 3, fp.L))),
                       _t(np.broadcast_to(b, (4, 2, 3, fp.L)))))
    _eq(got, jfp.modmul_jit(jnp.asarray(a), jnp.asarray(b)))
    _eq(fp.modsub(_t(a), _t(fp.ONE)), jfp.modsub_jit(jnp.asarray(a), jnp.asarray(fp.ONE)))


def test_unary_ops(operands):
    a, b = operands
    _eq(fp.modneg(_t(a)), jax.jit(jfp.modneg)(jnp.asarray(a)))
    _eq(fp.canon(_t(a)), jax.jit(jfp.canon)(jnp.asarray(a)))
    _eq(fp.eq(_t(a), _t(b)), jax.jit(jfp.eq)(jnp.asarray(a), jnp.asarray(b)))
    shifted = np.stack([fp.to_limbs((fp.from_limbs(v) + Q) % (2 * Q)) for v in a])
    assert bool(fp.eq(_t(a), _t(shifted)).all())         # x and x + p are one element
    _eq(fp.is_zero(_t(a)), jax.jit(jfp.is_zero)(jnp.asarray(a)))
    assert fp.is_zero(_t(a)).tolist()[:5] == [True, False, False, True, False]


def test_modinv():
    a = _residues(7, 4)
    got = fp.modinv(_t(a))
    _eq(got, jfp.modinv_jit(jnp.asarray(a)))
    for i in range(4):
        v = fp.from_limbs(a[i]) % Q
        assert fp.from_limbs(got[i]) % Q == (pow(v, Q - 2, Q) if v else 0)


def test_plain_mode_and_dispatch():
    a = _t(_residues(8, 3))
    assert not fp.use_kernel(a)
    with fp.plain_mode():
        assert not fp.use_kernel(a)
        with fp.plain_mode(False):
            assert not fp.use_kernel(a)            # CPU tensors never launch
    with pytest.raises(ValueError, match="digit axis"):
        fp.modmul(a[:, :16], a[:, :16])
    with pytest.raises(ValueError, match="no field kernels"):
        fp.use_kernel(a.to("meta"))


# --- the port's copy of the oracle ----------------------------------------------

def test_oracle_copy_constants():
    for name in ("Q", "R", "BLS_X", "G1_COFACTOR", "G2_COFACTOR", "G1_GEN", "_FINAL_EXP",
                 "_G2_DST"):
        assert getattr(to, name) == getattr(jo, name), name
    assert (to.G2_GEN[0].a, to.G2_GEN[0].b, to.G2_GEN[1].a, to.G2_GEN[1].b) == \
        (jo.G2_GEN[0].a, jo.G2_GEN[0].b, jo.G2_GEN[1].a, jo.G2_GEN[1].b)
    assert [(r.a, r.b) for r in to._EIGHTH_ROOTS] == [(r.a, r.b) for r in jo._EIGHTH_ROOTS]


def test_oracle_copy_points_and_hash():
    rng = np.random.default_rng(10)
    for k in [1, 2, int(rng.integers(2, 2**62)), jo.R - 1]:
        p1, q1 = to.ec_mul(to.G1_GEN, k), jo.ec_mul(jo.G1_GEN, k)
        assert p1 == q1
        assert to.g1_compress(p1) == jo.g1_compress(q1)
        assert to.g1_decompress(to.g1_compress(p1)) == jo.g1_decompress(jo.g1_compress(q1))
    for k in [3, int(rng.integers(2, 2**62))]:
        p2, q2 = to.ec_mul(to.G2_GEN, k), jo.ec_mul(jo.G2_GEN, k)
        assert to.g2_compress(p2) == jo.g2_compress(q2)
        x, y = to.g2_decompress(to.g2_compress(p2))
        jx, jy = jo.g2_decompress(jo.g2_compress(q2))
        assert (x.a, x.b, y.a, y.b) == (jx.a, jx.b, jy.a, jy.b)
    for m in (b"", bytes(rng.bytes(32))):
        assert to.g2_compress(to.hash_to_g2(m)) == jo.g2_compress(jo.hash_to_g2(m))
