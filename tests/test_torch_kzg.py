"""The port's KZG field, transform and group layers against the JAX package
on the CPU, at tolerance 0: the copied constants and host functions; Fr's
plain ops (kernel K10's elementwise entry) digit-equal to the JAX device
twin; the NTT (K10's stages) digit-equal to ``ntt_device`` and ``ntt_host``;
the G1 multi-scalar multiply (K11) equal to ``curve.g1_lincomb`` at the
fold's edge cases; the setup on the device equal to the host
``trusted_setup``; and the CUDA sources' constants equal to the Python
ones. Inputs come from numpy with a seed."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.kzg import aggregate as jagg  # noqa: E402
from pos_evolution_tpu.kzg import curve as jcurve  # noqa: E402
from pos_evolution_tpu.kzg import fr as jfr  # noqa: E402
from pos_evolution_tpu.kzg import ntt as jntt  # noqa: E402
from pos_evolution_tpu.kzg import setup as jsetup  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as oracle  # noqa: E402
from pos_evolution_tpu_torch.kzg import aggregate as tagg  # noqa: E402
from pos_evolution_tpu_torch.kzg import curve, fr, ntt  # noqa: E402
from pos_evolution_tpu_torch.kzg import setup as tsetup  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, pairing  # noqa: E402

R = fr.MODULUS
CSRC = Path(__file__).resolve().parents[1] / "pos_evolution_tpu_torch" / "csrc"
EDGES = [0, 1, R - 1, R, R + 1, 2 * R - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain field op is hundreds of small tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores. Module
    scope, so that it also wraps the module's fixtures, which run first."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_ints(rng, n, top=R):
    return [int.from_bytes(rng.bytes(40), "little") % top for _ in range(n)]


def _digits(vals) -> np.ndarray:
    return np.stack([jfr.to_limbs(v) for v in vals]).astype(np.int32)


# --- the copies -------------------------------------------------------------------

def test_copied_constants_equal_jax():
    for name in ("MODULUS", "BITS", "MASK", "L", "R_MONT", "_NPRIME", "_R2", "_EXP_BITS"):
        assert getattr(fr, name) == getattr(jfr, name), name
    for name in ("P", "TWO_P", "NP", "R2", "ZERO", "ONE_M"):
        np.testing.assert_array_equal(getattr(fr, name), getattr(jfr, name), err_msg=name)
    assert ntt.OMEGA_2_32 == jntt.OMEGA_2_32
    assert (tagg.PROOF_TAG, tagg._R) == (jagg.PROOF_TAG, jagg._R)


@pytest.mark.parametrize("pair", [
    (fr, jfr, ("to_limbs", "from_limbs", "to_mont_int", "from_mont_int", "_conv_np",
               "_carry_np", "_sub_np", "_cond_sub_np", "mont_mul", "mont_add", "mont_sub",
               "mont_neg", "mont_canon", "mont_pow", "batch_inv", "encode_int", "decode_int",
               "encode", "decode")),
    (ntt, jntt, ("root_of_unity", "domain", "_plan", "ntt_host")),
    (curve, jcurve, ("to_jac", "jac_double", "jac_add", "jac_mul", "jac_to_affine",
                     "batch_to_affine", "_msm")),
    (tagg, jagg, ("_transcript", "_challenge", "_rs", "_coset_geometry", "_interp_coeffs",
                  "_div_xm_z", "_poly_eval", "proof_n_bytes", "_decompress_checked")),
    (tsetup, jsetup, ("tau_from_seed",)),
], ids=["fr", "ntt", "curve", "aggregate", "setup"])
def test_copied_functions_equal_jax(pair):
    """The host functions copied from the JAX package are its source, line
    for line."""
    port, jax_mod, names = pair
    for name in names:
        assert inspect.getsource(getattr(port, name)) == \
            inspect.getsource(getattr(jax_mod, name)), name


def test_copied_functions_agree_with_jax():
    rng = np.random.default_rng(1)
    pts = jsetup.trusted_setup(8, 5).powers_g1
    scalars = _rand_ints(rng, 8)
    assert curve.g1_lincomb(pts, scalars) == jcurve.g1_lincomb(pts, scalars)
    assert tsetup.tau_from_seed(9) == jsetup.tau_from_seed(9)
    rev, tables, scale = ntt._plan(16, True)
    jrev, jtables, jscale = jntt._plan(16, True)
    np.testing.assert_array_equal(rev, jrev)
    np.testing.assert_array_equal(scale, jscale)
    for a, b in zip(tables, jtables, strict=True):
        np.testing.assert_array_equal(a, b)


def _c_words(text: str, name: str) -> int:
    """The value of a ``uint32_t name[] = {...}`` little-endian word table."""
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_cuda_constants_equal_python():
    """fr381.cuh's r, 2r, n' and fr_ntt.cu's Montgomery one and r - 2 are the
    Python constants."""
    cuh = (CSRC / "fr381.cuh").read_text()
    cu = (CSRC / "fr_ntt.cu").read_text()
    assert _c_words(cuh, "kR") == R
    assert _c_words(cuh, "kTwoR") == 2 * R
    assert _c_words(cuh, "kNp") == fr._NPRIME
    assert _c_words(cu, "kOneM") == fr.R_MONT % R == fr.from_limbs(fr.ONE_M)
    assert _c_words(cu, "kRMinus2") == R - 2


# --- Fr: the plain versions of K10's elementwise ops --------------------------------

@pytest.fixture(scope="module")
def jax_fr():
    return jfr.device_ops()


def test_fr_ops_equal_the_jax_device_twin(jax_fr):
    """mul, add, sub, canon (and neg) digit for digit on lazy residues and
    the edge values 0, 1, r - 1 and [r, 2r)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    xs = EDGES + _rand_ints(rng, 42, 2 * R)
    ys = EDGES[::-1] + _rand_ints(rng, 42, 2 * R)
    a, b = _digits(xs), _digits(ys)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, ours in (("mul", fr.mul), ("add", fr.add), ("sub", fr.sub)):
        np.testing.assert_array_equal(ours(ta, tb).numpy(), np.asarray(jax_fr[name](ja, jb)),
                                      err_msg=name)
    np.testing.assert_array_equal(fr.canon(ta).numpy(), np.asarray(jax_fr["canon"](ja)))
    zero = jnp.zeros_like(ja)
    np.testing.assert_array_equal(fr.neg(ta).numpy(), np.asarray(jax_fr["sub"](zero, ja)))
    np.testing.assert_array_equal(fr.neg(ta).numpy(), jfr.mont_neg(a))


def test_fr_inv_and_conversions(jax_fr):
    """inv equals the JAX device twin's ladder (0 -> 0); to_mont/from_mont
    are encode/decode."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    xs = [0, 1, R - 1] + _rand_ints(rng, 5)
    enc = jfr.encode(xs).astype(np.int32)
    got = fr.inv(torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fr["inv"](jnp.asarray(enc))))
    assert jfr.decode(got.numpy()) == [pow(x, R - 2, R) for x in xs]
    canon = fr.ints_to_digits(xs)
    np.testing.assert_array_equal(fr.to_mont(canon).numpy(), enc)
    assert fr.digits_to_ints(fr.from_mont(torch.from_numpy(enc))) == xs


# --- the NTT (K10's stages) ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 1), (2, 2), (2, 3, 8), (2, 128), (1, 1024)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_equals_the_numpy_oracle(shape, inverse):
    rng = np.random.default_rng(shape[-1] + inverse)
    x = _digits(_rand_ints(rng, int(np.prod(shape)), 2 * R)).reshape(shape + (fr.L,))
    got = ntt.ntt(torch.from_numpy(x), inverse)
    np.testing.assert_array_equal(got.numpy(), jntt.ntt_host(x, inverse))


@pytest.mark.parametrize("n", [8, 128])
def test_ntt_equals_the_jax_device_kernel(n):
    rng = np.random.default_rng(n)
    x = jfr.encode(_rand_ints(rng, 2 * n)).reshape(2, n, fr.L)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            ntt.intt(torch.from_numpy(x.astype(np.int32))).numpy() if inverse
            else ntt.ntt(torch.from_numpy(x.astype(np.int32))).numpy(),
            jntt.ntt_device(x, inverse), err_msg=f"inverse={inverse}")


def test_ntt_roundtrip_and_domain():
    rng = np.random.default_rng(7)
    coeffs = _rand_ints(rng, 16)
    enc = torch.from_numpy(jfr.encode(coeffs).astype(np.int32))
    assert jfr.decode(ntt.intt(ntt.ntt(enc)).numpy()) == coeffs
    evals = jfr.decode(ntt.ntt(enc).numpy())
    dom = ntt.domain(16)
    assert dom == jntt.domain(16)
    for i in (0, 5, 15):
        assert evals[i] == sum(c * pow(dom[i], j, R) for j, c in enumerate(coeffs)) % R
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(enc[:6])


# --- the G1 multi-scalar multiply (K11's plain version) -----------------------------

def _points(rng, k):
    return [oracle.ec_mul(oracle.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(k)]


def test_unified_add_equals_g1_add_jac():
    """K11's plain unified add (its products batched by level) gives
    ``g1_add_jac``'s digits: general sums of lazy Jacobian coordinates,
    P = Q, P = -Q, either or both operands at infinity."""
    rng = np.random.default_rng(11)
    pts = _points(rng, 4)

    def jac(p, z, lazy=False):
        x, y = p
        vals = [x * z * z % oracle.Q, y * z ** 3 % oracle.Q, z]
        return np.stack([fp.to_limbs(v + oracle.Q if lazy else v) for v in vals])

    zero = np.zeros((3, fp.L), np.int32)
    neg = (pts[1][0], oracle.Q - pts[1][1])
    cases = [(jac(pts[0], 5, True), jac(pts[2], 7, True)), (jac(pts[0], 3), jac(pts[0], 9)),
             (jac(pts[1], 3), jac(neg, 4)), (zero, jac(pts[3], 2)), (jac(pts[3], 2), zero),
             (zero, zero)]
    p = torch.from_numpy(np.stack([c[0] for c in cases]).astype(np.int32))
    q = torch.from_numpy(np.stack([c[1] for c in cases]).astype(np.int32))
    assert torch.equal(pairing._g1_add_plain(p, q), pairing.g1_add_jac(p, q))


@pytest.mark.parametrize("n", [1, 4, 64])
def test_g1_msm_equals_lincomb(n):
    """Blobs of n lanes against the host Pippenger: random scalars, a zero
    scalar, r - 1, an infinity point, and at n = 64 a lane repeated 32 apart
    (the fold's first level adds P to itself) and s, r - s on one point
    (P = -Q); at n = 4 the same at the fold's last levels."""
    rng = np.random.default_rng(20 + n)
    base = _points(rng, 8)
    pts = [base[j % 8] for j in range(n)]
    blobs = [_rand_ints(rng, n) for _ in range(2)]
    if n >= 4:
        pts[2] = pts[0]
        pts[3] = pts[1]
        blobs[0][2] = blobs[0][0]                 # lanes 0 and 2 meet: P = Q
        blobs[0][1], blobs[0][3] = 777, R - 777   # lanes 1 and 3 meet: P = -Q
        blobs[1][1], blobs[1][2] = 0, R - 1
    if n == 64:
        pts[32], pts[33], pts[40] = pts[0], pts[1], None
        blobs[1][32] = blobs[1][0]
        blobs[1][33] = (R - blobs[1][1]) % R
    if n == 1:
        blobs[1][0] = 0
    enc, inf = pairing.g1_encode_points(pts)
    scalars = torch.stack([fr.ints_to_digits(s) for s in blobs])
    aff, is_inf = pairing.g1_msm(enc, inf, scalars)
    assert pairing.g1_decode_points(aff, is_inf) == [jcurve.g1_lincomb(pts, s) for s in blobs]


def test_g1_fold_order_and_lanes():
    """The plain fold is K11's: blocks of 64 lanes by the halving tree, then
    rounds over the partials; the lanes are s_j * P_j."""
    rng = np.random.default_rng(5)
    pts = _points(rng, 3)
    enc, inf = pairing.g1_encode_points(pts)
    scalars = fr.ints_to_digits([3, 0, R - 2])[None]
    lanes = pairing.g1_msm_lanes(enc, inf, scalars)
    got = pairing.g1_decode_points(*(lambda a: (fp.canon(a[0]), a[1]))(
        pairing.g1_to_affine(lanes[0])))
    assert got == [oracle.ec_mul(pts[0], 3), None, oracle.ec_mul(pts[2], R - 2)]
    wide = lanes.expand(1, 3, 3, fp.L).repeat(1, 45, 1, 1)             # 135 lanes: 3 blocks
    part = pairing._fold_round_plain(wide)
    assert part.shape == (1, 3, 3, fp.L)
    assert torch.equal(pairing.g1_fold(wide), pairing._fold_round_plain(part)[:, 0])
    with pytest.raises(ValueError, match="scalars"):
        pairing.g1_msm(enc, inf, scalars[..., :20])


# --- the setup ----------------------------------------------------------------------

def _g2(q):
    """A G2 affine point of either package as ints."""
    return tuple((c.a, c.b) for c in q)


@pytest.mark.parametrize("n,seed", [(64, 0), (16, 9)])
def test_device_setup_equals_trusted_setup(n, seed):
    host = jsetup.trusted_setup(n, seed)
    dev = tsetup.device_setup(n, seed, "cpu")
    assert dev.powers_g1() == list(host.powers_g1)
    assert [_g2(q) for q in (dev.g2_one, dev.g2_tau)] == [_g2(q) for q in (host.g2_one,
                                                                           host.g2_tau)]
    assert tsetup.device_setup(n, seed, "cpu") is dev                 # memoized
    port_host = tsetup.trusted_setup(4, seed)
    assert port_host.powers_g1 == jsetup.trusted_setup(4, seed).powers_g1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from pos_evolution_tpu_torch.kzg.scheme import KzgCellScheme
    for call in (lambda: KzgCellScheme(), lambda: tsetup.device_setup(4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
