"""Kernel K3 of the port (``csrc/fp_modmul.cu``) on the CPU: the plain
versions of its static-exponent ladder against the JAX package's jitted
scans, digit for digit (tolerance 0), and the Python that lays out K3's
arguments (operands read in place by an outer and an inner element stride,
a stride of 0 for a broadcast, a copy only where no split of the batch dims
serves). The kernel itself runs in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pos_evolution_tpu.ops import fp as jfp  # noqa: E402
from pos_evolution_tpu.ops import g2prep as jg2  # noqa: E402
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels  # noqa: E402

Q = fp.P_INT
EDGES = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1]
EXPONENTS = {"modinv": fp._P_MINUS_2_BITS, "sqrt": g2prep._SQRT_FQ_BITS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A plain ladder is thousands of tiny tensor ops: one intra-op thread
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digits(vals):
    return np.stack([fp.to_limbs(v) for v in vals])


def _ladder_inputs():
    """The edge values and two seeded residues in [0, 2p)."""
    rng = np.random.default_rng(61)
    return _digits(EDGES + [int.from_bytes(rng.bytes(49), "big") % (2 * Q) for _ in range(2)])


@pytest.mark.parametrize("which", sorted(EXPONENTS))
def test_plain_ladder_matches_jax(which):
    """_pow_static (and modinv, which the CPU sends to it) equals the JAX
    package's jitted modinv and g2prep.fp_pow_static, lazy residues
    included, and the right power mod p."""
    x = _ladder_inputs()
    bits = EXPONENTS[which]
    before = dict(kernels.launches)
    got = fp._pow_static(torch.from_numpy(x), bits)
    assert kernels.launches == before
    if which == "modinv":
        want = np.asarray(jfp.modinv_jit(jnp.asarray(x)))
        np.testing.assert_array_equal(fp.modinv(torch.from_numpy(x)).numpy(), want)
    else:
        want = np.asarray(jg2.fp_pow_static(jnp.asarray(x), bits))
    np.testing.assert_array_equal(got.numpy(), want)
    e = int("".join("1" if b else "0" for b in bits), 2)
    for row, v in zip(got.numpy(), x):
        r = fp.from_limbs(row)
        assert r < 2 * Q and r % Q == pow(fp.from_limbs(v) % Q, e, Q)


def test_plain_ladder_short_schedules():
    """Schedules with leading, inner and trailing zero bits, against the
    plain product chain and Python's pow."""
    x = torch.from_numpy(_ladder_inputs())
    for bits in ([1], [0, 1], [1, 0, 1, 1, 0], [1, 1, 1, 1], [0, 0, 1, 0]):
        got = fp.pow_static(x, np.array(bits, dtype=bool))
        acc = fp.ones_like(x)
        for b in bits:
            acc = fp.modmul(acc, acc)
            if b:
                acc = fp.modmul(acc, x)
        assert torch.equal(got, acc)
        e = int("".join(map(str, bits)), 2)
        for row, v in zip(got, x):
            assert fp.from_limbs(row) % Q == pow(fp.from_limbs(v) % Q, e, Q)


def test_pack_bits():
    """Bit s of the MSB-first schedule at word s // 32, bit s % 32."""
    for bits in (fp._P_MINUS_2_BITS, g2prep._SQRT_FQ_BITS, np.array([1, 0, 1], dtype=bool)):
        words, n = fp._pack_bits(bits)
        assert n == len(bits)
        packed = sum(int(w) << (32 * i) for i, w in enumerate(words))
        assert packed == sum(int(b) << s for s, b in enumerate(bits))
    assert fp._pack_bits(fp._P_MINUS_2_BITS)[1] == 381
    for bad in (np.zeros(0, dtype=bool), np.ones(385, dtype=bool)):
        with pytest.raises(ValueError, match="1 to 384 bits"):
            fp._pack_bits(bad)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << fp.BITS, (*shape, fp.L), dtype=np.int32)
    d[..., -1] = rng.integers(0, int(fp.TWO_P[-1]), shape, dtype=np.int32)
    return torch.from_numpy(d)


def _launch_args(a, b):
    """K3's product arguments for a and b: (out, pointers and strides)."""
    out, args, keep = fp._modmul_launch(a, b)
    ptr_a, sao, sai, ptr_b, sbo, sbi, ptr_o, n, n_inner, group = args
    return out, {"a": (ptr_a, sao, sai), "b": (ptr_b, sbo, sbi), "out": ptr_o, "n": n,
                 "n_inner": n_inner, "group": group, "keep": keep}


def test_layout_contiguous_and_broadcast_scalar():
    a = _field((5, 7), 1)
    out, g = _launch_args(a, a[:1, :1])
    assert out.shape == (5, 7, fp.L) and out.is_contiguous() and g["n"] == 35
    assert g["a"][0] == a.data_ptr() and g["b"][0] == a.data_ptr()      # no copies
    assert g["a"][1:] == (0, fp.L) and g["n_inner"] == 35                # one inner run
    assert g["b"][1:] == (0, 0)                                            # one element for all
    assert g["group"] == fp.k3_group(35)


def test_layout_tree_unbind_views():
    """A level of the G1 sum tree: the coordinates of jac[..., :k, :, :]
    (element strides 3 * 32 inside a committee, 2k * 3 * 32 across) are read
    in place, one split (outer = the committees, inner = the k lanes)."""
    b, k = 6, 4
    jac = _field((b, 2 * k, 3), 2)
    X1, Y1, Z1 = jac[:, :k].unbind(-2)
    X2, _, Z2 = jac[:, k:].unbind(-2)
    for x, y in ((Z1, Z1), (X1, Z2), (Y1, X2)):
        out, g = _launch_args(x, y)
        assert g["a"] == (x.data_ptr(), 2 * k * 3 * fp.L, 3 * fp.L)
        assert g["b"] == (y.data_ptr(), 2 * k * 3 * fp.L, 3 * fp.L)
        assert g["n"] == b * k and g["n_inner"] == k
        assert torch.equal(fp.modmul(x, y), fp._modmul(x.contiguous(), y.contiguous()))


def test_layout_fq2_scale_fq_broadcast():
    """_fq2_scale_fq: an Fq2 [B, 2, 32] times a scalar [B, 32] broadcast over
    the component axis (stride 0 inside an element pair), and an Fq2
    component view (stride 64)."""
    c2, s = _field((9, 2), 3), _field((9,), 4)
    out, g = _launch_args(c2, s[..., None, :])
    assert g["a"] == (c2.data_ptr(), 2 * fp.L, fp.L) and g["b"] == (s.data_ptr(), fp.L, 0)
    assert g["n_inner"] == 2 and out.shape == (9, 2, fp.L)
    out, g = _launch_args(c2[:, 0], c2[:, 1])
    assert g["a"] == (c2.data_ptr(), 0, 2 * fp.L)
    assert g["b"] == (c2.data_ptr() + 4 * fp.L, 0, 2 * fp.L)


def test_layout_copies_only_what_no_split_serves():
    """Three batch dims permuted so that no outer/inner split collapses:
    that operand is copied, the other is read in place; rows off 16-byte
    alignment are copied too."""
    base = _field((2, 3, 4), 5)
    odd = base.permute(1, 0, 2, 3)                        # [3, 2, 4], strides (128, 384, 32)
    fine = _field((3, 2, 4), 6)
    out, g = _launch_args(odd, fine)
    assert g["a"][0] != odd.data_ptr() and g["b"][0] == fine.data_ptr()
    assert torch.equal(g["keep"][0], odd) and g["keep"][0].is_contiguous()
    assert torch.equal(fp.modmul(odd, fine), fp._modmul(odd.contiguous(), fine))
    flat = _field((9,), 7).reshape(-1)
    skew = flat[1:1 + 8 * fp.L].view(8, fp.L)               # rows 4 bytes off alignment
    _, g = _launch_args(skew, skew)
    assert g["a"][0] != skew.data_ptr() and g["a"][0] % 16 == 0


def _fq2_rows(case):
    """(an Fq2 operand [..., 2, 32], its batch dims, its element stride in
    place or None where it must be copied)."""
    if case == "contiguous":
        return _field((6, 2), 20), 1, 2 * fp.L
    if case == "broadcast":
        return _field((1, 2), 21).expand(6, 2, fp.L), 1, 0
    if case == "component":
        return _field((6, 2, 2), 22)[:, 1], 1, 4 * fp.L
    if case == "collapsing":
        return _field((3, 4, 2), 23), 2, 2 * fp.L
    if case == "permuted":
        return _field((2, 3, 2), 24).permute(1, 0, 2, 3), 2, None
    flat = _field((13,), 25).reshape(-1)
    return flat[1:1 + 12 * fp.L].view(6, 2, fp.L), 1, None          # 4 bytes off alignment


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "component", "collapsing",
                                  "permuted", "misaligned"])
def test_element_rows_follows_split_strides(case):
    """K4/K5's element_rows and K3's layout share one rule: an operand is
    read in place at the stride split_strides gives at no split, and copied
    where it gives none."""
    t, nb, want = _fq2_rows(case)
    std = (fp.L, 1)
    split = fp.split_strides(t, nb, std)
    got, es = fp.element_rows(t, nb, std)
    if want is None:
        assert split is None and got.data_ptr() != t.data_ptr() and got.is_contiguous()
        assert es == 2 * fp.L and torch.equal(got, t)
    else:
        assert split == (0, want) and got is t and es == want


def test_pow_launch_arguments():
    x = _field((3, 5), 8)
    comp = _field((4, 2), 9)[:, 1]                            # element stride 64
    out, args, keep = fp._pow_launch(comp, fp._P_MINUS_2_BITS)
    ptr, so, si, ptr_o, n, n_inner, words, nbits, group = args
    assert ptr == comp.data_ptr() and n == 4 and nbits == 381 and out.shape == comp.shape
    assert (so, si) == (0, 2 * fp.L) and n_inner == 4 and keep[0] is comp
    _, args, _ = fp._pow_launch(x, g2prep._SQRT_FQ_BITS, group=1)
    assert args[4] == 15 and args[-1] == 1 and args[-2] == len(g2prep._SQRT_FQ_BITS)


def test_group_rule():
    assert fp.k3_group(1) == fp.k3_group(2048) == fp.k3_group(fp.K3_GROUP_BELOW - 1) == 4
    assert fp.k3_group(fp.K3_GROUP_BELOW) == fp.k3_group(2048 * 64) == 1


def test_cpu_never_launches():
    x = _field((3,), 10)
    before = dict(kernels.launches)
    fp.modinv(x)
    fp.pow_static(x, np.array([1, 1], dtype=bool))
    fp.modmul(x, x[:1])
    assert kernels.launches == before
    with pytest.raises(ValueError, match="digit axis"):
        fp.pow_static(x[:, :16], np.array([1], dtype=bool))
