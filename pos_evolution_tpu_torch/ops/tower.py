"""BLS12-381 extension-field tower on int32 digit tensors, and kernel K5
(port of ``pos_evolution_tpu/ops/tower.py``).

Fq2 -> Fq6 -> Fq12 on top of ``ops/fp.py``, with the oracle's
irreducibles (u^2 = -1, v^3 = u+1, w^2 = v). One dense tensor per
element: Fq2 = [..., 2, 32], Fq6 = [..., 6, 32], Fq12 = [..., 12, 32],
component order the nested tower flattened (Fq12 slot (part, vpow,
upart) -> index part*6 + vpow*2 + upart).

Multiplication is ``alg_mul``: all d * dy component products mod p, a
signed recombination with the algebra's structure tensor T (T[i,j,k] =
Fq-coefficient of e_k in e_i * e_j, derived from the oracle at import),
the offset m * p that keeps it non-negative, and one Barrett reduction.
CUDA tensors go to kernel K5 (``csrc/alg_mul.cu``), which does all of it
in one launch; CPU tensors (and CUDA tensors in ``fp.plain_mode``) to its
plain version ``_alg_mul``, the JAX function step for step.

Frobenius maps use host-precomputed gamma constants
gamma_k[i] = xi^(i * (q^k - 1) / 6) over the w-power basis.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
from pos_evolution_tpu_torch.ops import fp, kernels

Q = oracle.Q

# --- structure tensors, derived from the oracle -------------------------------


def _fq12_from_coeffs(c: list) -> "oracle.Fq12":
    f2 = [oracle.Fq2(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return oracle.Fq12(oracle.Fq6(*f2[:3]), oracle.Fq6(*f2[3:]))


def _fq12_to_coeffs(x: "oracle.Fq12") -> list:
    out = []
    for part in (x.a, x.b):
        for c2 in (part.a, part.b, part.c):
            out.extend([c2.a, c2.b])
    return out


def _signed(c: int) -> int:
    return c - Q if c > Q // 2 else c


def _structure_tensor(d: int) -> np.ndarray:
    """T[i,j,k] over the first d components (a prefix of the Fq12 basis is
    the smaller algebra's basis)."""
    T = np.zeros((d, d, d), dtype=np.int64)
    basis = []
    for i in range(d):
        c = [0] * 12
        c[i] = 1
        basis.append(_fq12_from_coeffs(c))
    for i in range(d):
        for j in range(d):
            prod = _fq12_to_coeffs(basis[i] * basis[j])
            for k, coef in enumerate(prod):
                s = _signed(coef)
                assert abs(s) <= 4, (i, j, k, s)
                assert k < d or s == 0, "product escaped the subalgebra"
                if k < d:
                    T[i, j, k] = s
    return T


def _mul_plan(T: np.ndarray, y_slots=None):
    """(Tpos, Tneg, offset digits, m): the positive and negative parts of T
    (restricted to ``y_slots`` of the right operand for sparse
    multiplicands) and the offset m * p that keeps the signed
    recombination non-negative."""
    if y_slots is not None:
        T = T[:, list(y_slots), :]
    Tpos = np.maximum(T, 0).astype(np.int32)
    Tneg = np.maximum(-T, 0).astype(np.int32)
    neg_bound = int(Tneg.sum(axis=(0, 1)).max())   # worst sum |neg coef| per k
    pos_bound = int(Tpos.sum(axis=(0, 1)).max())
    m = 2 * neg_bound + 2                          # offset = m*p >= neg*2p
    # every value stays < (2*pos + m + 2) * p; must fit 33 digits
    assert (2 * pos_bound + m + 2) * Q < 2**(12 * 33)
    return Tpos, Tneg, fp.to_limbs(m * Q, 33), m


_T2 = _structure_tensor(2)
_T6 = _structure_tensor(6)
_T12 = _structure_tensor(12)
_PLANS: dict = {}


def _plan(d: int, y_slots=None):
    key = (d, y_slots)
    if key not in _PLANS:
        T = {2: _T2, 6: _T6, 12: _T12}[d]
        _PLANS[key] = _mul_plan(T, y_slots)
    return _PLANS[key]


_DEVICE_PLANS: dict = {}


def _device_plan(d: int, y_slots, device):
    """K5's operands of a plan on ``device``: the signed coefficients
    T[i, j, k] (int32, [d * dy * d], row-major) and m."""
    key = (d, y_slots, torch.device(device))
    if key not in _DEVICE_PLANS:
        tpos, tneg, _, m = _plan(d, y_slots)
        coef = np.ascontiguousarray((tpos - tneg).reshape(-1).astype(np.int32))
        _DEVICE_PLANS[key] = (torch.from_numpy(coef).to(device), m)
    return _DEVICE_PLANS[key]


# --- generic algebra ops ------------------------------------------------------


def _alg_mul(x: torch.Tensor, y: torch.Tensor, y_slots: tuple | None = None) -> torch.Tensor:
    """Plain version of K5: the JAX ``alg_mul`` step for step, its einsums
    as broadcast multiply-and-sums."""
    d = x.shape[-2]
    dev = x.device
    tpos, tneg, offset, _ = _plan(d, y_slots)
    tpos, tneg = fp.const(tpos, dev), fp.const(tneg, dev)
    prods = fp._modmul(x[..., :, None, :], y[..., None, :, :])       # [..., d, dy, 32]
    terms = prods[..., :, :, None, :]                               # [..., d, dy, 1, 32]
    pos = (tpos[..., None] * terms).sum((-4, -3), dtype=torch.int32)  # [..., d, 32]
    neg = (tneg[..., None] * terms).sum((-4, -3), dtype=torch.int32)
    pos = torch.nn.functional.pad(pos, (0, 33 - pos.shape[-1]))
    s = fp.carry_norm(pos + fp.const(offset, dev), 33)
    t = fp.carry_norm(neg, 33)
    diff, _ = fp.sub_digits(s, t)
    return fp.barrett_reduce(diff)


def alg_mul(x: torch.Tensor, y: torch.Tensor, y_slots: tuple | None = None) -> torch.Tensor:
    """x * y in the d-component algebra; x [..., d, 32], y [..., dy, 32]
    where dy = len(y_slots) if y is sparse (its components live at
    ``y_slots`` of the full basis) else d; batch dims broadcast. K5 for
    CUDA tensors, the plain version for CPU tensors."""
    d, dy = x.shape[-2], y.shape[-2]
    if d not in (2, 6, 12) or dy != (d if y_slots is None else len(y_slots)):
        raise ValueError(f"alg_mul: x {tuple(x.shape)}, y {tuple(y.shape)}, slots {y_slots}")
    if x.device != y.device:
        raise ValueError(f"alg_mul: operands on {x.device} and {y.device}")
    if not fp.use_kernel(x):
        return _alg_mul(x, y, y_slots)
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    x = fp._operand(x, batch + (d, fp.L), "alg_mul")
    y = fp._operand(y, batch + (dy, fp.L), "alg_mul")
    out = torch.empty(batch + (d, fp.L), dtype=torch.int32, device=x.device)
    n = out.numel() // (d * fp.L)
    if n == 0:
        return out
    if n >= 2**31:
        raise ValueError(f"alg_mul: at most 2^31 - 1 elements, got {n}")
    coef, m = _device_plan(d, y_slots, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernels.launch("alg_mul", x.data_ptr(), y.data_ptr(), coef.data_ptr(), out.data_ptr(),
                       n, d, dy, m, stream)
    return out


def alg_sq(x):
    return alg_mul(x, x)


# add/sub/neg/select/eq are the base-field ops broadcast over the component axis
alg_add = fp.modadd
alg_sub = fp.modsub
alg_neg = fp.modneg


def alg_eq(x, y):
    return fp.eq(x, y).all(-1)


def alg_is_zero(x):
    return fp.is_zero(x).all(-1)


def alg_select(pred, x, y):
    """pred [...] broadcast over [..., d, 32]."""
    return torch.where(pred[..., None, None], x, y)


def alg_one(d: int, batch: tuple = (), device="cpu") -> torch.Tensor:
    out = torch.zeros(tuple(batch) + (d, fp.L), dtype=torch.int32, device=device)
    out[..., 0, :] = fp.const(fp.ONE, device)
    return out


def alg_zero(d: int, batch: tuple = (), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(batch) + (d, fp.L), dtype=torch.int32, device=device)


def embed(x, d: int, slots: tuple):
    """Place sparse components x [..., len(slots), 32] at ``slots`` of a
    d-component zero element."""
    out = torch.zeros(x.shape[:-2] + (d, fp.L), dtype=torch.int32, device=x.device)
    out[..., list(slots), :] = x
    return out


# --- Fq2 specifics ------------------------------------------------------------


def fq2_mul(x, y):
    return alg_mul(x, y)


def fq2_sq(x):
    return alg_mul(x, x)


def fq2_conj(x):
    return torch.stack([x[..., 0, :], fp.modneg(x[..., 1, :])], dim=-2)


def fq2_mul_xi(x):
    """(a+bu)(1+u) = (a-b) + (a+b)u."""
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([fp.modsub(a, b), fp.modadd(a, b)], dim=-2)


def fq2_inv(x):
    """1/(a+bu) = (a - bu)/(a^2 + b^2); zero maps to zero (Fermat)."""
    a, b = x[..., 0, :], x[..., 1, :]
    d = fp.modinv(fp.modadd(fp.modmul(a, a), fp.modmul(b, b)))
    return torch.stack([fp.modmul(a, d), fp.modneg(fp.modmul(b, d))], dim=-2)


def fq2_muli(x, k: int):
    """Multiply by a small non-negative int (shift-add)."""
    acc = None
    add = x
    while k:
        if k & 1:
            acc = add if acc is None else fp.modadd(acc, add)
        add = fp.modadd(add, add)
        k >>= 1
    return acc if acc is not None else torch.zeros_like(x)


# --- Fq6 / Fq12 specifics -----------------------------------------------------


def fq6_mul_v(x):
    """*v: (c0, c1, c2) -> (c2*xi, c0, c1) over [..., 6, 32]."""
    c0, c1, c2 = x[..., 0:2, :], x[..., 2:4, :], x[..., 4:6, :]
    return torch.cat([fq2_mul_xi(c2), c0, c1], dim=-2)


def fq6_inv(x):
    """Cubic-extension inverse (oracle ``Fq6.inv``)."""
    a, b, c = x[..., 0:2, :], x[..., 2:4, :], x[..., 4:6, :]
    c0 = fp.modsub(fq2_sq(a), fq2_mul_xi(fq2_mul(b, c)))
    c1 = fp.modsub(fq2_mul_xi(fq2_sq(c)), fq2_mul(a, b))
    c2 = fp.modsub(fq2_sq(b), fq2_mul(a, c))
    t = fq2_inv(fp.modadd(fq2_mul(a, c0), fq2_mul_xi(
        fp.modadd(fq2_mul(c, c1), fq2_mul(b, c2)))))
    return torch.cat([fq2_mul(c0, t), fq2_mul(c1, t), fq2_mul(c2, t)], dim=-2)


def fq12_mul(x, y):
    return alg_mul(x, y)


def fq12_sq(x):
    return alg_mul(x, x)


def fq12_conj(x):
    """Conjugation = Frobenius^6: negate the w-part. For elements of the
    cyclotomic subgroup this is the inverse."""
    return torch.cat([x[..., 0:6, :], fp.modneg(x[..., 6:12, :])], dim=-2)


def fq12_inv(x):
    """Quadratic-over-Fq6 inverse (oracle ``Fq12.inv``)."""
    a, b = x[..., 0:6, :], x[..., 6:12, :]
    t = fq6_inv(fp.modsub(alg_mul(a, a), fq6_mul_v(alg_mul(b, b))))
    return torch.cat([alg_mul(a, t), fp.modneg(alg_mul(b, t))], dim=-2)


def fq12_pow_bits(x, bits: np.ndarray):
    """x^e for the static MSB-first bit string ``bits``: one Fq12 square
    per bit and a multiply where the bit is set."""
    acc = alg_one(12, x.shape[:-2], x.device)
    for bit in bits:
        acc = fq12_sq(acc)
        if bit:
            acc = fq12_mul(acc, x)
    return acc


def _fp4_sq(a, b):
    """(a + b*s)^2 in Fq4 = Fq2[s]/(s^2 - xi): (a^2 + xi*b^2,
    (a+b)^2 - a^2 - b^2), 3 Fq2 squarings."""
    a2 = fq2_sq(a)
    b2 = fq2_sq(b)
    c0 = fp.modadd(fq2_mul_xi(b2), a2)
    c1 = fp.modsub(fp.modsub(fq2_sq(fp.modadd(a, b)), a2), b2)
    return c0, c1


def fq12_cyclotomic_sq(x):
    """Granger-Scott squaring, valid only for x in the cyclotomic subgroup
    (any easy-part output): 9 Fq2 squarings and adds. The Fq4 pairs in
    tower slot order are (x[0:2], x[8:10]), (x[6:8], x[4:6]),
    (x[2:4], x[10:12])."""
    z0 = x[..., 0:2, :]
    z4 = x[..., 2:4, :]
    z3 = x[..., 4:6, :]
    z2 = x[..., 6:8, :]
    z1 = x[..., 8:10, :]
    z5 = x[..., 10:12, :]

    def three_minus_two(t, z):   # 3t - 2z
        return fp.modsub(fq2_muli(t, 3), fq2_muli(z, 2))

    def three_plus_two(t, z):    # 3t + 2z
        return fp.modadd(fq2_muli(t, 3), fq2_muli(z, 2))

    t0, t1 = _fp4_sq(z0, z1)
    n0 = three_minus_two(t0, z0)
    n1 = three_plus_two(t1, z1)
    t0, t1 = _fp4_sq(z2, z3)
    t2, t3 = _fp4_sq(z4, z5)
    n4 = three_minus_two(t0, z4)
    n5 = three_plus_two(t1, z5)
    n2 = three_plus_two(fq2_mul_xi(t3), z2)
    n3 = three_minus_two(t2, z3)
    return torch.cat([n0, n4, n3, n2, n1, n5], dim=-2)


def fq12_pow_bits_cyclotomic(x, bits: np.ndarray):
    """``fq12_pow_bits`` with Granger-Scott squarings; x must be in the
    cyclotomic subgroup (the final exponentiation's hard-part ladders)."""
    acc = alg_one(12, x.shape[:-2], x.device)
    for bit in bits:
        acc = fq12_cyclotomic_sq(acc)
        if bit:
            acc = fq12_mul(acc, x)
    return acc


# --- Frobenius ----------------------------------------------------------------
#
# Over the w-power basis c_i * w^i (i = 0..5, w^6 = xi):
#   frob^k(c_i w^i) = frob^k(c_i) * gamma_k[i] * w^i,
#   gamma_k[i] = xi^(i * (q^k - 1) / 6)
# frob on Fq2 is conjugation. Tower slots (pairs) <-> w-powers:
# (a.c0, a.c1, a.c2, b.c0, b.c1, b.c2) = (w^0, w^2, w^4, w^1, w^3, w^5).

_WPOW = [0, 2, 4, 1, 3, 5]


def _gamma_const(k: int) -> np.ndarray:
    """[6, 2, 32] gamma constants per tower Fq2 slot."""
    qk = Q if k == 1 else Q * Q
    out = np.zeros((6, 2, fp.L), dtype=np.int32)
    for slot in range(6):
        g = oracle.XI.pow(_WPOW[slot] * (qk - 1) // 6)
        out[slot, 0] = fp.to_limbs(g.a)
        out[slot, 1] = fp.to_limbs(g.b)
    return out


_G1C = _gamma_const(1)
_G2C = _gamma_const(2)


def fq12_frob1(x):
    pairs = x.reshape(x.shape[:-2] + (6, 2, fp.L))
    conj = torch.stack([pairs[..., 0, :], fp.modneg(pairs[..., 1, :])], dim=-2)
    out = alg_mul(conj, fp.const(_G1C, x.device).expand(conj.shape))
    return out.reshape(x.shape)


def fq12_frob2(x):
    pairs = x.reshape(x.shape[:-2] + (6, 2, fp.L))
    out = alg_mul(pairs, fp.const(_G2C, x.device).expand(pairs.shape))
    return out.reshape(x.shape)


# --- host <-> tensor codecs -----------------------------------------------------


def _host(x, idx):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)[idx]


def fq2_encode(x: "oracle.Fq2") -> np.ndarray:
    return np.stack([fp.to_limbs(x.a), fp.to_limbs(x.b)])


def fq2_decode(x, idx=()) -> "oracle.Fq2":
    arr = _host(x, idx)
    return oracle.Fq2(fp.from_limbs(arr[0]), fp.from_limbs(arr[1]))


def fq6_encode(x: "oracle.Fq6") -> np.ndarray:
    return np.concatenate([fq2_encode(c) for c in (x.a, x.b, x.c)])


def fq6_decode(x, idx=()) -> "oracle.Fq6":
    arr = _host(x, idx)
    return oracle.Fq6(*(oracle.Fq2(fp.from_limbs(arr[2 * i]),
                                   fp.from_limbs(arr[2 * i + 1]))
                        for i in range(3)))


def fq12_encode(x: "oracle.Fq12") -> np.ndarray:
    return np.concatenate([fq6_encode(x.a), fq6_encode(x.b)])


def fq12_decode(x, idx=()) -> "oracle.Fq12":
    arr = _host(x, idx)
    return oracle.Fq12(fq6_decode(arr[0:6]), fq6_decode(arr[6:12]))
