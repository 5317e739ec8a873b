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

import ctypes
import math

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


# K5's plans: the (d, right operand's slots) of every call on the path; the
# last is the Miller loop's line (``pairing.LINE_SLOTS``)
K5_PLANS = ((2, None), (6, None), (12, None), (12, (0, 1, 2, 3, 8, 9)))
_PLAN_ID = {key: q for q, key in enumerate(K5_PLANS)}


def _plan_tables():
    """K5's constant tables: int32 [4, 16] (d, dy, m, and where each output
    component's terms start and the last ends) and the terms, uint16
    (i * dy + j) << 4 | (coefficient + 8), the nonzero T[i, j, k] by k."""
    plans = np.zeros((len(K5_PLANS), 16), np.int32)
    terms = []
    for q, (d, slots) in enumerate(K5_PLANS):
        tpos, tneg, _, m = _plan(d, slots)
        T = tpos.astype(np.int64) - tneg
        dy = T.shape[1]
        plans[q, :3] = d, dy, m
        for k in range(d):
            plans[q, 3 + k] = len(terms)
            terms += [(i * dy + j) << 4 | (int(T[i, j, k]) + 8)
                      for i in range(d) for j in range(dy) if T[i, j, k]]
        plans[q, 3 + d] = len(terms)
    return plans, np.array(terms, np.uint16)


_PLANS_ON: set = set()       # devices K5's plans were uploaded to


def _upload_plans(device: torch.device) -> None:
    plans, terms = _plan_tables()
    fn = kernels.library("alg_mul").alg_mul_set_plans
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(plans.ctypes.data, terms.ctypes.data, len(terms))
    if rc != 0:
        raise RuntimeError(f"alg_mul: uploading the plans failed, CUDA error {rc}")
    _PLANS_ON.add(device.index)


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
    q = _PLAN_ID.get((d, None if y_slots is None else tuple(y_slots)))
    if q is None:
        raise ValueError(f"alg_mul: K5 has no plan for d={d}, slots {y_slots}")
    batch = x.shape[:-2]
    if y.shape[:-2] != batch:
        batch = torch.broadcast_shapes(batch, y.shape[:-2])
    for t, name in ((x, "x"), (y, "y")):
        if t.dtype != torch.int32:
            raise ValueError(f"alg_mul: {name} digits must be int32, got {t.dtype}")
    nb = len(batch)
    x, sx = fp.element_rows(x if x.shape[:-2] == batch else x.expand(batch + (d, fp.L)),
                            nb, (fp.L, 1))
    y, sy = fp.element_rows(y if y.shape[:-2] == batch else y.expand(batch + (dy, fp.L)),
                            nb, (fp.L, 1))
    out = torch.empty(batch + (d, fp.L), dtype=torch.int32, device=x.device)
    n = math.prod(batch)
    if n >= 2**31:
        raise ValueError(f"alg_mul: at most 2^31 - 1 elements, got {n}")
    if n:
        if x.device.index not in _PLANS_ON:
            _upload_plans(x.device)
        kernels.launch_on(x.device, "alg_mul", x.data_ptr(), sx, y.data_ptr(), sy,
                          out.data_ptr(), n, q)
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


# --- tape helpers ---------------------------------------------------------------
#
# The rows of a K4 tape being traced (``fp.make_tape``) are base-field values
# or nested lists of them (an Fq2 is [a, b]); these helpers mirror the
# tensor functions below op for op, componentwise.


def tape_add(x, y):
    return [tape_add(a, b) for a, b in zip(x, y)] if isinstance(x, list) else x + y


def tape_sub(x, y):
    return [tape_sub(a, b) for a, b in zip(x, y)] if isinstance(x, list) else x - y


def tape_neg(x):
    return [tape_neg(a) for a in x] if isinstance(x, list) else -x


def tape_canon(x):
    return [tape_canon(a) for a in x] if isinstance(x, list) else x.canon()


def tape_xi(x):
    """``fq2_mul_xi``: (a+bu)(1+u) = (a-b) + (a+b)u."""
    a, b = x
    return [a - b, a + b]


def tape_muli(x, k: int):
    """``fq2_muli``'s shift-adds, k >= 1; the doubling after the top bit,
    which the JAX loop computes and discards, is not taken."""
    acc, add = None, x
    while k:
        if k & 1:
            acc = add if acc is None else tape_add(acc, add)
        k >>= 1
        if k:
            add = tape_add(add, add)
    return acc


# --- Fq2 specifics ------------------------------------------------------------


def fq2_mul(x, y):
    return alg_mul(x, y)


def fq2_sq(x):
    return alg_mul(x, x)


_CONJ = fp.make_tape("fq2_conj", ((2,),), ((2,),), lambda x: [x[0], -x[1]])
_MUL_XI = fp.make_tape("fq2_mul_xi", ((2,),), ((2,),), tape_xi)


def fq2_conj(x):
    return fp.run_tape(_CONJ, x)


def fq2_mul_xi(x):
    """(a+bu)(1+u) = (a-b) + (a+b)u, one K4 launch."""
    return fp.run_tape(_MUL_XI, x)


def fq2_inv(x):
    """1/(a+bu) = (a - bu)/(a^2 + b^2); zero maps to zero (Fermat)."""
    a, b = x[..., 0, :], x[..., 1, :]
    d = fp.modinv(fp.modadd(fp.modmul(a, a), fp.modmul(b, b)))
    return torch.stack([fp.modmul(a, d), fp.modneg(fp.modmul(b, d))], dim=-2)


_MULI: dict = {}


def _muli_tape(k: int):
    if k not in _MULI:
        _MULI[k] = fp.make_tape(f"fq2_muli_{k}", ((),), ((),), lambda x: tape_muli(x, k))
    return _MULI[k]


for _k in range(2, 10):
    _muli_tape(_k)


def fq2_muli(x, k: int):
    """Multiply by a small non-negative int (shift-add), componentwise over
    any [..., 32] tensor: at most one K4 launch, none for k = 0 or 1."""
    if k == 0:
        return torch.zeros_like(x)
    if k == 1:
        return x
    return fp.run_tape(_muli_tape(k), x)


# --- Fq6 / Fq12 specifics -----------------------------------------------------


_MUL_V = fp.make_tape("fq6_mul_v", ((6,),), ((6,),),
                      lambda x: tape_xi(x[4:6]) + x[0:2] + x[2:4])


def fq6_mul_v(x):
    """*v: (c0, c1, c2) -> (c2*xi, c0, c1) over [..., 6, 32]."""
    return fp.run_tape(_MUL_V, x)


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


_FQ12_CONJ = fp.make_tape("fq12_conj", ((12,),), ((12,),), lambda x: x[0:6] + tape_neg(x[6:12]))


def fq12_conj(x):
    """Conjugation = Frobenius^6: negate the w-part. For elements of the
    cyclotomic subgroup this is the inverse."""
    return fp.run_tape(_FQ12_CONJ, x)


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


# Granger-Scott: the Fq4 pairs in tower slot order are (z0, z1) = (x[0:2],
# x[8:10]), (z2, z3) = (x[6:8], x[4:6]), (z4, z5) = (x[2:4], x[10:12])
_Z_SLOTS = ((0, 1), (8, 9), (6, 7), (4, 5), (2, 3), (10, 11))


def _cyclotomic_pre(x):
    """The 9 Fq2 values squared: z0..z5 and the three pair sums z0+z1,
    z2+z3, z4+z5 (the ``(a+b)`` of ``_fp4_sq``)."""
    z = [[x[i], x[j]] for i, j in _Z_SLOTS]
    return z + [tape_add(z[2 * p], z[2 * p + 1]) for p in range(3)]


def _cyclotomic_tail(x, sq):
    """From the 9 squares: each pair's (a^2 + xi*b^2, (a+b)^2 - a^2 - b^2)
    (``_fp4_sq``), then 3t - 2z and 3t + 2z, in the output's slot order."""
    z = [[x[i], x[j]] for i, j in _Z_SLOTS]

    def fp4_sq(p):
        a2, b2, s2 = sq[2 * p], sq[2 * p + 1], sq[6 + p]
        return tape_add(tape_xi(b2), a2), tape_sub(tape_sub(s2, a2), b2)

    def three_minus_two(t, zz):
        return tape_sub(tape_muli(t, 3), tape_muli(zz, 2))

    def three_plus_two(t, zz):
        return tape_add(tape_muli(t, 3), tape_muli(zz, 2))

    t0, t1 = fp4_sq(0)
    n0, n1 = three_minus_two(t0, z[0]), three_plus_two(t1, z[1])
    t0, t1 = fp4_sq(1)
    n4, n5 = three_minus_two(t0, z[4]), three_plus_two(t1, z[5])
    t2, t3 = fp4_sq(2)
    n2, n3 = three_plus_two(tape_xi(t3), z[2]), three_minus_two(t2, z[3])
    return n0 + n4 + n3 + n2 + n1 + n5


_CYC_PRE = fp.make_tape("fq12_cyclotomic_pre", ((12,),), ((9, 2),), _cyclotomic_pre)
_CYC_TAIL = fp.make_tape("fq12_cyclotomic_tail", ((12,), (9, 2)), ((12,),), _cyclotomic_tail)


def fq12_cyclotomic_sq(x):
    """Granger-Scott squaring, valid only for x in the cyclotomic subgroup
    (any easy-part output): 9 Fq2 squarings and adds, in three launches on
    the card: a K4 tape gathers the 9 values to square into one tensor, K5
    squares them, and a K4 tape makes the 12 output components from them."""
    pre = fp.run_tape(_CYC_PRE, x)
    return fp.run_tape(_CYC_TAIL, x, alg_mul(pre, pre))


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
    conj = fq2_conj(x.reshape(x.shape[:-2] + (6, 2, fp.L)))
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
