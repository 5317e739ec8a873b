"""Batched preamble of the real-BLS verify path (port of
``pos_evolution_tpu/ops/g2prep.py``): fixed-exponent square roots, sign
canonicalization, G1/G2 decompression, G2 Jacobian arithmetic with the
cofactor clearing, and hash-to-G2.

    host: SHA candidate scan + one base-field Legendre pow per candidate
          (``hash_to_g2_candidates``), compressed-signature unpacking
          (``g2_compressed_to_limbs``)
    device: the Fq/Fq2 square-root ladders, sign canon, cofactor
            scalar-mult, decompression, through ``ops/fp.py`` and
            ``ops/tower.py`` (kernels K3-K5 on CUDA tensors).

Ladders over static exponents (the square roots, the cofactor) take the
multiply or the addition only where the bit is set, a Python branch on a
bit shared by the batch where JAX computed both sides and selected: the
same values. Data-dependent choices (``g2_mul_scalar_batch``'s scalar
bits, the infinity cases of ``g2_add_jac``, the eighth-root tries) stay
compute-and-select.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
from pos_evolution_tpu_torch.device import resolve_device
from pos_evolution_tpu_torch.ops import fp
from pos_evolution_tpu_torch.ops.pairing import (
    _add,
    _add_tapes,
    _double,
    _double_tapes,
    _sel,
    g2_affine_encode,
)
from pos_evolution_tpu_torch.ops.tower import (
    alg_eq,
    alg_mul,
    alg_one,
    fq2_encode,
    fq2_inv,
    fq2_mul,
    fq2_sq,
)

Q = oracle.Q

# static MSB-first bit schedules for the fixed-exponent ladders
_SQRT_FQ_BITS = np.array([b == "1" for b in bin((Q + 1) // 4)[2:]], dtype=bool)
_SQRT_FQ2_BITS = np.array([b == "1" for b in bin((Q * Q + 7) // 16)[2:]], dtype=bool)
_COFACTOR_BITS = np.array([b == "1" for b in bin(oracle.G2_COFACTOR)[2:]], dtype=bool)

_HALF_Q = fp.to_limbs((Q - 1) // 2)             # sign threshold (canonical y)
_EIGHTH_ROOTS = np.stack([fq2_encode(r) for r in oracle._EIGHTH_ROOTS])
_FQ2_B = fq2_encode(oracle.Fq2(4, 4))           # twist b = 4(u+1)
_FOUR = fp.to_limbs(4)                          # G1 b = 4


# --- fixed-exponent ladders ---------------------------------------------------


fp_pow_static = fp.pow_static     # x^e over a static MSB-first bit string (base field)


def fq2_pow_static(x: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """x^e for Fq2 [..., 2, 32] over a static bit schedule."""
    acc = alg_one(2, x.shape[:-2], x.device)
    for bit in bits:
        acc = fq2_sq(acc)
        if bit:
            acc = fq2_mul(acc, x)
    return acc


def fp_sqrt(a: torch.Tensor):
    """(sqrt, is_square) in Fq (q = 3 mod 4: the a^((q+1)/4) candidate)."""
    s = fp_pow_static(a, _SQRT_FQ_BITS)
    return s, fp.eq(fp.modmul(s, s), a)


def fq2_sqrt_batch(a: torch.Tensor):
    """(sqrt, is_square) in Fq2 for a [..., 2, 32]: the oracle's
    q^2 = 9 mod 16 method, one candidate ladder, then the four eighth
    roots of unity tried compute-and-select."""
    cand = fq2_pow_static(a, _SQRT_FQ2_BITS)
    roots = fp.const(_EIGHTH_ROOTS, a.device)               # [4, 2, 32]
    best = torch.zeros_like(cand)
    found = torch.zeros(a.shape[:-2], dtype=torch.bool, device=a.device)
    for i in range(4):
        x = fq2_mul(cand, roots[i].expand(cand.shape))
        ok = alg_eq(fq2_sq(x), a)
        best = _sel(~found & ok, x, best)
        found = found | ok
    return best, found


# --- sign / parity helpers ----------------------------------------------------


def fp_gt_const_pair(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Lexicographic y > c of two canonical limb arrays (same shape)."""
    gt = y > c
    eq = y == c
    more_sig_eq = torch.flip(torch.cumprod(torch.flip(eq, (-1,)).to(torch.int32), -1),
                             (-1,)).bool()
    prefix_eq = torch.cat([more_sig_eq[..., 1:],
                           torch.ones(y.shape[:-1] + (1,), dtype=torch.bool, device=y.device)],
                          dim=-1)
    return (gt & prefix_eq).any(-1)


def fp_gt_const(y: torch.Tensor, const: np.ndarray) -> torch.Tensor:
    """Canonical y [..., 32] > const (little-endian limb vector)."""
    return fp_gt_const_pair(fp.canon(y), fp.const(const, y.device).expand(y.shape))


def fp_y_is_large(y: torch.Tensor) -> torch.Tensor:
    """The ZCash compressed-point sign bit: y > (q-1)/2 (canonical)."""
    return fp_gt_const(y, _HALF_Q)


def fp_is_odd(y: torch.Tensor) -> torch.Tensor:
    return (fp.canon(y)[..., 0] & 1).bool()


def fq2_y_is_large(y: torch.Tensor) -> torch.Tensor:
    """Lexicographic (y.b, y.a) > (-y.b, -y.a): the oracle's G2 sign."""
    ny = fp.canon(fp.modneg(y))
    ya, yb = fp.canon(y[..., 0, :]), fp.canon(y[..., 1, :])
    na, nb = ny[..., 0, :], ny[..., 1, :]
    b_gt = fp_gt_const_pair(yb, nb)
    b_eq = (yb == nb).all(-1)
    a_gt = fp_gt_const_pair(ya, na)
    return b_gt | (b_eq & a_gt)


def _cond_negate(y: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return _sel(flip, fp.canon(fp.modneg(y)), fp.canon(y))


# --- batched decompression ----------------------------------------------------


def g1_decompress_batch(x: torch.Tensor, sign_large: torch.Tensor):
    """Batched ZCash G1 decompression (x [N, 32] canonical limbs,
    sign_large bool[N]) -> (affine [N, 2, 32], valid bool[N]). Infinity
    flags are a host concern (strip before the call)."""
    x2 = fp.modmul(x, x)
    y2 = fp.modadd(fp.modmul(x2, x), fp.const(_FOUR, x.device).expand(x.shape))
    y, ok = fp_sqrt(y2)
    y = _cond_negate(y, fp_y_is_large(y) != sign_large)
    return torch.stack([fp.canon(x), y], dim=-2), ok


def g2_decompress_batch(x: torch.Tensor, sign_large: torch.Tensor):
    """Batched G2 decompression (x [B, 2, 32] Fq2 limbs, sign bool[B])
    -> (affine [B, 2, 2, 32], valid bool[B])."""
    rhs = fp.modadd(fq2_mul(fq2_sq(x), x), fp.const(_FQ2_B, x.device).expand(x.shape))
    y, ok = fq2_sqrt_batch(rhs)
    flip = fq2_y_is_large(y) != sign_large
    y = _cond_negate(y, flip[..., None])
    return torch.stack([fp.canon(x), y], dim=-3), ok


def g2_compressed_to_limbs(data: np.ndarray):
    """Host unpack of 96-byte compressed G2 signatures [B, 96] u8 ->
    (x limbs [B, 2, 32], sign bool[B], inf bool[B], invalid bool[B]).

    Canonicality is checked per row: the compression flag (bit 383) must
    be set, both Fq coordinates fully reduced (< Q), and the infinity flag
    must come with all-zero payload bits. Invalid rows get zeroed limbs
    and ``invalid=True``; callers decide whether to reject or mask."""
    data = np.asarray(data, np.uint8).reshape(-1, 96)
    out_x = np.zeros((data.shape[0], 2, fp.L), np.int32)
    sign = np.zeros(data.shape[0], bool)
    inf = np.zeros(data.shape[0], bool)
    invalid = np.zeros(data.shape[0], bool)
    for i, row in enumerate(data):
        hi = int.from_bytes(row[:48].tobytes(), "big")
        lo = int.from_bytes(row[48:].tobytes(), "big")
        compressed = bool(hi & (1 << 383))
        inf[i] = bool(hi & (1 << 382))
        sign[i] = bool(hi & (1 << 381))
        x_im = hi & ((1 << 381) - 1)
        if not compressed:
            invalid[i] = True               # uncompressed/garbage framing
            sign[i] = False                 # don't echo garbage flag bits
            inf[i] = False
            continue
        if inf[i]:
            # canonical infinity: no sign, no coordinate bits
            invalid[i] = sign[i] or x_im != 0 or lo != 0
            sign[i] = False
            continue
        if x_im >= Q or lo >= Q:
            invalid[i] = True               # non-reduced field element
            continue
        out_x[i, 1] = fp.to_limbs(x_im)
        out_x[i, 0] = fp.to_limbs(lo)
    return out_x, sign, inf, invalid


# --- G2 (twist) Jacobian arithmetic ------------------------------------------


_G2_DOUBLE = _double_tapes("g2_double", (2,))
_G2_ADD = _add_tapes("g2_add", (2,))


def g2_double_jac(P):
    """a=0 Jacobian doubling on E'(Fq2); P [..., 3, 2, 32]."""
    return _double(P, alg_mul, _G2_DOUBLE)


def _fq2_is_zero(x):
    return fp.is_zero(x).all(-1)


def g2_add_jac(P, Q_):
    """Unified branch-free Jacobian add on the twist: the case analysis of
    ``pairing.g1_add_jac`` lifted to Fq2."""
    return _add(P, Q_, alg_mul, _G2_ADD, g2_double_jac, -3)


def g2_affine_to_jac(q_aff):
    """[..., 2, 2, 32] affine -> [..., 3, 2, 32] Jacobian (Z = 1)."""
    one = alg_one(2, q_aff.shape[:-3], q_aff.device)
    return torch.cat([q_aff, one[..., None, :, :]], dim=-3)


def g2_jac_to_affine(P):
    """[..., 3, 2, 32] -> (affine [..., 2, 2, 32], inf mask [...])."""
    X, Y, Z = P[..., 0, :, :], P[..., 1, :, :], P[..., 2, :, :]
    zi = fq2_inv(fp.canon(Z))
    zi2 = fq2_sq(zi)
    x = fq2_mul(X, zi2)
    y = fq2_mul(Y, fq2_mul(zi, zi2))
    return torch.stack([fp.canon(x), fp.canon(y)], dim=-3), _fq2_is_zero(Z)


def g2_mul_static(q_aff: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """Scalar mult by a static MSB-first bit schedule (the cofactor):
    double-and-add, the addition only at set bits; Jacobian [..., 3, 2, 32]."""
    pj = g2_affine_to_jac(q_aff)
    acc = torch.zeros_like(pj)                   # Z = 0: infinity
    for bit in bits:
        acc = g2_double_jac(acc)
        if bit:
            acc = g2_add_jac(acc, pj)
    return acc


def g2_mul_scalar_batch(q_aff: torch.Tensor, scalar_bits: torch.Tensor) -> torch.Tensor:
    """Per-element scalar mult: scalar_bits bool[..., nbits] MSB-first as
    data (signing); every step doubles, adds and selects by the bit."""
    pj = g2_affine_to_jac(q_aff)
    acc = torch.zeros_like(pj)
    for i in range(scalar_bits.shape[-1]):
        acc = g2_double_jac(acc)
        acc = _sel(scalar_bits[..., i], g2_add_jac(acc, pj), acc)
    return acc


# --- hash to G2, batched ------------------------------------------------------


def hash_to_g2_candidates(messages) -> tuple:
    """Host scan mirroring the oracle's try-and-increment: for each
    message walk ctr = 0, 1, ... and pick the first x candidate whose
    rhs = x^3 + 4(u+1) is a square in Fq2 (a Legendre check on the norm
    per candidate). Returns (x limbs [B, 2, 32], ctr picks [B])."""
    out = np.zeros((len(messages), 2, fp.L), np.int32)
    picks = np.zeros(len(messages), np.int64)
    exp = (Q - 1) // 2
    for i, message in enumerate(messages):
        ctr = 0
        while True:
            seed = hashlib.sha256(b"blsg2" + bytes(message) + ctr.to_bytes(4, "little"))
            d0 = seed.digest()
            d1 = hashlib.sha256(d0).digest()
            d2 = hashlib.sha256(d1).digest()
            xa = int.from_bytes(d0 + d1[:16], "big") % Q
            xb = int.from_bytes(d1[16:] + d2, "big") % Q
            # rhs = x^3 + 4(u+1); square in Fq2 iff norm(rhs) is a QR in Fq
            r_ = oracle.Fq2(xa, xb)
            rhs = r_.sq() * r_ + oracle.Fq2(4, 4)
            norm = (rhs.a * rhs.a + rhs.b * rhs.b) % Q
            if norm == 0 or pow(norm, exp, Q) == 1:
                out[i, 0] = fp.to_limbs(xa)
                out[i, 1] = fp.to_limbs(xb)
                picks[i] = ctr
                break
            ctr += 1
    return out, picks


def hash_to_g2_finish(x: torch.Tensor):
    """Device finish of the hash-to-G2 map for picked candidates
    x [B, 2, 32]: Fq2 sqrt, canonical (even y.a) sign, cofactor clearing.
    Returns (affine [B, 2, 2, 32], ok bool[B]); ok is False only where
    the cleared point is at infinity (measure zero; the oracle retries)."""
    rhs = fp.modadd(fq2_mul(fq2_sq(x), x), fp.const(_FQ2_B, x.device).expand(x.shape))
    y, is_sq = fq2_sqrt_batch(rhs)
    flip = fp_is_odd(y[..., 0, :])               # oracle sign: negate odd y.a
    y = _cond_negate(y, flip[..., None])
    cleared = g2_mul_static(torch.stack([fp.canon(x), y], dim=-3), _COFACTOR_BITS)
    aff, inf = g2_jac_to_affine(cleared)
    return aff, is_sq & ~inf


def oracle_patch(aff: torch.Tensor, ok: torch.Tensor, messages):
    """(aff with the rows where ``ok`` is False replaced by the oracle's
    ``hash_to_g2`` of their messages, the number of such rows). These are
    the measure-zero rows whose cofactor clearing lands at infinity: the
    batch cannot retry them, the oracle walks on to the next counter. It
    is the JAX ``hash_to_g2_batch``'s own per-row semantics."""
    bad = np.flatnonzero(~ok.cpu().numpy())
    if bad.size:
        aff = aff.clone()
        for i in bad:
            aff[int(i)] = torch.from_numpy(
                g2_affine_encode(oracle.hash_to_g2(bytes(messages[int(i)])))).to(aff.device)
    return aff, int(bad.size)


def hash_to_g2_batch(messages, device="cuda"):
    """Full batched map: host candidate scan, device finish, and the
    oracle for the rows the batch cannot finish (``oracle_patch``).
    Returns affine [B, 2, 2, 32] on ``device``, equal to the oracle's
    ``hash_to_g2`` row by row."""
    x, _ = hash_to_g2_candidates(messages)
    aff, ok = hash_to_g2_finish(torch.from_numpy(x).to(resolve_device(device)))
    return oracle_patch(aff, ok, messages)[0]
