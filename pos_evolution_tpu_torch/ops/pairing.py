"""BLS12-381 pairing on int32 digit tensors: batched ate pairing and
FastAggregateVerify over the dense tower (port of
``pos_evolution_tpu/ops/pairing.py``, ``:78-376``).

The algorithm is the JAX package's, step for step:

- **Miller loop on the twist.** The loop state is a Jacobian point over
  Fq2 on E'(Fq2); each tangent/chord line is evaluated through the
  untwist map and lands in the sparse slots ``LINE_SLOTS`` of the dense
  Fq12 basis, scaled by Fq2 constants and w^3 that the final
  exponentiation kills (see the JAX module's docstring). No inversion in
  the loop. The schedule is the static 63-bit tail of |t|; where JAX
  computed the addition step every iteration and selected it by the bit,
  the port takes the addition step only where the bit is set (a static
  bit shared by the batch: the same values, 5 addition steps of 63).
- **Final exponentiation by the x-chain**: easy part by conjugation, one
  tower inversion and one Frobenius; hard part by the identity
  3*(q^4-q^2+1)/r = (x-1)^2 (x+q) (x^2+q^2-1) + 3, so the result is
  e(P, Q)^3.
- **G1 aggregation** as a masked unified-add reduction tree, every case
  (infinity, doubling, P = -Q) computed and selected, since they are data.

Every multiply and add goes through ``ops/fp.py`` and ``ops/tower.py``:
kernels K3-K5 on CUDA tensors, their plain versions on CPU tensors or
within ``fp.plain_mode`` (``fast_aggregate_verify_batch(plain=True)``).
The G1 multi-scalar multiply of the KZG commit path (JAX
``_g1_msm_kernel``, ``g1_msm_device_entry``) is not ported here: its only
caller is the KZG slice.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
from pos_evolution_tpu_torch.ops import fp
from pos_evolution_tpu_torch.ops.tower import (
    alg_eq,
    alg_mul,
    alg_one,
    alg_select,
    fq2_mul,
    fq2_muli,
    fq2_sq,
    fq12_conj,
    fq12_frob1,
    fq12_frob2,
    fq12_inv,
    fq12_mul,
    fq12_pow_bits_cyclotomic,
    fq12_sq,
)

BLS_X = oracle.BLS_X                      # |t|; t is negative

# static bit schedules (MSB first)
_LOOP_BITS = np.array([b == "1" for b in bin(BLS_X)[3:]], dtype=bool)
_X_BITS = np.array([b == "1" for b in bin(BLS_X)[2:]], dtype=bool)
_XP1_BITS = np.array([b == "1" for b in bin(BLS_X + 1)[2:]], dtype=bool)

# line sparsity: (w^0, w^2, w^3) as Fq2 pairs in the dense-basis order
LINE_SLOTS = (0, 1, 2, 3, 8, 9)


# --- small helpers ------------------------------------------------------------


def _sel(pred, x, y):
    """Select by a [...]-shaped predicate, broadcast over trailing axes."""
    extra = x.ndim - pred.ndim
    return torch.where(pred.reshape(pred.shape + (1,) * extra), x, y)


def _fq2_scale_fq(c2, s):
    """Fq2 [..., 2, 32] times base-field scalar s [..., 32]."""
    return fp.modmul(c2, s[..., None, :])


def g2_neg(q):
    """Negate an affine twisted point [..., 2(xy), 2, 32]."""
    return torch.cat([q[..., 0:1, :, :], fp.modneg(q[..., 1:2, :, :])], dim=-3)


# --- encoders (host) ----------------------------------------------------------


def g1_affine_encode(p) -> np.ndarray:
    """Oracle G1 affine (ints) or None -> [2, 32] limbs (inf -> zeros;
    pair with an explicit inf mask)."""
    if p is None:
        return np.zeros((2, fp.L), dtype=np.int32)
    return np.stack([fp.to_limbs(p[0]), fp.to_limbs(p[1])])


def g2_affine_encode(q) -> np.ndarray:
    """Oracle G2 affine (Fq2 pair) or None -> [2, 2, 32] limbs."""
    if q is None:
        return np.zeros((2, 2, fp.L), dtype=np.int32)
    x, y = q
    return np.stack([
        np.stack([fp.to_limbs(x.a), fp.to_limbs(x.b)]),
        np.stack([fp.to_limbs(y.a), fp.to_limbs(y.b)]),
    ])


_G1_GEN = g1_affine_encode(oracle.G1_GEN)


# --- Miller loop --------------------------------------------------------------


def _line_embed(c0, cxp, cyp):
    """The three Fq2 line coefficients as the sparse [..., 6, 32] operand
    of ``alg_mul(..., y_slots=LINE_SLOTS)``."""
    return torch.cat([c0, cxp, cyp], dim=-2)


def miller_loop(p_aff: torch.Tensor, q_aff: torch.Tensor,
                inf: torch.Tensor | None = None) -> torch.Tensor:
    """Batched ate Miller loop for (P in G1, Q in E'(Fq2)).

    p_aff [..., 2, 32] affine Fq coords, q_aff [..., 2, 2, 32] affine
    twisted Fq2 coords, inf [...] optional mask of pairs whose value must
    be one (either point at infinity). Returns f [..., 12, 32] before the
    final exponentiation (scaled by an Fq2 constant)."""
    xp, yp = p_aff[..., 0, :], p_aff[..., 1, :]
    xq, yq = q_aff[..., 0, :, :], q_aff[..., 1, :, :]
    batch = xp.shape[:-1]
    dev = xp.device
    one12 = alg_one(12, batch, dev)
    f = one12
    X, Y, Z = xq, yq, alg_one(2, batch, dev)
    for bit in _LOOP_BITS:
        # doubling step (a=0 Jacobian dbl-2009-l) + tangent line
        A = fq2_sq(X)
        B = fq2_sq(Y)
        C = fq2_sq(B)
        ZZ = fq2_sq(Z)
        D = fq2_muli(fp.modsub(fp.modsub(fq2_sq(fp.modadd(X, B)), A), C), 2)
        E = fq2_muli(A, 3)
        X3 = fp.modsub(fq2_sq(E), fq2_muli(D, 2))
        Y3 = fp.modsub(fq2_mul(E, fp.modsub(D, X3)), fq2_muli(C, 8))
        YZ = fq2_mul(Y, Z)
        Z3 = fq2_muli(YZ, 2)
        c0 = fp.modsub(fq2_muli(B, 2), fq2_muli(fq2_mul(X, A), 3))
        cx = fq2_muli(fq2_mul(A, ZZ), 3)
        cy = fp.modneg(fq2_muli(fq2_mul(YZ, ZZ), 2))
        line = _line_embed(c0, _fq2_scale_fq(cx, xp), _fq2_scale_fq(cy, yp))
        f = fq12_sq(f)
        f = alg_mul(f, line, y_slots=LINE_SLOTS)
        X, Y, Z = X3, Y3, Z3
        if not bit:
            continue
        # mixed addition step (Q affine) + chord line
        ZZ = fq2_sq(Z)
        H = fp.modsub(fq2_mul(xq, ZZ), X)
        r = fp.modsub(fq2_mul(yq, fq2_mul(Z, ZZ)), Y)
        H2 = fq2_sq(H)
        H3 = fq2_mul(H, H2)
        V = fq2_mul(X, H2)
        X4 = fp.modsub(fp.modsub(fq2_sq(r), H3), fq2_muli(V, 2))
        Y4 = fp.modsub(fq2_mul(r, fp.modsub(V, X4)), fq2_mul(Y, H3))
        Z4 = fq2_mul(Z, H)
        c0 = fp.modsub(fq2_mul(Z4, yq), fq2_mul(r, xq))
        line = _line_embed(c0, _fq2_scale_fq(r, xp), _fq2_scale_fq(fp.modneg(Z4), yp))
        f = alg_mul(f, line, y_slots=LINE_SLOTS)
        X, Y, Z = X4, Y4, Z4
    f = fq12_conj(f)                       # t < 0
    if inf is not None:
        f = alg_select(inf, one12, f)
    return f


# --- final exponentiation -----------------------------------------------------


def _pow_bits(x, bits):
    """x^e over a static bit schedule for cyclotomic-subgroup x (every
    ladder input here is a power/Frobenius/conjugate of the easy part)."""
    return fq12_pow_bits_cyclotomic(x, bits)


def final_exponentiation(f: torch.Tensor) -> torch.Tensor:
    """f^(3 * (q^12-1)/r). The cube (gcd(3, r) = 1) keeps every is-one
    decision and admits the inversion-free x-chain hard part."""
    # easy part: f^((q^6-1)(q^2+1)); after it, inversion = conjugation
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_frob2(f1), f1)
    # hard part: f2^((x-1)^2 * (x+q) * (x^2+q^2-1)) * f2^3
    a = _pow_bits(_pow_bits(f2, _XP1_BITS), _XP1_BITS)   # (x-1)^2 = (|x|+1)^2
    b = fq12_mul(fq12_conj(_pow_bits(a, _X_BITS)), fq12_frob1(a))  # ^(x+q)
    c = fq12_mul(fq12_mul(_pow_bits(_pow_bits(b, _X_BITS), _X_BITS),
                          fq12_frob2(b)),
                 fq12_conj(b))                            # ^(x^2+q^2-1)
    return fq12_mul(fq12_mul(fq12_sq(f2), f2), c)


def pairing(p_aff, q_aff, inf=None):
    """Batched pairing e(P, Q)^3 as a dense Fq12 tensor."""
    return final_exponentiation(miller_loop(p_aff, q_aff, inf))


# --- G1 arithmetic (pubkey aggregation) ---------------------------------------


def _dbl(x):
    return fp.modadd(x, x)


def _mul8(x):
    return _dbl(_dbl(_dbl(x)))


def g1_double_jac(P):
    """a=0 Jacobian doubling; P [..., 3, 32]."""
    X, Y, Z = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    A = fp.modmul(X, X)
    B = fp.modmul(Y, Y)
    C = fp.modmul(B, B)
    t = fp.modadd(X, B)
    D = _dbl(fp.modsub(fp.modsub(fp.modmul(t, t), A), C))
    E = fp.modadd(fp.modadd(A, A), A)
    X3 = fp.modsub(fp.modmul(E, E), _dbl(D))
    Y3 = fp.modsub(fp.modmul(E, fp.modsub(D, X3)), _mul8(C))
    Z3 = _dbl(fp.modmul(Y, Z))
    return torch.stack([X3, Y3, Z3], dim=-2)


def g1_add_jac(P, Q):
    """Unified branch-free Jacobian add: either operand at infinity
    (Z = 0), P == Q (doubling) and P == -Q (infinity), every case computed
    and selected."""
    X1, Y1, Z1 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    X2, Y2, Z2 = Q[..., 0, :], Q[..., 1, :], Q[..., 2, :]
    Z1Z1 = fp.modmul(Z1, Z1)
    Z2Z2 = fp.modmul(Z2, Z2)
    U1 = fp.modmul(X1, Z2Z2)
    U2 = fp.modmul(X2, Z1Z1)
    S1 = fp.modmul(Y1, fp.modmul(Z2, Z2Z2))
    S2 = fp.modmul(Y2, fp.modmul(Z1, Z1Z1))
    H = fp.modsub(U2, U1)
    r = fp.modsub(S2, S1)
    H2 = fp.modmul(H, H)
    H3 = fp.modmul(H, H2)
    V = fp.modmul(U1, H2)
    X3 = fp.modsub(fp.modsub(fp.modmul(r, r), H3), _dbl(V))
    Y3 = fp.modsub(fp.modmul(r, fp.modsub(V, X3)), fp.modmul(S1, H3))
    Z3 = fp.modmul(H, fp.modmul(Z1, Z2))
    gen = torch.stack([X3, Y3, Z3], dim=-2)

    p_inf = fp.is_zero(Z1)
    q_inf = fp.is_zero(Z2)
    same_x = fp.is_zero(H) & ~p_inf & ~q_inf
    same_y = fp.is_zero(r)
    out = _sel(same_x & same_y, g1_double_jac(P), gen)
    out = _sel(same_x & ~same_y, torch.zeros_like(out), out)   # P + (-P)
    out = _sel(p_inf, Q, out)
    out = _sel(q_inf & ~p_inf, P, out)
    return out


def g1_sum_masked(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum of affine points: points [..., C, 2, 32], mask [..., C]
    -> Jacobian [..., 3, 32]. Unset lanes become infinity; a log2(C)
    unified-add tree does the reduction."""
    c = points.shape[-3]
    k = 1
    while k < c:
        k *= 2
    ones = fp.const(fp.ONE, points.device).expand(points.shape[:-3] + (c, fp.L))
    z = _sel(mask, ones, torch.zeros_like(ones))
    jac = torch.cat([points, z[..., None, :]], dim=-2)
    if k != c:
        pad = jac.new_zeros(points.shape[:-3] + (k - c, 3, fp.L))
        jac = torch.cat([jac, pad], dim=-3)
    while k > 1:
        k //= 2
        jac = g1_add_jac(jac[..., :k, :, :], jac[..., k:, :, :])
    return jac[..., 0, :, :]


def g1_to_affine(P):
    """Jacobian -> (affine [..., 2, 32], inf mask [...])."""
    X, Y, Z = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    zi = fp.modinv(fp.canon(Z))
    zi2 = fp.modmul(zi, zi)
    x = fp.modmul(X, zi2)
    y = fp.modmul(Y, fp.modmul(zi, zi2))
    return torch.stack([x, y], dim=-2), fp.is_zero(Z)


# --- FastAggregateVerify ------------------------------------------------------


def fast_aggregate_verify_batch(pk_table: torch.Tensor, committees: torch.Tensor,
                                bits: torch.Tensor, msg_g2: torch.Tensor,
                                sig_g2: torch.Tensor, sig_inf: torch.Tensor, *,
                                plain: bool = False, stages: dict | None = None
                                ) -> torch.Tensor:
    """Batched real-BLS FastAggregateVerify (pos-evolution.md:714-717).

    pk_table   [N, 2, 32]      affine G1 pubkeys (decompressed)
    committees [B, C] int      validator index per lane
    bits       [B, C] bool     aggregation bitlist
    msg_g2     [B, 2, 2, 32]   hashed messages on the twist
    sig_g2     [B, 2, 2, 32]   decompressed aggregate signatures
    sig_inf    [B]     bool    signature-at-infinity flags
    Returns bool[B]: e(sum pk, H(m)) == e(g1, sig), False for empty
    aggregates and infinity signatures (the oracle's semantics).

    The batch must be exactly 1-D: the pk-vs-H(m) and g1-vs-sig pairings
    ride one doubled Miller batch concatenated on axis 0. ``plain=True``
    sends CUDA tensors to the plain versions of K3-K5. ``stages``, when
    given, receives the intermediate tensors by name (``agg``, ``pk_aff``,
    ``miller``, ``final``)."""
    if committees.ndim != 2:
        raise ValueError(
            "fast_aggregate_verify_batch requires a 1-D batch "
            f"(committees [B, C]); got committees shape {tuple(committees.shape)}")
    with fp.plain_mode(plain):
        pks = pk_table[committees.long()]                # [B, C, 2, 32]
        agg = g1_sum_masked(pks, bits)
        pk_aff, pk_inf = g1_to_affine(agg)
        # one Miller batch over the doubled batch (pk vs H(m), g1 vs -sig)
        g1s = torch.cat([pk_aff, fp.const(_G1_GEN, pk_aff.device).expand(pk_aff.shape)], dim=0)
        g2s = torch.cat([msg_g2, g2_neg(sig_g2)], dim=0)
        infs = torch.cat([pk_inf, sig_inf], dim=0)
        fs = miller_loop(g1s, g2s, infs)
        b = pk_aff.shape[0]
        f = fq12_mul(fs[:b], fs[b:])
        fe = final_exponentiation(f)
        ok = alg_eq(fe, alg_one(12, f.shape[:-2], f.device))
        if stages is not None:
            stages.update(agg=agg, pk_aff=pk_aff, miller=fs, final=fe)
        return ok & ~pk_inf & ~sig_inf
