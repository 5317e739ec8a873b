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
    fq2_sq,
    fq12_conj,
    fq12_frob1,
    fq12_frob2,
    fq12_inv,
    fq12_mul,
    fq12_pow_bits_cyclotomic,
    fq12_sq,
    tape_add,
    tape_canon,
    tape_muli,
    tape_neg,
    tape_sub,
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


# --- Jacobian doubling and addition as K4 tapes between multiplies ---------
#
# The a=0 Jacobian doubling (dbl-2009-l) and the unified addition, on G1
# (components (), multiplies by K3) and on the twist (components (2,), by
# K5): the multiplies that do not depend on each other run as one batched
# call, and every add/sub chain between them as one K4 tape, which also
# writes the next call's operands side by side. The values, op for op, are
# the unfused code's (the JAX package's).


def _double_tapes(name: str, comp: tuple, line: bool = False, triple=None):
    """The four tapes of a doubling of points [..., 3, *comp, 32]; with
    ``line`` also the tangent line's coefficients (the Miller loop).
    ``triple`` forms E = 3A as the unfused code did (``fq2_muli(A, 3)``
    by default)."""
    pt, c = (3,) + comp, comp
    k, j = (4, 2) if line else (2, 1)
    triple = triple or (lambda a: tape_muli(a, 3))

    def pre(S, sq1):                       # [B, X + B], to square
        return [sq1[1], tape_add(S[0], sq1[1])]

    def mid(S, sq1):                       # E = 3A; the operands of E^2, YZ (XA, A ZZ)
        X, Y, Z = S
        A, ZZ = sq1[0], sq1[2]
        E = triple(A)
        return ([E, Y, X, A], [E, Z, A, ZZ]) if line else ([E, Y], [E, Z])

    def t3(xs, sq1, sq2, p1):              # D, X3; the operands of E (D - X3) (, YZ ZZ)
        D = tape_muli(tape_sub(tape_sub(sq2[1], sq1[0]), sq2[0]), 2)
        X3 = tape_sub(p1[0], tape_muli(D, 2))
        DX = tape_sub(D, X3)
        return ([xs[0], p1[1]], [DX, sq1[2]], X3) if line else ([xs[0]], [DX], X3)

    def fin(X3, sq1, sq2, p1, p2):         # [X3, Y3, Z3] (, c0, [cx, cy])
        Y3 = tape_sub(p2[0], tape_muli(sq2[0], 8))
        Z3 = tape_muli(p1[1], 2)
        if not line:
            return [X3, Y3, Z3]
        c0 = tape_sub(tape_muli(sq1[1], 2), tape_muli(p1[2], 3))
        cxy = [tape_muli(p1[3], 3), tape_neg(tape_muli(p2[1], 2))]
        return [X3, Y3, Z3], c0, cxy

    kc, jc = (k,) + c, (j,) + c
    return (fp.make_tape(f"{name}_pre", (pt, pt), ((2,) + c,), pre),
            fp.make_tape(f"{name}_mid", (pt, pt), (kc, kc), mid),
            fp.make_tape(f"{name}_t3", (kc, pt, (2,) + c, kc), (jc, jc, c), t3),
            fp.make_tape(f"{name}_fin", (c, pt, (2,) + c, kc, jc),
                         (pt, c, (2,) + c) if line else (pt,), fin))


def _add_tapes(name: str, comp: tuple):
    """The three tapes of a unified addition of points [..., 3, *comp, 32]."""
    pt, c = (3,) + comp, comp

    def hr(U1, U2, S1, S2, P, Q):          # H, r, and the canons the case analysis reads
        H, r = tape_sub(U2, U1), tape_sub(S2, S1)
        return H, r, tape_canon([P[2], Q[2], H, r])

    def x3(rr, H3, V):                     # X3 = r^2 - H3 - 2V, and V - X3
        X3 = tape_sub(tape_sub(rr, H3), tape_muli(V, 2))
        return X3, tape_sub(V, X3)

    def gen(X3, rv, sh, Z3):               # [X3, r (V - X3) - S1 H3, Z3]
        return [X3, tape_sub(rv, sh), Z3]

    return (fp.make_tape(f"{name}_hr", (c, c, c, c, pt, pt), (c, c, (4,) + c), hr),
            fp.make_tape(f"{name}_x3", (c, c, c), (c, c), x3),
            fp.make_tape(f"{name}_gen", (c, c, c, c), (pt,), gen))


def _double(S, mul, tapes, pq=None):
    """Doubling of Jacobian points S [..., 3, *comp, 32] through ``tapes``
    (``_double_tapes``), ``mul`` the component multiply. With ``pq``, the
    affine G1 coordinates [..., 2, 2, 32] ([xp, xp], [yp, yp]), also the
    tangent line [..., 6, 32] (c0, cx xp, cy yp)."""
    pre, mid, t3, fin = tapes
    sq1 = mul(S, S)                                     # A, B, ZZ
    p = fp.run_tape(pre, S, sq1)
    sq2 = mul(p, p)                                     # C, (X + B)^2
    xs, ys = fp.run_tape(mid, S, sq1)
    p1 = mul(xs, ys)                                    # E^2, YZ (, XA, A ZZ)
    xs2, ys2, X3 = fp.run_tape(t3, xs, sq1, sq2, p1)
    p2 = mul(xs2, ys2)                                  # E (D - X3) (, YZ ZZ)
    if pq is None:
        return fp.run_tape(fin, X3, sq1, sq2, p1, p2)
    S3, c0, cxy = fp.run_tape(fin, X3, sq1, sq2, p1, p2)
    cxp, cyp = fp.modmul(cxy, pq).unbind(-3)
    return S3, _line_embed(c0, cxp, cyp)


def _add(P, Q, mul, tapes, double, axis: int):
    """Unified branch-free Jacobian add of points whose coordinates lie on
    ``axis`` (-2 on G1, -3 on the twist): either operand at infinity
    (Z = 0), P == Q (``double``) and P == -Q (infinity), every case
    computed and selected."""
    hr, x3, gen_tape = tapes
    X1, Y1, Z1 = P.unbind(axis)
    X2, Y2, Z2 = Q.unbind(axis)
    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(Y1, mul(Z2, Z2Z2))
    S2 = mul(Y2, mul(Z1, Z1Z1))
    H, r, canons = fp.run_tape(hr, U1, U2, S1, S2, P, Q)
    H2 = mul(H, H)
    H3 = mul(H, H2)
    V = mul(U1, H2)
    X3, VX = fp.run_tape(x3, mul(r, r), H3, V)
    gen = fp.run_tape(gen_tape, X3, mul(r, VX), mul(S1, H3), mul(H, mul(Z1, Z2)))

    p_inf, q_inf, h_zero, r_zero = (canons == 0).flatten(axis + 1).all(-1).unbind(-1)
    same_x = h_zero & ~p_inf & ~q_inf
    out = _sel(same_x & r_zero, double(P), gen)
    out = _sel(same_x & ~r_zero, torch.zeros_like(out), out)   # P + (-P)
    out = _sel(p_inf, Q, out)
    out = _sel(q_inf & ~p_inf, P, out)
    return out


# --- Miller loop --------------------------------------------------------------


def _line_embed(c0, cxp, cyp):
    """The three Fq2 line coefficients as the sparse [..., 6, 32] operand
    of ``alg_mul(..., y_slots=LINE_SLOTS)``."""
    return torch.cat([c0, cxp, cyp], dim=-2)


_MILLER_DOUBLE = _double_tapes("miller_double", (2,), line=True)


def _miller_add_x4(rr, H3, V):
    X4 = tape_sub(tape_sub(rr, H3), tape_muli(V, 2))
    return X4, tape_sub(V, X4)


_MILLER_ADD_X4 = fp.make_tape("miller_add_x4", ((2,), (2,), (2,)), ((2,), (2,)), _miller_add_x4)


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
    S = torch.cat([q_aff, alg_one(2, batch, dev)[..., None, :, :]], dim=-3)   # X, Y, Z = xq, yq, 1
    pq = p_aff[..., :, None, :].expand(batch + (2, 2, fp.L)).contiguous()
    for bit in _LOOP_BITS:
        # doubling step (a=0 Jacobian dbl-2009-l) + tangent line
        S, line = _double(S, alg_mul, _MILLER_DOUBLE, pq)
        f = fq12_sq(f)
        f = alg_mul(f, line, y_slots=LINE_SLOTS)
        if not bit:
            continue
        # mixed addition step (Q affine) + chord line
        X, Y, Z = S.unbind(-3)
        ZZ = fq2_sq(Z)
        H = fp.modsub(fq2_mul(xq, ZZ), X)
        r = fp.modsub(fq2_mul(yq, fq2_mul(Z, ZZ)), Y)
        H2 = fq2_sq(H)
        H3 = fq2_mul(H, H2)
        V = fq2_mul(X, H2)
        X4, VX = fp.run_tape(_MILLER_ADD_X4, fq2_sq(r), H3, V)
        Y4 = fp.modsub(fq2_mul(r, VX), fq2_mul(Y, H3))
        Z4 = fq2_mul(Z, H)
        c0 = fp.modsub(fq2_mul(Z4, yq), fq2_mul(r, xq))
        line = _line_embed(c0, _fq2_scale_fq(r, xp), _fq2_scale_fq(fp.modneg(Z4), yp))
        f = alg_mul(f, line, y_slots=LINE_SLOTS)
        S = torch.stack([X4, Y4, Z4], dim=-3)
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


_G1_DOUBLE = _double_tapes("g1_double", (), triple=lambda a: tape_add(tape_add(a, a), a))
_G1_ADD = _add_tapes("g1_add", ())


def g1_double_jac(P):
    """a=0 Jacobian doubling; P [..., 3, 32]."""
    return _double(P, fp.modmul, _G1_DOUBLE)


def g1_add_jac(P, Q):
    """Unified branch-free Jacobian add: either operand at infinity
    (Z = 0), P == Q (doubling) and P == -Q (infinity), every case computed
    and selected."""
    return _add(P, Q, fp.modmul, _G1_ADD, g1_double_jac, -2)


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
