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
- **G1 multi-scalar multiply** (the KZG slice; JAX ``_g1_msm_kernel``,
  ``g1_msm_device_entry``): kernel K11 (``csrc/g1_msm.cu``), batched over G
  blobs of n lanes. Each lane runs the JAX package's MSB-first
  double-and-add ladder over its canonical Fr scalar digits; the lanes fold
  by a tree of unified adds, 64 lanes a block and then 64 partials a block
  until one is left (the JAX package's sequential fold was for XLA's
  compile time; the affine sum is the same); ``g1_to_affine`` on K3's
  inversion ladder gives canonical affine coordinates. Over a trusted
  setup's powers, ``g1_msm_fixed`` takes K11's bucket route instead: a
  fixed-base, signed-window bucket MSM over the setup's window tables
  (``csrc/g1_bucket.cu``, ``g1_fill.cu``, ``g1_totals.cu``,
  ``g1_reduce.cu``), with its plain version
  stage by stage here.

Every multiply and add goes through ``ops/fp.py`` and ``ops/tower.py``:
kernels K3-K5 on CUDA tensors, their plain versions on CPU tensors or
within ``fp.plain_mode`` (``fast_aggregate_verify_batch(plain=True)``).
K11's plain version runs the same ladder and tree through those plain
ops, every multiply of one dependency level in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
from pos_evolution_tpu_torch.ops import fp, kernels
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


# --- G1 multi-scalar multiply (the KZG slice, kernel K11) ---------------------

MSM_BLOCK = 64           # lanes a K11 block folds: csrc/g1_msm.cu's kT
FR_BITS = 255            # the scalars' bits, r < 2^255
FR_DIGITS = 22           # canonical Fr digits a scalar (kzg/fr.py)


def _muls(*pairs):
    """The products of independent (a, b) pairs in one ``fp.modmul`` call."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return fp.modmul(a, b).unbind(0)


def _g1_add_plain(P, Q):
    """``g1_add_jac`` with each dependency level's multiplies in one call and
    the doubling computed only where a lane takes it: the same values, the
    plain version of K11's unified add."""
    hr, x3, gen_tape = _G1_ADD
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    Z1Z1, Z2Z2 = _muls((Z1, Z1), (Z2, Z2))
    U1, U2, t1, t2, Z1Z2 = _muls((X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1), (Z1, Z2))
    S1, S2 = _muls((Y1, t1), (Y2, t2))
    H, r, canons = fp.run_tape(hr, U1, U2, S1, S2, P, Q)
    H2, rr, Z3 = _muls((H, H), (r, r), (H, Z1Z2))
    H3, V = _muls((H, H2), (U1, H2))
    X3, VX = fp.run_tape(x3, rr, H3, V)
    rVX, S1H3 = _muls((r, VX), (S1, H3))
    out = fp.run_tape(gen_tape, X3, rVX, S1H3, Z3)
    p_inf, q_inf, h_zero, r_zero = (canons == 0).all(-1).unbind(-1)
    same_x = h_zero & ~p_inf & ~q_inf
    dbl = same_x & r_zero
    if bool(dbl.any()):
        out = _sel(dbl, g1_double_jac(P), out)
    out = _sel(same_x & ~r_zero, torch.zeros_like(out), out)   # P + (-P)
    out = _sel(p_inf, Q, out)
    return _sel(q_inf & ~p_inf, P, out)


def _scalar_bits(scalars: torch.Tensor) -> torch.Tensor:
    """[..., 22] canonical Fr digits -> [..., 255] bits, most significant
    first."""
    k = torch.arange(FR_BITS - 1, -1, -1, device=scalars.device)
    return ((scalars[..., k // fp.BITS] >> (k % fp.BITS)) & 1).bool()


def _lane_points(points, inf, shape):
    """Affine points [.., n, 2, 32] and their infinity flags -> the lanes'
    Jacobian addends [G, n, 3, 32]: Z = 1, or 0 for an infinity lane."""
    one = fp.const(fp.ONE, points.device).expand(inf.shape + (fp.L,))
    z = _sel(inf, torch.zeros_like(one), one)
    return torch.cat([points, z[..., None, :]], dim=-2).expand(shape + (3, fp.L))


def _msm_lanes_plain(points, inf, scalars):
    """Plain version of K11's ladders: lane (g, j) = s_gj * P_gj, MSB-first
    double-and-add from the zero point, the sum taken at the lanes whose
    bit is set (computed there only: each lane's values are its own).
    Steps before the batch's first set bit only double the zero point, and
    are skipped."""
    shape = scalars.shape[:-1]
    pj = _lane_points(points, inf, shape).reshape(-1, 3, fp.L).contiguous()
    bits = _scalar_bits(scalars).reshape(-1, FR_BITS)
    acc = torch.zeros(pj.shape, dtype=torch.int32, device=scalars.device)
    live = bits.any(0).nonzero()
    for i in range(int(live[0]) if live.numel() else FR_BITS, FR_BITS):
        acc = g1_double_jac(acc)
        idx = bits[:, i].nonzero().squeeze(1)
        if idx.numel():
            acc = acc.index_copy(0, idx, _g1_add_plain(acc.index_select(0, idx),
                                                       pj.index_select(0, idx)))
    return acc.reshape(shape + (3, fp.L))


def _fold_round_plain(jac):
    """One round of K11's fold: [G, n, 3, 32] -> [G, ceil(n / 64), 3, 32],
    each block of 64 lanes (the zero point past n) summed by the halving
    tree lane t += lane t + k, k = 32 ... 1."""
    g, n = jac.shape[:2]
    nb = -(-n // MSM_BLOCK)
    x = torch.constant_pad_nd(jac, (0, 0, 0, 0, 0, nb * MSM_BLOCK - n))
    x = x.reshape(g, nb, MSM_BLOCK, 3, fp.L)
    k = MSM_BLOCK
    while k > 1:
        k //= 2
        x = _g1_add_plain(x[:, :, :k], x[:, :, k:2 * k])
    return x[:, :, 0]


def _fold_plain(jac):
    """Plain version of K11's whole fold: rounds until one point a blob."""
    while True:
        jac = _fold_round_plain(jac)
        if jac.shape[1] == 1:
            return jac[:, 0]


def _check_msm(points, inf, scalars):
    """(points [G|1, n, 2, 32], inf [G|1, n]) after checking the MSM's
    operands: scalars int32 [G, n, 22], points int32 [G|1, n, 2, 32] or
    [n, 2, 32], inf of the points' batch shape, all on one device."""
    if scalars.dim() != 3 or scalars.shape[-1] != FR_DIGITS or scalars.dtype != torch.int32:
        raise ValueError(f"g1_msm: scalars must be int32 [G, n, {FR_DIGITS}], got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    g, n = scalars.shape[:2]
    if points.dim() not in (3, 4) or points.shape[-3:] != (n, 2, fp.L) \
            or points.dtype != torch.int32 or inf.shape != points.shape[:-2]:
        raise ValueError(f"g1_msm: points must be int32 [G|1, {n}, 2, {fp.L}] with inf "
                         f"[G|1, {n}], got {tuple(points.shape)} and {tuple(inf.shape)}")
    if points.dim() == 3:
        points, inf = points[None], inf[None]
    if points.shape[0] not in (1, g):
        raise ValueError(f"g1_msm: {points.shape[0]} point rows for {g} blobs")
    if points.device != scalars.device or inf.device != scalars.device:
        raise ValueError(f"g1_msm: points on {points.device}, inf on {inf.device}, "
                         f"scalars on {scalars.device}")
    return points, inf


def _msm_args(points, inf, scalars):
    """(points, inf, scalars, their element strides) as K11 reads them:
    points with packed (2, 32) rows at a 16-byte aligned lane stride
    (copied otherwise), inf as bytes, scalars with packed digits."""
    points, inf = _check_msm(points, inf, scalars)
    if (points.stride(-1), points.stride(-2)) != (1, fp.L) or points.data_ptr() % 16 \
            or points.stride(1) % 4 or points.stride(0) % 4:
        points = points.contiguous()
    if scalars.stride(-1) != 1:
        scalars = scalars.contiguous()
    inf = inf.to(torch.uint8)
    blob = points.shape[0] > 1
    return (points, points.stride(1), points.stride(0) if blob else 0,
            inf, inf.stride(1), inf.stride(0) if blob else 0,
            scalars, scalars.stride(1), scalars.stride(0))


def _msm_launch(args, out, fold: bool):
    points, pl, pb, inf, il, ib, scalars, sl, sb = args
    g, n = scalars.shape[:2]
    kernels.launch_on(scalars.device, "g1_msm", points.data_ptr(), pl, pb, inf.data_ptr(),
                      il, ib, scalars.data_ptr(), sl, sb, out.data_ptr(), g, n, int(fold))


def g1_msm_lanes(points, inf, scalars) -> torch.Tensor:
    """Every lane's s_gj * P_gj, Jacobian [G, n, 3, 32]: points [G|1, n, 2,
    32] affine (a shared row broadcasts over the blobs), inf [G|1, n] bool,
    scalars [G, n, 22] canonical Fr digits. One K11 launch for CUDA tensors
    (the trusted setup's powers), the plain version for CPU tensors."""
    if not fp.use_kernel(scalars):
        return _msm_lanes_plain(*_check_msm(points, inf, scalars), scalars)
    args = _msm_args(points, inf, scalars)
    g, n = scalars.shape[:2]
    out = torch.empty((g, n, 3, fp.L), dtype=torch.int32, device=scalars.device)
    if g and n:
        _msm_launch(args, out, False)
    return out


def g1_fold(jac: torch.Tensor) -> torch.Tensor:
    """Sum each blob's Jacobian points: [G, n, 3, 32] -> [G, 3, 32], by
    K11's tree (one launch a round of 64) on the card."""
    if not fp.use_kernel(jac):
        return _fold_plain(jac)
    jac = jac.contiguous()
    while jac.shape[1] > 1:
        g, n = jac.shape[:2]
        out = torch.empty((g, -(-n // MSM_BLOCK), 3, fp.L), dtype=torch.int32, device=jac.device)
        kernels.launch_on(jac.device, "g1_fold", jac.data_ptr(), out.data_ptr(), g, n)
        jac = out
    return jac[:, 0]


def g1_msm(points, inf, scalars, *, plain: bool = False):
    """sum_j s_gj * P_gj per blob: (canonical affine [G, 2, 32], infinity
    [G]). points [G|1, n, 2, 32] affine, inf [G|1, n], scalars [G, n, 22]
    canonical Fr digits. On the card one K11 launch for the ladders and the
    first fold round, one a further round of 64 partials, then the affine
    normalization (one K3 ladder, K3 products, K4's canon); ``plain=True``
    or CPU tensors take the plain versions."""
    with fp.plain_mode(plain):
        if scalars.dim() != 3 or not scalars.shape[1]:
            raise ValueError(f"g1_msm: no lanes in scalars {tuple(scalars.shape)}")
        g, n = scalars.shape[:2]
        if fp.use_kernel(scalars):
            args = _msm_args(points, inf, scalars)
            part = torch.empty((g, -(-n // MSM_BLOCK), 3, fp.L), dtype=torch.int32,
                               device=scalars.device)
            _msm_launch(args, part, True)
            total = g1_fold(part)
        else:
            total = _fold_plain(_msm_lanes_plain(*_check_msm(points, inf, scalars), scalars))
        aff, is_inf = g1_to_affine(total)
        return fp.canon(aff), is_inf


# --- the fixed-base bucket MSM over the setup's window tables (K11's bucket route) ---
#
# sum_j s_j P_j where the P_j are the setup's powers: window tables T[w, j] =
# 2^(c w) P_j (``g1_window_tables``, built once with the setup) make it one set
# of B = 2^(c-1) buckets a blob. Each scalar is recoded into W = floor(256 / c)
# + 1 signed digits d_w in [-2^(c-1), 2^(c-1)] (s = sum_w d_w 2^(c w); c W > 256,
# so no 256-bit scalar carries out of the top window, a lazy residue in [r, 2r)
# included), +-T[w, j] joins bucket |d_w|, and the sum is sum_b b B_b. Every
# stage is a launch (csrc/g1_bucket.cu and the three sources it names) and a
# plain version here, the same ops on the same operands in the same order, so
# each stage's result is the kernel's digit for digit (the file's header has
# the design): recode (signed digits, counts), scan and scatter (a stable counting
# sort: bucket, then window, then lane), fill (runs of one bucket inside chunks
# of MSM_CHUNK sorted entries, by mixed adds from the zero point), totals (each
# bucket's runs joined), reduce (S + sum_k 2^k Q_k up a binary tree over the
# buckets, then Horner).

MSM_WINDOW = 13          # c of the setup's tables (bench_k1011.py --c sweeps it)
MSM_CHUNK = 32           # sorted entries a fill thread sums (csrc/g1_bucket.cuh's kChunk)
MSM_SUBTREE = 64         # buckets whose tree levels the totals launch builds


def msm_windows(c: int) -> int:
    """W: windows of c bits with c W > 256, so that no scalar below 2^256
    carries out of the top one."""
    return 256 // c + 1


class WindowTables:
    """A setup's fixed-base tables: ``points`` [W, n, 2, 32] canonical affine
    digits of 2^(c w) P_j and ``inf`` [W, n] bool. Passing them to
    ``g1_msm_fixed`` is what selects the bucket route."""

    def __init__(self, c: int, points: torch.Tensor, inf: torch.Tensor):
        if not 2 <= c <= 16 or points.dim() != 4 or points.shape[0] != msm_windows(c) \
                or points.shape[2:] != (2, fp.L) or inf.shape != points.shape[:2]:
            raise ValueError(f"window tables: c = {c}, points {tuple(points.shape)}, "
                             f"inf {tuple(inf.shape)}")
        self.c, self.points, self.inf = int(c), points.contiguous(), inf
        self.inf_u8 = inf.to(torch.uint8).contiguous()

    @property
    def n(self) -> int:
        return self.points.shape[1]

    @property
    def buckets(self) -> int:
        return 1 << (self.c - 1)


def _double_windows_plain(jac, windows: int, c: int):
    """Plain version of the tables' doublings: [n, 3, 32] -> [windows, n, 3,
    32], window w the points doubled c (w + 1) times."""
    out = []
    for _ in range(windows):
        for _ in range(c):
            jac = g1_double_jac(jac)
        out.append(jac)
    return torch.stack(out)


def _batch_inverse(z):
    """z^-1 of nonzero [m, 32] digits by a product tree (Montgomery's trick):
    pairwise products up to one, its inverse (one K3 ladder of one element),
    then each pair's inverses from its product's and the other's; ~4 m
    products in 2 log2 m batched calls."""
    levels = [z]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        if x.shape[0] % 2:
            x = torch.cat([x, fp.ones_like(x[:1])])
        levels.append(fp.modmul(x[0::2], x[1::2]))
    inv = fp.modinv(fp.canon(levels[-1]))
    for x in reversed(levels[:-1]):
        m = x.shape[0]
        if m % 2:
            x = torch.cat([x, fp.ones_like(x[:1])])
        both = fp.modmul(torch.cat([inv, inv]), torch.cat([x[1::2], x[0::2]]))
        inv = torch.stack(both.chunk(2), dim=1).reshape(-1, fp.L)[:m]
    return inv


def g1_window_tables(points, inf, c: int = MSM_WINDOW) -> WindowTables:
    """The window tables of affine points [n, 2, 32] (inf [n]): window 0 the
    points, window w their (c w)-fold doubling (on the card one launch of
    c (W - 1) doublings a lane), then the affine pass by one batch inversion
    (``_batch_inverse``) and ``fp.canon``: the canonical digits, which
    ``g1_to_affine`` would give as well."""
    n, w = points.shape[0], msm_windows(c)
    if not 2 <= c <= 16 or points.shape != (n, 2, fp.L) or inf.shape != (n,) or not n:
        raise ValueError(f"g1_window_tables: c = {c}, points {tuple(points.shape)}, "
                         f"inf {tuple(inf.shape)}")
    jac = _tables_jac(points, inf)
    if fp.use_kernel(points):
        dbl = torch.empty((w - 1, n, 3, fp.L), dtype=torch.int32, device=points.device)
        kernels.launch_on(points.device, "g1_bucket_tables", jac.data_ptr(), dbl.data_ptr(),
                          n, w - 1, c)
    else:
        dbl = _double_windows_plain(jac, w - 1, c)
    return _affine_tables(points, inf, dbl, c)


def _tables_jac(points, inf):
    """The affine points [n, 2, 32] as Jacobian [n, 3, 32] (Z = 1, or 0 at
    infinity), contiguous: the tables' doubling launch's input."""
    one = fp.const(fp.ONE, points.device).expand(points.shape[0], fp.L)
    return torch.cat([points, _sel(inf, torch.zeros_like(one), one)[:, None]], dim=1).contiguous()


def _affine_tables(points, inf, dbl, c: int) -> WindowTables:
    """The tables from the points and their doublings [W - 1, n, 3, 32]: the
    affine pass (one batch inversion, ``fp.canon``)."""
    n, w = points.shape[0], msm_windows(c)
    X, Y, Z = dbl.reshape(-1, 3, fp.L).unbind(1)
    is_inf = fp.is_zero(Z)
    zi = _batch_inverse(_sel(is_inf, fp.ones_like(Z), Z))
    zi2 = fp.modmul(zi, zi)
    x, zi3 = _muls((X, zi2), (zi, zi2))
    aff = torch.stack([x, fp.modmul(Y, zi3)], dim=1).reshape(w - 1, n, 2, fp.L)
    aff = _sel(is_inf.reshape(w - 1, n), torch.zeros_like(aff), fp.canon(aff))
    return WindowTables(c, torch.cat([fp.canon(points)[None], aff]),
                        torch.cat([inf[None], is_inf.reshape(w - 1, n)]))


def _recode_plain(scalars, c: int):
    """Plain version of the recode: Fr digits [G, k, 22] -> (signed window
    digits [G, W, k] int32, each window's bucket counts [G, W, B]). Like the
    kernel it reads a scalar's low 256 bits, so every 256-bit value (a lazy
    residue in [r, 2r) too) is recoded exactly, with no carry out of the top
    window."""
    g, k = scalars.shape[:2]
    s = torch.nn.functional.pad(scalars.to(torch.int64), (0, 3))
    s[..., FR_DIGITS - 1] &= (1 << (256 - fp.BITS * (FR_DIGITS - 1))) - 1
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros((g, k), dtype=torch.int64, device=scalars.device)
    digits = []
    for w in range(msm_windows(c)):
        q, sh = divmod(c * w, fp.BITS)
        v = torch.zeros_like(carry)
        if q < FR_DIGITS:
            v = ((s[..., q] | (s[..., q + 1] << fp.BITS) | (s[..., q + 2] << 2 * fp.BITS))
                 >> sh) & (full - 1)
        v = v + carry
        carry = (v > half).to(torch.int64)
        digits.append(v - carry * full)
    dig = torch.stack(digits, dim=1)
    cnt = torch.zeros((g, msm_windows(c), half + 1), dtype=torch.int64, device=dig.device)
    cnt.scatter_add_(2, dig.abs(), torch.ones_like(dig))
    return dig.to(torch.int32), cnt[..., 1:].to(torch.int32)


def _scan_plain(cnt):
    """Plain version of the scan: each window's bucket counts [G, W, B] ->
    (bucket starts [G, B + 1], each window's first positions [G, W, B])."""
    c64 = cnt.long()
    start = torch.nn.functional.pad(torch.cumsum(c64.sum(1), 1), (1, 0))
    offsets = start[:, None, :-1] + torch.cumsum(c64, 1) - c64
    return start.to(torch.int32), offsets.to(torch.int32)


def _scatter_plain(dig, n_tab: int, nb: int):
    """Plain version of the scatter: the entries [G, W k], w n_tab + j with
    bit 31 set for a negative digit, in bucket, then window, then lane order;
    0 past a blob's last."""
    g, w, k = dig.shape
    dev = dig.device
    mag = dig.abs().long().reshape(g, w * k)
    key = (torch.arange(w, device=dev)[:, None] * n_tab
           + torch.arange(k, device=dev)[None, :]).reshape(-1)
    order = torch.argsort(torch.where(mag > 0, mag - 1, nb) * (w * n_tab) + key, dim=1)
    neg = (dig < 0).reshape(g, w * k).long()
    ent = key[order] - (torch.gather(neg, 1, order) << 31)
    ent = torch.where(torch.gather(mag, 1, order) > 0, ent, torch.zeros_like(ent))
    return ent.to(torch.int32)


def _g1_add_bucket_plain(P, Q):
    """Plain version of the bucket route's unified add (totals and reduce):
    ``_g1_add_plain``'s ops, but where P = Q it doubles (U1, S1, Z1 Z2), the
    representation of P scaled by Z2 that the kernel still holds."""
    X1, Y1, Z1 = P.unbind(-2)
    X2, Y2, Z2 = Q.unbind(-2)
    Z1Z1, Z2Z2 = _muls((Z1, Z1), (Z2, Z2))
    U1, U2, t1, t2, Z1Z2 = _muls((X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1), (Z1, Z2))
    S1, S2 = _muls((Y1, t1), (Y2, t2))
    H, r = fp.modsub(U2, U1), fp.modsub(S2, S1)
    H2, rr = _muls((H, H), (r, r))
    H3, V, Z3 = _muls((H, H2), (U1, H2), (H, Z1Z2))
    X3 = fp.modsub(fp.modsub(rr, H3), fp.modadd(V, V))
    rVX, S1H3 = _muls((r, fp.modsub(V, X3)), (S1, H3))
    out = torch.stack([X3, fp.modsub(rVX, S1H3), Z3], dim=-2)
    p_inf, q_inf, h_zero, r_zero = (fp.is_zero(v) for v in (Z1, Z2, H, r))
    same_x = h_zero & ~p_inf & ~q_inf
    dbl = same_x & r_zero
    if bool(dbl.any()):
        out = _sel(dbl, g1_double_jac(torch.stack([U1, S1, Z1Z2], dim=-2)), out)
    out = _sel(same_x & ~r_zero, torch.zeros_like(out), out)
    out = _sel(p_inf, Q, out)
    return _sel(q_inf & ~p_inf, P, out)


def _g1_madd_plain(P, x2, y2, q_inf):
    """Plain version of the fill's mixed add P + (x2, y2): the unified add
    with Z2 = 1 (U1 = X1, S1 = Y1, Z1 Z2 = Z1; 11 products), every case
    computed and selected (Q at infinity where ``q_inf``)."""
    X1, Y1, Z1 = P.unbind(-2)
    (Z1Z1,) = _muls((Z1, Z1))
    U2, t2 = _muls((x2, Z1Z1), (Z1, Z1Z1))
    (S2,) = _muls((y2, t2))
    H, r = fp.modsub(U2, X1), fp.modsub(S2, Y1)
    H2, rr = _muls((H, H), (r, r))
    H3, V, Z3 = _muls((H, H2), (X1, H2), (H, Z1))
    X3 = fp.modsub(fp.modsub(rr, H3), fp.modadd(V, V))
    rVX, Y1H3 = _muls((r, fp.modsub(V, X3)), (Y1, H3))
    out = torch.stack([X3, fp.modsub(rVX, Y1H3), Z3], dim=-2)
    p_inf, h_zero, r_zero = fp.is_zero(Z1), fp.is_zero(H), fp.is_zero(r)
    same_x = h_zero & ~p_inf & ~q_inf
    dbl = same_x & r_zero
    if bool(dbl.any()):
        out = _sel(dbl, g1_double_jac(P), out)
    out = _sel(same_x & ~r_zero, torch.zeros_like(out), out)
    one = fp.const(fp.ONE, P.device).expand(x2.shape)
    q = torch.stack([x2, y2, _sel(q_inf, torch.zeros_like(one), one)], dim=-2)
    out = _sel(p_inf, q, out)
    return _sel(q_inf & ~p_inf, P, out)


def _fill_plain(tables: WindowTables, ent, start):
    """Plain version of the fill: (part [G, chunks, 3, 32], bsum [G, B, 3,
    32]), each run of one bucket inside a chunk of MSM_CHUNK summed from the
    zero point, its r-th entries of every run in one batched mixed add."""
    chunk = MSM_CHUNK
    g, cap = ent.shape
    nb = start.shape[1] - 1
    dev = ent.device
    chunks = -(-cap // chunk)
    part = torch.zeros((g, chunks, 3, fp.L), dtype=torch.int32, device=dev)
    bsum = torch.zeros((g, nb, 3, fp.L), dtype=torch.int32, device=dev)
    st = start.long()
    pos = torch.arange(cap, device=dev).expand(g, cap)
    gi, p = (pos < st[:, nb:]).nonzero(as_tuple=True)
    if not p.numel():
        return part, bsum
    bkt = torch.searchsorted(st[:, 1:].contiguous(), pos.contiguous(), right=True)[gi, p]
    head = (p % chunk == 0) | (p == st[gi, bkt])
    run = torch.cumsum(head.long(), 0) - 1
    run_p = p[head]
    rank = p - run_p[run]
    val = ent[gi, p].long() & 0x7FFFFFFF
    neg = ent[gi, p] < 0
    x2 = tables.points.reshape(-1, 2, fp.L)[val, 0]
    y2 = tables.points.reshape(-1, 2, fp.L)[val, 1]
    y2 = _sel(neg, fp.modneg(y2), y2)
    q_inf = tables.inf.reshape(-1)[val]
    acc = torch.zeros((int(run_p.numel()), 3, fp.L), dtype=torch.int32, device=dev)
    for r in range(int(rank.max()) + 1):
        at = (rank == r).nonzero().squeeze(1)
        ids = run[at]
        acc = acc.index_copy(0, ids, _g1_madd_plain(acc.index_select(0, ids), x2[at], y2[at],
                                                    q_inf[at]))
    rg, rb = gi[head], bkt[head]
    first = run_p % chunk == 0
    part[rg[first], run_p[first] // chunk] = acc[first]
    bsum[rg[~first], rb[~first]] = acc[~first]
    return part, bsum


def _totals_plain(part, bsum, start):
    """Plain version of the totals: each bucket's first run (its chunk's part
    where the bucket starts a chunk, else its bsum) plus the parts of the
    chunks that continue it, in order: [G, B, 3, 32]."""
    chunk = MSM_CHUNK
    g, nb = bsum.shape[:2]
    s, e = start[:, :-1].long(), start[:, 1:].long()
    t0 = s // chunk
    gi = torch.arange(g, device=part.device)[:, None].expand(g, nb)
    first = _sel(s % chunk == 0, part[gi, t0.clamp(max=part.shape[1] - 1)], bsum)
    empty = e == s
    acc = _sel(empty, torch.zeros_like(first), first)
    more = torch.where(empty, 0, (e - 1) // chunk - t0)
    for q in range(1, int(more.max()) + 1 if more.numel() else 1):
        at = (more >= q).nonzero(as_tuple=True)
        acc[at] = _g1_add_bucket_plain(acc[at], part[at[0], t0[at] + q])
    return acc


def _reduce_plain(totals):
    """Plain version of the tree's levels (the totals launch's and the
    reduce's) and the reduce: [G, B, 3, 32] bucket sums -> sum_b b B_b [G,
    3, 32]. The tree level by level (a node's S and Q_0.. in one batched add
    with its sibling's), then 2^k Q_k (Q_k doubled k times) and a halving
    tree over S, Q_0, 2 Q_1, .. (an odd last point carried up)."""
    level = totals[:, :, None]                  # [G, nodes, points, 3, 32]
    while level.shape[1] > 1:
        lo, hi = level[:, 0::2], level[:, 1::2]
        level = torch.cat([_g1_add_bucket_plain(lo, hi), hi[:, :, :1]], dim=2)
    pts = level[:, 0]                           # S, Q_0 .. Q_(H-1)
    for d in range(1, pts.shape[1] - 1):        # point k + 1 doubled k times
        pts = torch.cat([pts[:, :d + 1], g1_double_jac(pts[:, d + 1:])], dim=1)
    while pts.shape[1] > 1:
        m, half = pts.shape[1], pts.shape[1] // 2
        summed = _g1_add_bucket_plain(pts[:, 0:2 * half:2], pts[:, 1:2 * half:2])
        pts = torch.cat([summed, pts[:, m - 1:]], dim=1) if m % 2 else summed
    return pts[:, 0]


def _bucket_plain(tables: WindowTables, scalars, stages):
    dig, cnt = _recode_plain(scalars, tables.c)
    start, offsets = _scan_plain(cnt)
    ent = _scatter_plain(dig, tables.n, tables.buckets)
    part, bsum = _fill_plain(tables, ent, start)
    totals = _totals_plain(part, bsum, start)
    total = _reduce_plain(totals)
    stages.update(digits=dig, offsets=offsets, start=start, entries=ent, totals=totals,
                  total=total)
    return total


def _bucket_kernel(tables: WindowTables, scalars, stages):
    """The seven launches of K11's bucket route (six an MSM; the tables' at
    setup)."""
    dev = scalars.device
    g, k = scalars.shape[:2]
    c, nb, w = tables.c, tables.buckets, msm_windows(tables.c)
    scalars = scalars.contiguous()
    i32 = torch.int32
    dig = torch.empty((g, w, k), dtype=i32, device=dev)
    offsets = torch.zeros((g, w, nb), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_recode", scalars.data_ptr(), dig.data_ptr(),
                      offsets.data_ptr(), g, k, c)
    start = torch.empty((g, nb + 1), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_scan", offsets.data_ptr(), start.data_ptr(), g, w, nb)
    ent = torch.zeros((g, w * k), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_scatter", dig.data_ptr(), offsets.data_ptr(),
                      ent.data_ptr(), g, k, tables.n, c)
    part = torch.empty((g, -(-(w * k) // MSM_CHUNK), 3, 12), dtype=i32, device=dev)
    bsum = torch.empty((g, nb, 3, 12), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_fill", tables.points.data_ptr(), tables.inf_u8.data_ptr(),
                      ent.data_ptr(), start.data_ptr(), part.data_ptr(), bsum.data_ptr(), g,
                      w * k, nb)
    totals = torch.empty((g, nb, 3, fp.L), dtype=i32, device=dev)
    sub_n = min(nb, MSM_SUBTREE)
    sub = torch.empty((g, nb // sub_n, sub_n.bit_length(), 3, 12), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_totals", part.data_ptr(), bsum.data_ptr(),
                      start.data_ptr(), totals.data_ptr(), sub.data_ptr(), g, w * k, nb)
    scratch = torch.empty((2, g, nb // 2, 3, 12), dtype=i32, device=dev)
    total = torch.empty((g, 3, fp.L), dtype=i32, device=dev)
    kernels.launch_on(dev, "g1_bucket_reduce", sub.data_ptr(), scratch.data_ptr(),
                      total.data_ptr(), g, nb)
    stages.update(digits=dig, offsets=offsets, start=start, entries=ent, totals=totals,
                  total=total)
    return total


def g1_msm_fixed(tables: WindowTables, scalars, *, plain: bool = False,
                 stages: dict | None = None):
    """sum_j s_gj * P_j over a setup's powers, by their window tables:
    (canonical affine [G, 2, 32], infinity [G]). scalars [G, k, 22] Fr digits
    below 2^256 (canonical, or lazy in [r, 2r)), k <= tables.n (the first k
    powers). On the card the six
    launches of K11's bucket route, then the affine pass (one K3 ladder, K3
    products, K4's canon); ``plain=True`` or CPU tensors take the plain
    versions. ``stages``, when given, receives each stage's result by name
    (``digits``, ``offsets``, ``start``, ``entries``, ``totals``, ``total``)."""
    with fp.plain_mode(plain):
        if scalars.dim() != 3 or scalars.shape[-1] != FR_DIGITS \
                or scalars.dtype != torch.int32 or not 1 <= scalars.shape[1] <= tables.n:
            raise ValueError(f"g1_msm_fixed: scalars must be int32 [G, 1..{tables.n}, "
                             f"{FR_DIGITS}], got {scalars.dtype} {tuple(scalars.shape)}")
        if scalars.device != tables.points.device:
            raise ValueError(f"g1_msm_fixed: scalars on {scalars.device}, tables on "
                             f"{tables.points.device}")
        got = {} if stages is None else stages
        if fp.use_kernel(scalars):
            total = _bucket_kernel(tables, scalars, got)
        else:
            total = _bucket_plain(tables, scalars, got)
        aff, is_inf = g1_to_affine(total)
        return fp.canon(aff), is_inf


def g1_encode_points(pts, device="cpu"):
    """Oracle affine points (ints or None) -> (int32 [n, 2, 32], bool [n])."""
    enc = np.stack([g1_affine_encode(p) for p in pts]) if pts else \
        np.zeros((0, 2, fp.L), np.int32)
    return (torch.from_numpy(enc).to(device),
            torch.tensor([p is None for p in pts], dtype=torch.bool, device=device))


def g1_decode_points(aff: torch.Tensor, inf: torch.Tensor) -> list:
    """Canonical affine [..., 2, 32] digits and infinity flags -> oracle
    points (int pairs, None for infinity), row-major."""
    a = aff.detach().cpu().numpy().reshape(-1, 2, fp.L).astype(np.int64)
    flags = inf.detach().cpu().numpy().reshape(-1).tolist()
    w = [1 << (fp.BITS * i) for i in range(fp.L)]
    return [None if f else (sum(int(d) * x for d, x in zip(row[0].tolist(), w)),
                            sum(int(d) * x for d, x in zip(row[1].tolist(), w)))
            for row, f in zip(a, flags)]

