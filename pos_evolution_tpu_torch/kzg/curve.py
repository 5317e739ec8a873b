"""Inversion-free G1 group arithmetic on Python ints: the host MSM path,
a verbatim copy of ``pos_evolution_tpu/kzg/curve.py`` and the exact oracle
of the port's G1 multi-scalar multiply (kernel K11, ``ops/pairing.g1_msm``).

The oracle's affine ``ec_add``/``ec_mul`` (crypto/bls12_381.py) pay one
Fermat inversion mod Q *per step* — fine for pinning a pairing, hopeless
for the size-N multi-scalar multiplies a KZG commit needs. Here: Jacobian
coordinates (a = 0 curve, the same formulas as
``ops/pairing.g1_double_jac``/``g1_add_jac``), one shared batch inversion
at the very end to normalize back to affine, and a Pippenger
multi-scalar multiply.

Points: affine = (x, y) ints or None for infinity (oracle convention);
Jacobian = (X, Y, Z) with Z = 0 for infinity.
"""

from __future__ import annotations

from pos_evolution_tpu_torch.crypto.bls12_381 import Q

__all__ = [
    "to_jac", "jac_double", "jac_add", "jac_mul", "jac_to_affine",
    "batch_to_affine", "g1_lincomb",
]

_JAC_INF = (1, 1, 0)


def to_jac(p):
    return _JAC_INF if p is None else (p[0], p[1], 1)


def jac_double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return _JAC_INF if Y == 0 and Z != 0 else p
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    t = X + B
    D = 2 * (t * t - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def jac_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 == S2:
            return jac_double(p)
        return _JAC_INF
    H = (U2 - U1) % Q
    r = (S2 - S1) % Q
    H2 = H * H % Q
    H3 = H * H2 % Q
    V = U1 * H2 % Q
    X3 = (r * r - H3 - 2 * V) % Q
    Y3 = (r * (V - X3) - S1 * H3) % Q
    Z3 = H * Z1 * Z2 % Q
    return (X3, Y3, Z3)


def jac_mul(p, k: int):
    """Scalar multiply (double-and-add; k reduced by the caller)."""
    acc = _JAC_INF
    add = to_jac(p) if len(p) == 2 else p
    while k:
        if k & 1:
            acc = jac_add(acc, add)
        add = jac_double(add)
        k >>= 1
    return acc


def jac_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 * zi % Q)


def batch_to_affine(points) -> list:
    """Jacobian list -> affine list with ONE field inversion total
    (Montgomery's trick over the Z coordinates)."""
    zs = [p[2] for p in points]
    n = len(zs)
    prefix = [1] * (n + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * (z if z else 1) % Q
    inv_total = pow(prefix[n], -1, Q)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        z = zs[i]
        if z == 0:
            continue
        zi = inv_total * prefix[i] % Q
        inv_total = inv_total * z % Q
        zi2 = zi * zi % Q
        X, Y, _ = points[i]
        out[i] = (X * zi2 % Q, Y * zi2 * zi % Q)
    return out


def _msm(pairs):
    """Pippenger multi-scalar multiply: (affine point, int scalar)
    pairs -> affine sum (None = infinity). Window c = 8 — right-sized
    for the N <= a-few-hundred commit MSMs of the DAS grid."""
    pairs = [(p, s) for p, s in pairs if p is not None and s]
    if not pairs:
        return None
    c = 8
    max_bits = max(s.bit_length() for _, s in pairs)
    n_windows = (max_bits + c - 1) // c
    acc = _JAC_INF
    for w in range(n_windows - 1, -1, -1):
        for _ in range(c):
            acc = jac_double(acc)
        buckets: dict[int, tuple] = {}
        for p, s in pairs:
            d = (s >> (w * c)) & ((1 << c) - 1)
            if d:
                cur = buckets.get(d)
                buckets[d] = (jac_add(cur, to_jac(p)) if cur is not None
                              else to_jac(p))
        run, win = _JAC_INF, _JAC_INF
        for d in range(max(buckets) if buckets else 0, 0, -1):
            b = buckets.get(d)
            if b is not None:
                run = jac_add(run, b)
            win = jac_add(win, run)
        acc = jac_add(acc, win)
    return jac_to_affine(acc)


def g1_lincomb(points, scalars) -> tuple | None:
    """sum(s_i * P_i) over affine G1 points with int scalars (reduced
    mod r by the caller or here — either way exact)."""
    from pos_evolution_tpu_torch.crypto.bls12_381 import R
    pairs = [(p, s % R) for p, s in zip(points, scalars)]
    return _msm(pairs)
