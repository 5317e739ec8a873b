"""Two-group-element KZG multiproof: one opening proof per committee (port
of ``pos_evolution_tpu/kzg/aggregate.py``).

All (blob, cell) claims a client committee sampled from one block fold into
two G1 elements:

    h(X)  = sum_i r_i * (f_{b_i}(X) - I_i(X)) / Z_i(X),     W  = [h(tau)]
    L(X)  = sum_i gamma_i * (f_{b_i}(X) - I_i(s))
            - Z_T(s) * h(X),        gamma_i = r_i * Z_T(s) / Z_i(s)
    W' = [L(tau) / (tau - s)]

with r_i and the second challenge s Fiat-Shamir-derived (s after W), Z_i
the coset vanishing polynomial X^m - z_i and Z_T the product over the
distinct sampled cosets. The verifier checks

    e(F + s*W', [1]_2) == e(W', [tau]_2),
    F = sum_b (sum_{i in b} gamma_i) C_b - [sum_i gamma_i I_i(s)]G - Z_T(s) W.

The transcript, the challenges and the host Fr integer work are the JAX
package's, copied. The group work runs on the port's device: the prover's
two MSMs over the setup's powers through ``ops/pairing.g1_msm_fixed``
(kernel K11's bucket route, over the setup's window tables), the
verifier's fold over ~10 arbitrary points through ``ops/pairing.g1_msm``
(K11's ladders), and the pairing equation as one lane-packed check on the port's
``miller_loop`` and ``final_exponentiation`` (kernels K3-K5): both sides
of the equation ride one Miller batch, then one product and one final
exponentiation decide it. A malformed proof is rejected; a device failure
raises (there is no fallback to the oracle pairing).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto.bls12_381 import G1_GEN, g1_compress, g1_decompress
from pos_evolution_tpu_torch.crypto.bls12_381 import R as _R
from pos_evolution_tpu_torch.kzg import curve, fr, ntt
from pos_evolution_tpu_torch.ops import fp, pairing
from pos_evolution_tpu_torch.ops.tower import alg_eq, alg_one, fq12_mul

__all__ = ["prove", "verify", "PROOF_TAG", "proof_n_bytes"]

PROOF_TAG = b"pevkzgagg1"


# --- Fiat-Shamir, domain and coset helpers (the JAX package's, copied) ----------

def _transcript(n_cells: int, m: int, wire_commitments, claims) -> bytes:
    h = hashlib.sha256()
    h.update(PROOF_TAG)
    h.update(int(n_cells).to_bytes(4, "little"))
    h.update(int(m).to_bytes(4, "little"))
    h.update(len(wire_commitments).to_bytes(4, "little"))
    for wc in wire_commitments:
        h.update(bytes(wc))
    h.update(len(claims).to_bytes(4, "little"))
    for blob, cell, values in claims:
        h.update(int(blob).to_bytes(4, "little"))
        h.update(int(cell).to_bytes(4, "little"))
        for v in values:
            h.update(int(v).to_bytes(32, "little"))
    return h.digest()


def _challenge(t0: bytes, label: bytes, extra: bytes = b"") -> int:
    d = hashlib.sha256(t0 + label + extra).digest()
    return int.from_bytes(d, "little") % _R


def _rs(t0: bytes, n: int) -> list[int]:
    return [_challenge(t0, b"r", i.to_bytes(4, "little"))
            for i in range(n)]


# --- domain / coset helpers (ints) --------------------------------------------

@lru_cache(maxsize=32)
def _coset_geometry(n_cells: int, m: int):
    """(z per cell, coset points per cell) for the N = n_cells*m domain
    with cell i's chunk j sitting at domain index i + n_cells*j."""
    n = n_cells * m
    dom = ntt.domain(n)
    zs = tuple(dom[(c * m) % n] for c in range(n_cells))
    points = tuple(tuple(dom[(c + n_cells * j) % n] for j in range(m))
                   for c in range(n_cells))
    return zs, points


def _interp_coeffs(values, cell: int, n_cells: int, m: int) -> list[int]:
    """Degree-<m coefficients of the polynomial through cell ``cell``'s
    coset evaluations: size-m INTT (values live on w^c * H in chunk
    order) then the X -> X/w^c coordinate twist."""
    b = fr.decode(ntt.ntt_host(fr.encode(values), inverse=True))
    n = n_cells * m
    dom = ntt.domain(n)
    w_c_inv = pow(dom[cell % n], -1, _R)
    out, tw = [], 1
    for t in range(m):
        out.append(b[t] * tw % _R)
        tw = tw * w_c_inv % _R
    return out


def _div_xm_z(p: list[int], z: int, m: int) -> tuple[list[int], list[int]]:
    """(quotient, remainder) of p by X^m - z: the top-down block
    recurrence q_t = p_{t+m} + z * q_{t+m}, O(len(p)) int muls."""
    n = len(p)
    q = [0] * max(n - m, 0)
    for t in range(n - m - 1, -1, -1):
        q[t] = (p[t + m] + (z * q[t + m] if t + m < n - m else 0)) % _R
    rem = [(p[j] + z * q[j]) % _R if j < len(q) else p[j] % _R
           for j in range(min(m, n))]
    return q, rem


def _poly_eval(p, x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % _R
    return acc


# --- prover -------------------------------------------------------------------


# --- the group work on the device ------------------------------------------------

def _msm(setup, scalars, plain: bool):
    """sum_j scalars[j] * [tau^j]G on the setup's device (K11's bucket MSM
    over the setup's window tables), as an oracle affine point or None."""
    k = len(scalars)
    if k > setup.n:
        raise ValueError(f"msm size {k} vs setup of {setup.n} powers")
    digits = fr.ints_to_digits(scalars, setup.points.device)[None]
    aff, inf = pairing.g1_msm_fixed(setup.window_tables(plain=plain), digits, plain=plain)
    return pairing.g1_decode_points(aff, inf)[0]


# --- prover -------------------------------------------------------------------

def prove(setup, n_cells: int, m: int, blobs, claims, *, plain: bool = False) -> dict:
    """Aggregate opening proof for one committee's sampled cells.

    setup:  a ``DeviceSetup`` of at least N = n_cells * m powers.
    blobs:  [(wire_commitment bytes32, point affine, coeffs list[int])]
            — one entry per distinct blob polynomial, coeffs length N.
    claims: [(blob_index, cell_id, values tuple[int] len m)].
    Returns {"points": [48B compressed C_b ...], "w": 48B, "wp": 48B}.
    ``plain=True`` takes the plain versions of the MSMs' kernels.
    """
    n = n_cells * m
    claims = sorted(((int(b), int(c), tuple(int(v) for v in values))
                     for b, c, values in claims), key=lambda t: t[:2])
    wires = [bytes(wc) for wc, _pt, _cf in blobs]
    t0 = _transcript(n_cells, m, wires, claims)
    rs = _rs(t0, len(claims))
    zs, _pts = _coset_geometry(n_cells, m)

    # h(X) = sum r_i * (f_i - I_i) / Z_i  — honest data divides exactly
    h = [0] * (n - m)
    for (blob, cell, values), r_i in zip(claims, rs):
        coeffs = blobs[blob][2]
        a = _interp_coeffs(values, cell, n_cells, m)
        num = [(coeffs[t] - (a[t] if t < m else 0)) % _R for t in range(n)]
        q, rem = _div_xm_z(num, zs[cell], m)
        assert not any(rem), "claim values do not lie on the polynomial"
        for t in range(n - m):
            h[t] = (h[t] + r_i * q[t]) % _R
    w_comp = g1_compress(_msm(setup, h, plain))

    s = _challenge(t0, b"s", w_comp)
    zt_s = 1
    for z in sorted({zs[cell] for _b, cell, _v in claims}):
        zt_s = zt_s * (pow(s, m, _R) - z) % _R
    gammas = [r_i * zt_s * pow(pow(s, m, _R) - zs[cell], -1, _R) % _R
              for (_b, cell, _v), r_i in zip(claims, rs)]

    # L(X) = sum gamma_i f_i(X) - [sum gamma_i I_i(s)] - Z_T(s) h(X)
    big_l = [0] * n
    const = 0
    for (blob, cell, values), g in zip(claims, gammas):
        coeffs = blobs[blob][2]
        for t in range(n):
            big_l[t] = (big_l[t] + g * coeffs[t]) % _R
        a = _interp_coeffs(values, cell, n_cells, m)
        const = (const + g * _poly_eval(a, s)) % _R
    big_l[0] = (big_l[0] - const) % _R
    for t in range(n - m):
        big_l[t] = (big_l[t] - zt_s * h[t]) % _R
    assert _poly_eval(big_l, s) == 0, "L(s) must vanish by construction"

    # W' = [L(tau) / (tau - s)]: synthetic division by (X - s)
    wp = [0] * (n - 1)
    carry = 0
    for t in range(n - 2, -1, -1):
        carry = (big_l[t + 1] + s * carry) % _R
        wp[t] = carry
    return {
        "points": [g1_compress(pt) for _wc, pt, _cf in blobs],
        "w": w_comp,
        "wp": g1_compress(_msm(setup, wp, plain)),
    }


def proof_n_bytes(proof: dict) -> int:
    return (sum(len(p) for p in proof["points"])
            + len(proof["w"]) + len(proof["wp"]))


# --- verifier -----------------------------------------------------------------

def _decompress_checked(comp: bytes):
    """48B -> affine point, subgroup-checked on the fast Jacobian path
    (the oracle's affine r-torsion check inverts per step)."""
    p = g1_decompress(bytes(comp))
    if p is not None and curve.jac_mul(p, _R)[2] != 0:
        raise ValueError("point not in the r-torsion subgroup")
    return p


def _verify_host(n_cells: int, m: int, wire_commitments, claims, proof: dict, wire_bind):
    """The verifier's host work (the JAX package's, up to its fold): False
    for a proof that fails before the group work, else the fold's (points,
    scalars) and W'."""
    try:
        claims = sorted(((int(b), int(c), tuple(int(v) % _R for v in values))
                         for b, c, values in claims), key=lambda t: t[:2])
        wires = [bytes(wc) for wc in wire_commitments]
        if len(proof["points"]) != len(wires):
            return False
        points = []
        for comp, wc in zip(proof["points"], wires):
            if wire_bind(bytes(comp)) != wc:
                return False                    # hash binding broken
            points.append(_decompress_checked(comp))
        w_point = _decompress_checked(proof["w"])
        wp_point = _decompress_checked(proof["wp"])

        t0 = _transcript(n_cells, m, wires, claims)
        rs = _rs(t0, len(claims))
        s = _challenge(t0, b"s", bytes(proof["w"]))
        zs, pts = _coset_geometry(n_cells, m)
        s_m = pow(s, m, _R)
        zt_s = 1
        for z in sorted({zs[cell] for _b, cell, _v in claims}):
            zt_s = zt_s * (s_m - z) % _R
        if zt_s == 0:                           # s hit the domain: 2^-224
            return False

        # I_i(s) by coset barycentric + the gamma-weighted commitment fold
        m_inv = pow(m, -1, _R)
        per_blob: dict[int, int] = {}
        const = 0
        for (blob, cell, values), r_i in zip(claims, rs):
            z = zs[cell]
            g = r_i * zt_s % _R * pow(s_m - z, -1, _R) % _R
            per_blob[blob] = (per_blob.get(blob, 0) + g) % _R
            acc = 0
            for x_j, v in zip(pts[cell], values):
                d = (s - x_j) % _R
                if d == 0:
                    return False
                acc = (acc + v * x_j % _R * pow(d, -1, _R)) % _R
            i_s = (s_m - z) * m_inv % _R * pow(z, -1, _R) % _R * acc % _R
            const = (const + g * i_s) % _R

        f_pts = [points[b] for b in per_blob]
        f_scs = [per_blob[b] for b in per_blob]
        f_pts += [G1_GEN, w_point, wp_point]
        f_scs += [(-const) % _R, (-zt_s) % _R, s]
        return f_pts, f_scs, wp_point
    except (ValueError, KeyError, IndexError, TypeError):
        return False


def verify(setup, n_cells: int, m: int, wire_commitments, claims,
           proof: dict, wire_bind, *, plain: bool = False) -> bool:
    """Check an aggregate proof. ``wire_commitments``: 32-byte wire
    commitment per blob index; ``claims`` as in :func:`prove`;
    ``wire_bind(compressed_point) -> bytes32`` is the scheme's binding
    hash (the sidecar commitment field is 32 bytes; the proof ships the
    real 48-byte points, bound by hash). The host work, then the fold
    F + s*W' as one K11 MSM and the pairing equation as one 2-lane check
    on ``setup``'s device."""
    got = _verify_host(n_cells, m, wire_commitments, claims, proof, wire_bind)
    if got is False:
        return False
    f_pts, f_scs, wp_point = got
    enc, inf = pairing.g1_encode_points(f_pts, setup.points.device)
    aff, is_inf = pairing.g1_msm(enc[None], inf[None], fr.ints_to_digits(f_scs, enc.device)[None],
                                 plain=plain)
    (lhs,) = pairing.g1_decode_points(aff, is_inf)
    return _pairing_check(lhs, wp_point, setup, plain)


@lru_cache(maxsize=8)
def _g2_lanes(g2_one, g2_tau) -> np.ndarray:
    """[2, 2, 2, 32] digits of [1]G2 and [tau]G2."""
    return np.stack([pairing.g2_affine_encode(g2_one), pairing.g2_affine_encode(g2_tau)])


def _pairing_check(lhs, wp_point, setup, plain: bool) -> bool:
    """e(lhs, [1]_2) == e(W', [tau]_2): both pairs ride one Miller batch of
    2 lanes (lhs against [1]_2, W' against -[tau]_2), then a product, one
    final exponentiation and a comparison with one."""
    dev = setup.points.device
    enc, inf = pairing.g1_encode_points([lhs, wp_point], dev)
    g2 = torch.from_numpy(_g2_lanes(setup.g2_one, setup.g2_tau)).to(dev)
    with fp.plain_mode(plain):
        fs = pairing.miller_loop(enc, torch.cat([g2[:1], pairing.g2_neg(g2[1:])]), inf)
        f = fq12_mul(fs[:1], fs[1:])
        ok = alg_eq(pairing.final_exponentiation(f), alg_one(12, f.shape[:-2], f.device))
    return bool(ok.item())
