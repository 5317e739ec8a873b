"""Deterministic insecure-but-sound trusted setup (powers of tau), on the
card (port of ``pos_evolution_tpu/kzg/setup.py``).

tau is derived from a public seed, so every node and every resumed
checkpoint regenerates the identical setup from the chain config alone:
**insecure** (anyone can forge openings who reads this file) but sound
in the sense the commitment scheme's binding needs, the SRS being
well-formed powers [tau^j]G.

``trusted_setup`` is the JAX package's host computation, copied: the
oracle of the tests (Python-int Jacobian ladders, one batch
normalization). ``device_setup`` computes the same powers on the scheme's
device: the scalars tau^j on the host, then one launch of kernel K11's
ladders with every lane's point G (``ops/pairing.g1_msm_lanes``), and the
affine normalization on the card (one K3 inversion ladder). At the
PeerDAS domain of 16,384 powers the host path would take minutes a
process; the result is memoized per (n, seed, device).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

import torch

from pos_evolution_tpu_torch.crypto.bls12_381 import G1_GEN, G2_GEN, R, ec_mul, g1_compress
from pos_evolution_tpu_torch.device import resolve_device
from pos_evolution_tpu_torch.kzg import curve, fr
from pos_evolution_tpu_torch.ops import fp, pairing

__all__ = ["TrustedSetup", "DeviceSetup", "trusted_setup", "device_setup", "tau_from_seed"]


def tau_from_seed(seed: int) -> int:
    """The toxic waste, in the open: tau = H("pos-evo-kzg-tau" || seed)
    reduced mod r (nonzero by construction for every practical seed)."""
    d = hashlib.sha256(b"pos-evo-kzg-tau" + int(seed).to_bytes(8, "little"))
    tau = int.from_bytes(d.digest(), "little") % R
    return tau if tau > 1 else tau + 2


@dataclass(frozen=True)
class TrustedSetup:
    """Powers of tau: [tau^j]G1 for j < n, plus [1]G2 and [tau]G2 (the
    only G2 elements the two-element multiproof check needs)."""

    n: int
    seed: int
    powers_g1: tuple            # n affine G1 points (ints)
    g2_one: tuple               # G2 affine (Fq2 pair)
    g2_tau: tuple

    @property
    def powers_g1_compressed(self) -> tuple:
        return tuple(g1_compress(p) for p in self.powers_g1)


@lru_cache(maxsize=8)
def trusted_setup(n: int, seed: int = 0) -> TrustedSetup:
    """The (n, seed)-keyed setup on the host, memoized per process: the
    oracle of ``device_setup``."""
    tau = tau_from_seed(seed)
    jac = []
    t = 1
    for _ in range(n):
        jac.append(curve.jac_mul(curve.to_jac(G1_GEN), t))
        t = t * tau % R
    powers = tuple(curve.batch_to_affine(jac))
    g2_tau = ec_mul(G2_GEN, tau)
    return TrustedSetup(n=n, seed=int(seed), powers_g1=powers,
                        g2_one=G2_GEN, g2_tau=g2_tau)


@dataclass(frozen=True)
class DeviceSetup:
    """The same powers on a device: ``points`` [n, 2, 32] int32 canonical
    affine digits (``ops/pairing`` encoding), ``inf`` [n] bool, and the G2
    pair as host affine points."""

    n: int
    seed: int
    points: torch.Tensor
    inf: torch.Tensor
    g2_one: tuple
    g2_tau: tuple

    def powers_g1(self) -> list:
        """The powers as oracle affine points (a host read)."""
        return pairing.g1_decode_points(self.points, self.inf)


_DEVICE: dict = {}


def _tau_powers(n: int, seed: int) -> list[int]:
    """tau^j mod r for j < n."""
    tau = tau_from_seed(seed)
    out, t = [], 1
    for _ in range(n):
        out.append(t)
        t = t * tau % R
    return out


def device_setup(n: int, seed: int = 0, device="cuda", *, plain: bool = False) -> DeviceSetup:
    """[tau^j]G for j < n on ``device``, memoized per (n, seed, device):
    one K11 launch of n lanes (every lane's point G, scalar tau^j), then the
    affine normalization, on the card; the plain versions on the CPU or
    with ``plain``. The points are canonical affine digits, so a memo hit
    serves either version."""
    dev = resolve_device(device)
    key = (int(n), int(seed), dev)
    got = _DEVICE.get(key)
    if got is not None:
        return got
    with fp.plain_mode(plain):
        scalars = fr.ints_to_digits(_tau_powers(n, seed), dev)[None]
        gen = fp.const(pairing._G1_GEN, dev).expand(n, 2, fp.L)
        inf = torch.zeros(n, dtype=torch.bool, device=dev)
        lanes = pairing.g1_msm_lanes(gen, inf, scalars)[0]
        aff, is_inf = pairing.g1_to_affine(lanes)
        points = fp.canon(aff)
    tau = tau_from_seed(seed)
    got = _DEVICE[key] = DeviceSetup(n=int(n), seed=int(seed), points=points, inf=is_inf,
                                     g2_one=G2_GEN, g2_tau=_g2_tau(tau))
    return got


@lru_cache(maxsize=8)
def _g2_tau(tau: int):
    return ec_mul(G2_GEN, tau)
