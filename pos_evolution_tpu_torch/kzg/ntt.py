"""Batched radix-2 NTT/INTT over the 2^32 root-of-unity subgroup of Fr, and
kernel K10's butterfly stages (port of ``pos_evolution_tpu/kzg/ntt.py``).

r - 1 has 2-adicity 32; omega = 7^((r-1)/2^32) generates the 2^32
subgroup, and every power-of-two domain size n uses omega^(2^32/n).

Shapes: ``[..., n, 22]`` Montgomery digit vectors, transformed along the
-2 axis; batch dims lead. Decimation-in-time Cooley-Tukey with a
bit-reversal gather and per-stage twiddle tables of Montgomery constants
(``_plan``, a copy of the JAX package's). ``_transform`` is the shared
ladder: over the host twin's ops it is ``ntt_host``, the numpy oracle;
over ``kzg/fr.py``'s plain versions it is the plain version of K10.

``ntt``/``intt`` on a CUDA tensor launch K10 (``csrc/fr_ntt.cu``) once a
pass over all the batch (``passes``): the first runs 8 stages on tiles of
256 consecutive positions in shared memory, its rows gathered through the
bit reversal; each later one up to 9 stages over strided groups; the
last writes digit rows, with the n^-1 scale of an inverse. Between passes
an element is 8 words. The twiddles go to the card once per (n, inverse,
device), as 8-word rows. A CPU tensor (or ``fp.plain_mode()``) takes the
plain version. The tensor's device decides; nothing falls back.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from pos_evolution_tpu_torch.kzg import fr
from pos_evolution_tpu_torch.ops import fp, kernels

__all__ = ["OMEGA_2_32", "domain", "root_of_unity", "ntt", "intt", "ntt_host"]

# generator of the full 2^32 subgroup
OMEGA_2_32 = pow(7, (fr.MODULUS - 1) >> 32, fr.MODULUS)


@lru_cache(maxsize=64)
def root_of_unity(n: int) -> int:
    """Primitive n-th root of unity (n a power of two <= 2^32)."""
    assert n & (n - 1) == 0 and 0 < n <= (1 << 32), n
    return pow(OMEGA_2_32, (1 << 32) // n, fr.MODULUS)


@lru_cache(maxsize=64)
def domain(n: int) -> tuple[int, ...]:
    """The evaluation domain (1, w, w^2, ..., w^(n-1)) as ints."""
    w = root_of_unity(n)
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * w % fr.MODULUS
    return tuple(out)


@lru_cache(maxsize=64)
def _plan(n: int, inverse: bool):
    """(bit-reversal gather, per-stage twiddle tables, n^-1 scale) —
    host numpy Montgomery constants shared by both twins."""
    assert n & (n - 1) == 0 and n >= 1
    logn = n.bit_length() - 1
    rev = np.zeros(n, dtype=np.int64)
    for i in range(n):
        rev[i] = int(format(i, f"0{logn}b")[::-1], 2) if logn else 0
    w = root_of_unity(n)
    if inverse:
        w = pow(w, -1, fr.MODULUS)
    tables = []
    for s in range(logn):
        m2 = 1 << s                          # butterfly half-width
        step = n // (2 * m2)
        tw = [pow(w, step * j, fr.MODULUS) for j in range(m2)]
        tables.append(fr.encode(tw))
    scale = fr.encode([pow(n, -1, fr.MODULUS)])[0] if inverse else None
    return rev, tuple(tables), scale


def _transform(x, plan, ops, asarray):
    """The shared Cooley-Tukey ladder, parameterized over the field-op
    set (the host twin or the plain torch versions)."""
    rev, tables, scale = plan
    n = x.shape[-2]
    x = x[..., rev, :]
    for tw in tables:
        m2 = tw.shape[0]
        shp = x.shape[:-2] + (n // (2 * m2), 2, m2, fr.L)
        x = x.reshape(shp)
        a = x[..., 0, :, :]
        b = ops["mul"](x[..., 1, :, :], asarray(tw))
        x = ops["stack"]([ops["add"](a, b), ops["sub"](a, b)])
        x = x.reshape(x.shape[:-4] + (n, fr.L))
    if scale is not None:
        x = ops["mul"](x, asarray(scale))
    return x


_HOST_OPS = {
    "mul": fr.mont_mul,
    "add": fr.mont_add,
    "sub": fr.mont_sub,
    "stack": lambda xs: np.stack(xs, axis=-3),
}

_PLAIN_OPS = {
    "mul": fr._mul,
    "add": fr._add,
    "sub": fr._sub,
    "stack": lambda xs: torch.stack(xs, dim=-3),
}


def ntt_host(values: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host-NumPy transform: [..., n, L] Montgomery limbs -> same shape.
    Forward maps coefficients to evaluations on ``domain(n)``; inverse
    undoes it (with the n^-1 scale)."""
    values = np.asarray(values, dtype=np.int64)
    return _transform(values, _plan(values.shape[-2], bool(inverse)),
                      _HOST_OPS, lambda c: c)


@lru_cache(maxsize=64)
def _plan32(n: int, inverse: bool):
    """``_plan`` with its tables and scale as int32 digits (the arrays stay
    alive in the cache, so ``fp.const`` may key them by identity)."""
    rev, tables, scale = _plan(n, inverse)
    return (rev, tuple(t.astype(np.int32) for t in tables),
            None if scale is None else scale.astype(np.int32))


_TABLES: dict = {}      # (n, inverse, device) -> (twiddles [n-1, 8], scale [8]) words

# K10's passes: the first K10_FIRST_LOG stages (csrc/fr_ntt.cu's kTileLog;
# 8 measured fastest at 9 x 16,384 on an H100, of 6-10), each
# later one up to K10_LATER_LOG (its kLaterLog)
K10_FIRST_LOG, K10_LATER_LOG = 8, 9


def _words(digits: np.ndarray) -> np.ndarray:
    """[m, 22] canonical digits of values < 2^256 -> [m, 8] little-endian
    32-bit words, as int32 (K10's rows between passes)."""
    d = digits.astype(np.int64)
    limbs = d[:, 0::2] | (d[:, 1::2] << fr.BITS)                 # 24-bit limbs
    raw = np.stack([limbs & 0xFF, (limbs >> 8) & 0xFF, limbs >> 16], axis=-1)
    raw = np.ascontiguousarray(raw.astype(np.uint8).reshape(-1, 33)[:, :32])
    return raw.view("<u4").astype(np.uint32).view(np.int32).reshape(-1, 8)


def _tables(n: int, inverse: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K10's constants on ``device``: every stage's twiddles concatenated
    (stage s at row 2^s - 1) and the scale (one for a forward transform),
    as 8-word rows."""
    key = (n, inverse, torch.device(device))
    got = _TABLES.get(key)
    if got is None:
        _rev, tables, scale = _plan32(n, inverse)
        tw = np.concatenate(tables) if tables else np.zeros((1, fr.L), np.int32)
        sc = fr.ONE_M.astype(np.int32)[None] if scale is None else scale[None]
        got = _TABLES[key] = tuple(torch.from_numpy(_words(v)).to(device)
                                   for v in (tw, sc))
    return got


def passes(n: int) -> list[tuple[int, int]]:
    """K10's passes over a transform of size n >= 2: (first stage, end)."""
    logn = n.bit_length() - 1
    out = [(0, min(logn, K10_FIRST_LOG))]
    while out[-1][1] < logn:
        s = out[-1][1]
        out.append((s, min(logn, s + K10_LATER_LOG)))
    return out


def _ntt_plain(values: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain version of K10's transform: ``_transform`` over ``fr``'s plain
    ops."""
    return _transform(values, _plan32(values.shape[-2], inverse), _PLAIN_OPS,
                      lambda c: fp.const(c, values.device))


def _ntt_kernel(values: torch.Tensor, inverse: bool) -> torch.Tensor:
    """K10: one launch a pass (``passes``) over the whole batch."""
    n = values.shape[-2]
    if values.dtype != torch.int32 or values.shape[-1] != fr.L:
        raise ValueError(f"ntt: want int32 [..., n, {fr.L}] digits, got {values.dtype} "
                         f"{tuple(values.shape)}")
    if n == 1:                       # the gather is the identity, the scale 1^-1
        _rev, _tables1, scale = _plan32(1, inverse)
        return fr.mul(values, fp.const(scale, values.device).expand(values.shape)) \
            if inverse else values.clone()
    tw, scale = _tables(n, inverse, values.device)
    g = math.prod(values.shape[:-2])
    src = values.contiguous()
    if not g:
        return src.clone()
    plan = passes(n)
    words = [torch.empty((g, n, 8), dtype=torch.int32, device=values.device)
             for _ in range(min(len(plan) - 1, 2))]
    out = torch.empty_like(src)
    for i, (s0, s1) in enumerate(plan):
        last = i == len(plan) - 1
        dst = out if last else words[i % 2]
        flags = (1 if i == 0 else 0) | (2 if last else 0) | (4 if inverse and last else 0)
        kernels.launch_on(values.device, "fr_ntt", src.data_ptr(), dst.data_ptr(),
                          tw.data_ptr(), scale.data_ptr(), g, n, s0, s1, flags)
        src = dst
    return out


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Transform [..., n, 22] Montgomery digits along the -2 axis: K10 for
    a CUDA tensor (a launch a pass: two at n = 16,384), the plain version
    for a CPU tensor.
    Forward maps coefficients to evaluations on ``domain(n)``."""
    n = values.shape[-2]
    if n < 1 or n & (n - 1):
        raise ValueError(f"ntt: the size must be a power of two, got {n}")
    if not fp.use_kernel(values):
        return _ntt_plain(values, bool(inverse))
    return _ntt_kernel(values, bool(inverse))


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)
