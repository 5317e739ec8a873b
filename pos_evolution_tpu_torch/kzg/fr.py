"""BLS12-381 scalar field Fr as Montgomery digit arithmetic, and the
elementwise entry of kernel K10 (port of ``pos_evolution_tpu/kzg/fr.py``).

Representation, as the JAX package's: 22 little-endian digits of 12 bits
(264 >= 255 bits), Montgomery radix R = 2^264, residues lazily in
[0, 2r); REDC keeps them there (4r < R), one conditional subtract
canonicalizes. Both packages give the same digits for the same inputs.

Three versions, equal digit for digit:

- the **host twin**: batched NumPy int64 over ``[..., 22]`` digit vectors
  (``mont_mul`` ... ``batch_inv``), a copy of the JAX package's, kept as
  the oracle of the tests and for the provers' host integer work;
- the **plain versions** (``_mul``, ``_add``, ``_sub``, ``_canon``,
  ``_inv``, ``_from_mont``): PyTorch int32 on the port's base-field digit
  plumbing (``ops/fp.conv_digits``, ``carry_norm``, ``sub_digits``,
  ``cond_sub``), step for step the JAX device twin (``fr.py:288-323``);
- **kernel K10** (``csrc/fr_ntt.cu`` on ``csrc/fr381.cuh``): ``mul``,
  ``add``, ``sub``, ``neg``, ``canon``, ``inv`` and ``from_mont`` launch
  its elementwise entry for CUDA tensors; ``kzg/ntt.py`` launches its
  butterfly stages.

The wrappers pick by the tensor's device, as ``ops/fp.py``'s do: CUDA
tensors go to K10 (inside ``fp.plain_mode()`` to the plain versions), CPU
tensors to the plain versions. Nothing falls back. Digit inputs must be
canonical (each digit < 2^12), as every function here returns them.

Montgomery REDC without the sequential CIOS loop: with T = a*b,

    m = (T mod R) * n' mod R        (one truncated convolution)
    t = (T + m*r) / R               (one convolution, exact shift)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pos_evolution_tpu_torch.ops import fp, kernels

__all__ = [
    "MODULUS", "BITS", "MASK", "L", "R_MONT",
    "to_limbs", "from_limbs", "to_mont_int", "from_mont_int",
    "encode", "decode", "encode_int", "decode_int",
    "mont_mul", "mont_add", "mont_sub", "mont_neg", "mont_canon",
    "mont_inv", "mont_pow", "batch_inv",
    "ONE_M", "ZERO",
    "mul", "add", "sub", "neg", "canon", "inv", "to_mont", "from_mont",
    "ints_to_digits", "digits_to_ints",
]

# --- constants and the host twin (a copy of the JAX package's) ----------------

# the prime order of the BLS12-381 G1/G2 subgroups (crypto/bls12_381.R)
MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

BITS = 12
MASK = (1 << BITS) - 1
L = 22                      # 22 * 12 = 264 bits >= 255
R_MONT = 1 << (BITS * L)    # Montgomery radix 2^264; 4r < R_MONT

# n' = -r^(-1) mod R  (the REDC constant)
_NPRIME = (-pow(MODULUS, -1, R_MONT)) % R_MONT
# R^2 mod r (to_mont multiplier)
_R2 = R_MONT * R_MONT % MODULUS


def to_limbs(x: int, n: int = L) -> np.ndarray:
    """Python int -> little-endian base-2^12 digit vector (int64)."""
    assert 0 <= x
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        out[i] = x & MASK
        x >>= BITS
    assert x == 0, "value does not fit in the limb vector"
    return out


def from_limbs(v) -> int:
    out = 0
    for i, d in enumerate(np.asarray(v).reshape(-1).tolist()):
        out += int(d) << (BITS * i)
    return out


P = to_limbs(MODULUS)
TWO_P = to_limbs(2 * MODULUS)
NP = to_limbs(_NPRIME)
R2 = to_limbs(_R2)
ZERO = np.zeros(L, dtype=np.int64)
ONE_M = to_limbs(R_MONT % MODULUS)       # 1 in Montgomery form


def to_mont_int(x: int) -> int:
    return x * R_MONT % MODULUS


def from_mont_int(x: int) -> int:
    return x * pow(R_MONT, -1, MODULUS) % MODULUS


# --- host digit plumbing (NumPy int64, batch-leading [..., n]) ----------------

def _conv_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full digit-space product: [..., m] x [n] or [..., n] ->
    [..., m+n-1] column sums. b broadcasts like a second batch operand."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    m, n = a.shape[-1], b.shape[-1]
    outer = a[..., :, None] * b[..., None, :]
    out = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
                   + (m + n - 1,), dtype=np.int64)
    for j in range(n):                      # n is small/static (<= 22)
        out[..., j:j + m] += outer[..., :, j]
    return out


def _carry_np(x: np.ndarray, out_len: int) -> np.ndarray:
    """Normalize non-negative digit sums to canonical digits < 2^12 over
    ``out_len`` limbs (value must fit; carries past the top are dropped
    only when the caller guarantees they are zero). Host twin of
    fp.carry_norm — folds until fixpoint, same canonical result."""
    x = np.asarray(x, dtype=np.int64)
    pad = out_len - x.shape[-1]
    if pad > 0:
        x = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (pad,), dtype=np.int64)], axis=-1)
    elif pad < 0:
        raise ValueError("_carry_np cannot truncate")
    while (x >> BITS).any():
        c = x >> BITS
        x = (x & MASK)
        x[..., 1:] += c[..., :-1]
    return x


def _sub_np(x: np.ndarray, y: np.ndarray):
    """(x - y mod 2^(12*len), underflow) over canonical digit vectors."""
    x = np.asarray(x, dtype=np.int64)
    y = np.broadcast_to(np.asarray(y, dtype=np.int64), x.shape)
    n = x.shape[-1]
    d = x - y
    borrow = np.zeros(x.shape[:-1], dtype=np.int64)
    out = np.empty_like(d)
    for i in range(n):                      # n static and small
        t = d[..., i] - borrow
        borrow = (t < 0).astype(np.int64)
        out[..., i] = t + (borrow << BITS)
    return out, borrow.astype(bool)


def _cond_sub_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d, uf = _sub_np(x, y)
    return np.where(uf[..., None], x, d)


# --- host field ops: Montgomery residues in [0, 2r) ---------------------------

def mont_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """REDC(a * b): inputs/outputs Montgomery residues in [0, 2r).
    (2r)^2 < R*r, so t = (T + m*r)/R < 2r without any final subtract."""
    t = _carry_np(_conv_np(a, b), 2 * L)
    m = _carry_np(_conv_np(t[..., :L], NP), 2 * L)[..., :L]
    u = _conv_np(m, P)
    u = np.concatenate(
        [u, np.zeros(u.shape[:-1] + (2 * L + 1 - u.shape[-1],),
                     dtype=np.int64)], axis=-1)
    u[..., :2 * L] += t
    u = _carry_np(u, 2 * L + 1)
    # low L digits are exactly zero (u ≡ 0 mod R); the shift is a slice
    return u[..., L:2 * L]


def mont_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = _carry_np(np.asarray(a, dtype=np.int64)
                  + np.asarray(b, dtype=np.int64), L)
    return _cond_sub_np(s, TWO_P)


def mont_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d, uf = _sub_np(np.asarray(a, dtype=np.int64), b)
    wrapped = _carry_np(d + TWO_P, L + 1)[..., :L]
    return np.where(uf[..., None], wrapped, d)


def mont_neg(a: np.ndarray) -> np.ndarray:
    return mont_sub(np.broadcast_to(ZERO, np.asarray(a).shape), a)


def mont_canon(a: np.ndarray) -> np.ndarray:
    """[0, 2r) -> [0, r): canonical digits for equality/serialization."""
    return _cond_sub_np(np.asarray(a, dtype=np.int64), P)


_EXP_BITS = [(MODULUS - 2) >> i & 1
             for i in range(MODULUS.bit_length())][::-1]


def mont_pow(a: np.ndarray, e_bits=None) -> np.ndarray:
    """Square-and-multiply over a static bit string (default r-2:
    inversion by Fermat; 0 -> 0 by that convention)."""
    bits = _EXP_BITS if e_bits is None else e_bits
    acc = np.broadcast_to(ONE_M, np.asarray(a).shape).astype(np.int64)
    for bit in bits:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


mont_inv = mont_pow


def batch_inv(a: np.ndarray) -> np.ndarray:
    """Montgomery batch inversion over the last-but-one axis: [..., n, L]
    -> elementwise inverses with ONE Fermat inversion total (log-depth
    Hillis-Steele prefix products + a backward sweep). Raises on zero —
    callers invert challenge offsets that are nonzero with overwhelming
    probability, and a silent 0^-1 = 0 would forge-verify."""
    a = np.asarray(a, dtype=np.int64)
    n = a.shape[-2]
    if (mont_canon(a) == 0).all(axis=-1).any():
        raise ZeroDivisionError("batch_inv of zero element")
    prefix = a.copy()                       # prefix[i] = a[0]*...*a[i]
    shift = 1
    while shift < n:
        prefix[..., shift:, :] = mont_mul(prefix[..., shift:, :],
                                          prefix[..., :n - shift, :])
        shift *= 2
    total_inv = mont_inv(prefix[..., n - 1, :])
    out = np.empty_like(a)
    for i in range(n - 1, 0, -1):           # n small (<= domain size)
        out[..., i, :] = mont_mul(total_inv, prefix[..., i - 1, :])
        total_inv = mont_mul(total_inv, a[..., i, :])
    out[..., 0, :] = total_inv
    return out


# --- element <-> limb encodes (host arrays) -----------------------------------

def encode_int(x: int) -> np.ndarray:
    """Canonical int -> Montgomery limb vector."""
    return mont_mul(to_limbs(x % MODULUS), R2)


def decode_int(v: np.ndarray) -> int:
    """Montgomery limb vector -> canonical int."""
    one = np.zeros(L, dtype=np.int64)
    one[0] = 1
    return from_limbs(mont_canon(mont_mul(np.asarray(v, dtype=np.int64),
                                          one)))


def encode(xs) -> np.ndarray:
    """Iterable of ints -> [n, L] Montgomery limbs (vectorized REDC)."""
    arr = np.stack([to_limbs(int(x) % MODULUS) for x in xs])
    return mont_mul(arr, R2)


def decode(v: np.ndarray) -> list[int]:
    """[..., L] Montgomery limbs -> canonical ints."""
    one = np.zeros(L, dtype=np.int64)
    one[0] = 1
    canon = mont_canon(mont_mul(np.asarray(v, dtype=np.int64), one))
    flat = canon.reshape(-1, L)
    return [from_limbs(row) for row in flat]


# --- the plain versions (PyTorch int32, ops/fp.py digit plumbing) -------------
#
# Step for step the JAX package's device twin (fr.py:288-323): the same
# convolutions, carry normalizations and conditional subtracts, so the same
# digits, lazy residues included.

_P32 = P.astype(np.int32)
_TWO_P32 = TWO_P.astype(np.int32)
_NP32 = NP.astype(np.int32)
_ONE_M32 = ONE_M.astype(np.int32)
_R2_32 = R2.astype(np.int32)
_ONE32 = to_limbs(1).astype(np.int32)
_ZERO32 = ZERO.astype(np.int32)
_INV_BITS = np.asarray(_EXP_BITS, dtype=bool)      # r - 2, MSB first


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain REDC(a * b): Montgomery residues in [0, 2r) in and out."""
    t = fp.carry_norm(fp.conv_digits(a, b), 2 * L)
    m = fp.carry_norm(fp.conv_digits(t[..., :L], fp.const(_NP32, a.device)), 2 * L)[..., :L]
    u = fp.conv_digits(m, fp.const(_P32, a.device))
    u = torch.constant_pad_nd(u, (0, 2 * L + 1 - u.shape[-1]))
    u = torch.cat([u[..., :2 * L] + t, u[..., 2 * L:]], dim=-1)
    return fp.carry_norm(u, 2 * L + 1)[..., L:2 * L]


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = fp.carry_norm(a + b, L)
    return fp.cond_sub(s, fp.const(_TWO_P32, s.device))


def _sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, uf = fp.sub_digits(a, b)
    wrapped = fp.carry_norm(d + fp.const(_TWO_P32, d.device), L + 1)[..., :L]
    return torch.where(uf[..., None], wrapped, d)


def _canon(a: torch.Tensor) -> torch.Tensor:
    """[0, 2r) -> [0, r)."""
    return fp.cond_sub(a, fp.const(_P32, a.device))


def _inv(a: torch.Tensor) -> torch.Tensor:
    """a^(r-2) by square-and-multiply from one (0 -> 0, Fermat's
    convention): the JAX scan's order, its select taken in Python."""
    acc = fp.const(_ONE_M32, a.device).expand(a.shape)
    for bit in _INV_BITS:
        acc = _mul(acc, acc)
        if bit:
            acc = _mul(acc, a)
    return acc


def _from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery digits -> canonical digits of the value: REDC(a * 1),
    then one conditional subtract of r."""
    return _canon(_mul(a, fp.const(_ONE32, a.device).expand(a.shape)))


# --- K10's elementwise entry ------------------------------------------------------
#
# One launch computes out[e] = op(a[e], b[e]) over the broadcast batch; an
# operand is read in place at one element stride (0 broadcasts a constant).
# The op codes are csrc/fr_ntt.cu's.

OP_MUL, OP_ADD, OP_SUB, OP_CANON, OP_FROM_MONT, OP_INV = range(6)
_PLAIN_OPS = {OP_MUL: _mul, OP_ADD: _add, OP_SUB: _sub, OP_CANON: _canon,
              OP_FROM_MONT: _from_mont, OP_INV: _inv}


def _rows(t: torch.Tensor, batch: tuple):
    """(t, element stride in digits) for K10: ``t`` expanded to the batch,
    read in place where its batch dims collapse to one stride, else a
    contiguous copy."""
    t = t if t.shape[:-1] == batch else t.expand(batch + (L,))
    if t.stride(-1) == 1 and t.data_ptr() % 8 == 0:
        s = fp._batch_stride(batch, t.stride())
        if s is not None and s % 2 == 0:
            return t, s
    t = t.contiguous()
    return t, L


def _ew_kernel(op: int, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """K10's elementwise op over CUDA tensors, one launch."""
    ts = (a,) if b is None else (a, b)
    for t in ts:
        if t.dtype != torch.int32 or t.shape[-1] != L or t.device != a.device:
            raise ValueError(f"fr: want int32 [..., {L}] digits on {a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    batch = a.shape[:-1] if b is None else torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(batch + (L,), dtype=torch.int32, device=a.device)
    n = math.prod(batch)
    if not n:
        return out
    a_, sa = _rows(a, batch)
    b_, sb = (a_, 0) if b is None else _rows(b, batch)
    kernels.launch_on(a.device, "fr_ew", op, a_.data_ptr(), sa, b_.data_ptr(), sb,
                      out.data_ptr(), n)
    return out


def _dispatch(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    if b is not None and a.device != b.device:
        raise ValueError(f"fr: operands on {a.device} and {b.device}")
    if not fp.use_kernel(a):
        return _PLAIN_OPS[op](a) if b is None else _PLAIN_OPS[op](a, b)
    return _ew_kernel(op, a, b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a * b) over broadcast [..., 22] Montgomery digits."""
    return _dispatch(OP_MUL, a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _dispatch(OP_ADD, a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _dispatch(OP_SUB, a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _dispatch(OP_SUB, fp.const(_ZERO32, a.device).expand(a.shape), a)


def canon(a: torch.Tensor) -> torch.Tensor:
    """[0, 2r) -> [0, r): canonical Montgomery digits."""
    return _dispatch(OP_CANON, a)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(r-2) (0 -> 0): on the card one launch, each element's ladder in
    registers."""
    return _dispatch(OP_INV, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical digits of x -> Montgomery digits of x: REDC(x * R^2)."""
    return mul(a, fp.const(_R2_32, a.device).expand(a.shape))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery digits -> the canonical digits of the value, in [0, r)."""
    return _dispatch(OP_FROM_MONT, a)


# --- ints <-> digit tensors (host) --------------------------------------------------

def ints_to_digits(xs, device="cpu") -> torch.Tensor:
    """Python ints (reduced mod r) -> [n, 22] int32 canonical digits."""
    raw = b"".join((int(x) % MODULUS).to_bytes(33, "little") for x in xs)
    limbs = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 11, 3).astype(np.int32)
    limbs = limbs[..., 0] | (limbs[..., 1] << 8) | (limbs[..., 2] << 16)   # 24-bit limbs
    digits = np.stack([limbs & MASK, limbs >> BITS], axis=-1).reshape(-1, L)
    return torch.from_numpy(np.ascontiguousarray(digits)).to(device)


def digits_to_ints(t: torch.Tensor) -> list[int]:
    """[..., 22] canonical digits -> Python ints, row-major."""
    d = t.detach().cpu().numpy().reshape(-1, L).astype(np.int64)
    limbs = d[:, 0::2] | (d[:, 1::2] << BITS)                           # 24-bit limbs
    raw = np.stack([limbs & 0xFF, (limbs >> 8) & 0xFF, limbs >> 16], axis=-1)
    raw = raw.astype(np.uint8).reshape(d.shape[0], 33)
    return [int.from_bytes(row.tobytes(), "little") for row in raw]
