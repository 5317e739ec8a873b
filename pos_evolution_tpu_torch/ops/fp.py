"""BLS12-381 base-field arithmetic on int32 digit tensors, and kernels K3
and K4 (port of ``pos_evolution_tpu/ops/fp.py``).

An element of Fq is an int32 tensor ``[..., 32]`` of little-endian
base-2^12 digits, a lazy residue in [0, 2p): the JAX package's radix,
width and domain, so both packages give the same digits for the same
inputs. Products are reduced by plain Barrett with MU = floor(2^768 / p)
(no Montgomery form, which would give other representatives).

Each op has its plain PyTorch version here, a step-for-step mirror of the
JAX algorithm: digit convolution by broadcast-multiply-and-sum (a
Toeplitz gather of one operand: PyTorch has no integer matmul on CUDA),
three carry folds, and the carry/borrow lookahead as explicit shifted
(generate, propagate) rounds where JAX used ``associative_scan``. Results
come back as int32 (``sum`` is asked for int32 outright).

The wrappers pick by the tensor's device. CUDA tensors go to the kernels,
written by hand for Hopper (``csrc/fp_modmul.cu`` for ``modmul``,
``csrc/fp_addsub.cu`` for ``modadd``/``modsub``/``modneg``/``canon``);
CPU tensors to the plain versions. Inside ``plain_mode()`` CUDA tensors
take the plain versions too: the reference the kernels are held against.
Nothing falls back: a kernel that fails to build or launch raises.

Digit inputs to the kernels are canonical (each digit in [0, 2^12)), as
every function here returns them.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F

from pos_evolution_tpu_torch.crypto.bls12_381 import Q as P_INT
from pos_evolution_tpu_torch.ops import kernels

BITS = 12
MASK = (1 << BITS) - 1
L = 32                       # limbs per element: 32 * 12 = 384 bits
CONV = 2 * L - 1             # full-product digit count


def to_limbs(x: int, n: int = L) -> np.ndarray:
    """Python int -> little-endian base-2^12 digit vector (host side)."""
    assert x >= 0
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= BITS
    assert x == 0, "value does not fit in the limb vector"
    return out


def from_limbs(v) -> int:
    """Digit vector -> Python int (host side; accepts unnormalized)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    out = 0
    for i, d in enumerate(np.asarray(v).tolist()):
        out += int(d) << (BITS * i)
    return out


P = to_limbs(P_INT)
TWO_P = to_limbs(2 * P_INT)              # 2p < 2^384: fits 32 limbs
MU = to_limbs(2**768 // P_INT, 33)       # Barrett constant, 33 limbs
ZERO = np.zeros(L, dtype=np.int32)
ONE = to_limbs(1)

_P_MINUS_2_BITS = np.array(
    [(P_INT - 2) >> i & 1 for i in range(P_INT.bit_length())][::-1],
    dtype=bool)

# K4's op codes (csrc/fp_addsub.cu)
OP_ADD, OP_SUB, OP_NEG, OP_CANON = 0, 1, 2, 3


# --- device, constants and the plain switch -------------------------------------

_PLAIN = contextvars.ContextVar("fp_plain", default=False)


@contextlib.contextmanager
def plain_mode(on: bool = True):
    """Within the block, CUDA tensors take the plain versions of K3-K5
    (an entry point's ``plain=True``)."""
    token = _PLAIN.set(on)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True where ``t``'s op launches a kernel: a CUDA tensor outside
    ``plain_mode``. CPU tensors take the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no field kernels for device {t.device}")
    return not _PLAIN.get()


_CONSTS: dict = {}


def const(a: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on ``device``, cached."""
    dev = torch.device(device)
    key = (id(a), dev)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        _CONSTS[key] = (t, a)          # keeps ``a`` alive, so its id stays unique
        return t
    return t[0]


def ones_like(a: torch.Tensor) -> torch.Tensor:
    """The field's one, broadcast to ``a``'s shape (a contiguous tensor)."""
    return const(ONE, a.device).expand(a.shape).contiguous()


# --- digit plumbing (plain versions) ---------------------------------------------

# 0-dim constants: a tensor operand dispatches faster than a Python scalar
_MASK_T = torch.tensor(MASK, dtype=torch.int32)
_BITS_T = torch.tensor(BITS, dtype=torch.int32)
_ZERO_T = torch.tensor(0, dtype=torch.int32)


def _shift_up(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """x[..., i - k] at position i, ``fill`` in the k lowest places."""
    return torch.constant_pad_nd(x[..., :-k], (k, 0), fill)


def _lookahead(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of the (generate, propagate) composition over the
    last axis, carry out of each position: ceil(log2 n) shifted rounds
    (5 for 32 digits, 6 for 33-64, 7 for 66), each combining position i
    with i - d; the places below d combine with the identity (0, 1)."""
    n = g.shape[-1]
    d = 1
    while d < n:
        g = g | (p & _shift_up(g, d, False))
        if 2 * d < n:
            p = p & _shift_up(p, d, True)
        d *= 2
    return g


_TOEPLITZ: dict = {}


def _toeplitz(m: int, n: int, device) -> torch.Tensor:
    """[m+n-1, m] index into n digits plus one zero: entry (k, i) = k - i
    where 0 <= k - i < n, else n (the zero)."""
    key = (m, n, torch.device(device))
    if key not in _TOEPLITZ:
        k = np.arange(m + n - 1)[:, None]
        i = np.arange(m)[None, :]
        idx = np.where((k - i >= 0) & (k - i < n), k - i, n)
        _TOEPLITZ[key] = torch.from_numpy(idx.astype(np.int64)).to(device)
    return _TOEPLITZ[key]


def conv_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product in digit space: [..., m] x [..., n] -> [..., m+n-1]
    column sums (each <= 33 * (2^12-1)^2 < 2^30, int32), batch dims
    broadcast: column k = sum_i a[i] * b[k - i], by a gather of b into
    its shifted rows and one broadcast multiply-and-sum."""
    m, n = a.shape[-1], b.shape[-1]
    rows = F.pad(b, (0, 1))[..., _toeplitz(m, n, b.device)]     # [..., m+n-1, m]
    return (rows * a[..., None, :]).sum(-1, dtype=torch.int32)


def carry_norm(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Normalize non-negative digit sums (< 2^31) to canonical digits over
    ``out_len`` limbs (carries past the top limb are dropped): 3 local
    fold rounds bring digits to <= 2^12, then the single-bit carries
    resolve by the lookahead."""
    pad = out_len - x.shape[-1]
    if pad > 0:
        x = torch.constant_pad_nd(x, (0, pad))
    elif pad < 0:
        raise ValueError("carry_norm cannot truncate")
    for _ in range(3):
        x = (x & _MASK_T) + _shift_up(x >> _BITS_T, 1)
    gs = _lookahead(x > _MASK_T, x == _MASK_T)
    return (x + _shift_up(gs, 1, False)) & _MASK_T


def sub_digits(x: torch.Tensor, y: torch.Tensor):
    """(x - y mod 2^(12 n), underflow) over canonical digit vectors of
    equal length; borrows resolve by the same lookahead."""
    t = x - y                                  # digits in [-4095, 4095]
    gs = _lookahead(t < _ZERO_T, t == _ZERO_T)
    u = t - _shift_up(gs, 1, False).to(torch.int32)    # digits in [-4096, 4095]
    return u & _MASK_T, gs[..., -1]            # u + 2^12 where u < 0


def cond_sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y if x >= y else x (canonical digits in, canonical out)."""
    d, uf = sub_digits(x, y)
    return torch.where(uf[..., None], x, d)


# --- field ops: plain versions ----------------------------------------------------

def barrett_reduce(x: torch.Tensor) -> torch.Tensor:
    """Reduce a canonical-digit value x < p * 2^384 (<= 64 limbs) to
    [0, 2p): q_hat = ((x >> 372) * MU) >> 396 (mod 2^384), then
    r = x - q_hat * p (mod 2^384) and one conditional subtract of 2p."""
    dev = x.device
    n = x.shape[-1]
    if n < 64:
        x = F.pad(x, (0, 64 - n))
    q1 = carry_norm(conv_digits(x[..., 31:], const(MU, dev)), 66)
    q_hat = q1[..., 33:65]
    qp = carry_norm(conv_digits(q_hat, const(P, dev)), 64)
    r, _ = sub_digits(x, qp)
    return cond_sub(r[..., :L], const(TWO_P, dev))


def _modmul(a, b):
    """Plain version of K3: a * b mod p, lazy residue in [0, 2p)."""
    return barrett_reduce(carry_norm(conv_digits(a, b), 64))


def _modadd(a, b):
    """Plain version of K4's add: (a + b mod 2^384), less 2p if >= 2p."""
    s = carry_norm(a + b, L)
    return cond_sub(s, const(TWO_P, s.device))


def _modsub(a, b):
    """Plain version of K4's sub: a - b, plus 2p on underflow (mod 2^384)."""
    d, uf = sub_digits(a, b)
    wrapped = carry_norm(d + const(TWO_P, d.device), L + 1)[..., :L]
    return torch.where(uf[..., None], wrapped, d)


def _modneg(a):
    return _modsub(const(ZERO, a.device), a)


def _canon(a):
    """[0, 2p) -> [0, p): exact canonical form."""
    return cond_sub(a, const(P, a.device))


# --- K3 and K4 --------------------------------------------------------------------

def _operand(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    """``t`` broadcast to ``shape``, contiguous and 16-byte aligned."""
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: digits must be int32, got {t.dtype}")
    t = t.expand(shape).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch_elementwise(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    n = out.numel() // L
    if n == 0:
        return out
    if n >= 2**31:
        raise ValueError(f"{name}: at most 2^31 - 1 elements, got {n}")
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.launch(name, *args, out.data_ptr(), n, stream)
    return out


def _check_pair(a, b, name):
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.shape[-1] != L or b.shape[-1] != L:
        raise ValueError(f"{name}: digit axis must be {L}, got {a.shape} and {b.shape}")


def modmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p over broadcast [..., 32] digits, residues in [0, 2p).
    K3 (``csrc/fp_modmul.cu``) for CUDA tensors, the plain version for
    CPU tensors."""
    _check_pair(a, b, "modmul")
    if not use_kernel(a):
        return _modmul(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = _operand(a, shape, "modmul"), _operand(b, shape, "modmul")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    return _launch_elementwise("fp_modmul", out, a.data_ptr(), b.data_ptr())


def _addsub(op: int, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
    a = _operand(a, shape, "fp_addsub")
    b = a if b is None else _operand(b, shape, "fp_addsub")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    return _launch_elementwise("fp_addsub", out, a.data_ptr(), b.data_ptr(), op)


def modadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_pair(a, b, "modadd")
    return _addsub(OP_ADD, a, b) if use_kernel(a) else _modadd(a, b)


def modsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_pair(a, b, "modsub")
    return _addsub(OP_SUB, a, b) if use_kernel(a) else _modsub(a, b)


def modneg(a: torch.Tensor) -> torch.Tensor:
    return _addsub(OP_NEG, a, None) if use_kernel(a) else _modneg(a)


def canon(a: torch.Tensor) -> torch.Tensor:
    """[0, 2p) -> [0, p): exact canonical form for equality/serialization."""
    return _addsub(OP_CANON, a, None) if use_kernel(a) else _canon(a)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canon(a) == canon(b)).all(-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canon(a) == 0).all(-1)


def pow_static(x: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """x^e over the static MSB-first bit string ``bits`` by
    square-and-multiply; a zero bit skips its multiply (the JAX scan's
    select of the unmultiplied value, taken in Python)."""
    acc = ones_like(x)
    for bit in bits:
        acc = modmul(acc, acc)
        if bit:
            acc = modmul(acc, x)
    return acc


def modinv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) mod p over the static bit string of p-2 (380 squarings and
    228 multiplies). Returns 0 for a = 0 (Fermat's convention)."""
    return pow_static(a, _P_MINUS_2_BITS)
