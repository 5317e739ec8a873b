"""BLS12-381 base-field arithmetic on int32 digit tensors, and kernels K3
and K4 (port of ``pos_evolution_tpu/ops/fp.py``).

An element of Fq is an int32 tensor ``[..., 32]`` of little-endian
base-2^12 digits, a lazy residue in [0, 2p): the JAX package's radix,
width and domain, so both packages give the same digits for the same
inputs. Products are reduced by plain Barrett with MU = floor(2^768 / p)
(no Montgomery form, which would give other representatives).

Each op has its plain PyTorch version here, a step-for-step mirror of the
JAX algorithm: digit convolution by broadcast-multiply-and-sum (an outer
product added into its columns: PyTorch has no integer matmul on CUDA),
three carry folds, and the carry/borrow lookahead as explicit shifted
(generate, propagate) rounds where JAX used ``associative_scan``. Results
come back as int32 (``sum`` is asked for int32 outright).

The wrappers pick by the tensor's device. CUDA tensors go to the kernels,
written by hand for Hopper (``csrc/fp_modmul.cu`` for ``modmul`` and the
static-exponent ladders ``pow_static``/``modinv``, one launch each;
``csrc/fp_addsub.cu`` for tapes of adds and subtracts, ``run_tape``, of
which ``modadd``/``modsub``/``modneg``/``canon`` are one-step tapes);
CPU tensors to the plain versions. Inside ``plain_mode()`` CUDA tensors
take the plain versions too: the reference the kernels are held against.
Nothing falls back: a kernel that fails to build or launch raises.

Digit inputs to the kernels are canonical (each digit in [0, 2^12)), as
every function here returns them.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import heapq
import math
from dataclasses import dataclass

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


_DIAGONALS: dict = {}


def conv_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product in digit space: [..., m] x [..., n] -> [..., m+n-1]
    column sums (each <= 33 * (2^12-1)^2 < 2^30, int32), batch dims
    broadcast: column k = sum_i a[i] * b[k - i], by one broadcast outer
    product added into its columns by the index i + j of each entry."""
    m, n = a.shape[-1], b.shape[-1]
    key = (m, n, a.device)
    idx = _DIAGONALS.get(key)
    if idx is None:
        idx = _DIAGONALS[key] = (torch.arange(m, device=a.device)[:, None]
                                 + torch.arange(n, device=a.device)[None, :]).flatten()
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)      # [..., m n]
    out = outer.new_zeros(outer.shape[:-1] + (m + n - 1,))
    return out.index_add_(-1, idx, outer).to(torch.int32)


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


# --- K4: tapes of base-field adds and subtracts ------------------------------------
#
# A tape is a short static program run over every base-field lane: LOAD an
# input row into a slot; ADD, SUB, NEG or CANON between slots, each exactly the
# op of the plain versions above; STORE a slot to an output row. K4
# (``csrc/fp_addsub.cu``) runs a whole tape in one launch, and ``_run_tape``
# runs the same steps through ``_modadd``, ``_modsub``, ``_modneg`` and
# ``_canon``. A fused caller's tape holds the same base-field ops on the same
# operands as the code it replaces; each op is a pure function of its operands,
# so the digits, lazy residues included, are the same.

LOAD, ADD, SUB, NEG, CANON, STORE = range(6)
TAPE_MAX_ROWS, TAPE_MAX_OUT_ROWS, TAPE_MAX_SLOTS, TAPE_MAX_STEPS = 32, 24, 8, 128
_ARITY = {ADD: 2, SUB: 2, NEG: 1, CANON: 1}

TAPES: dict = {}        # name -> Tape, every tape built so far (the path's are built at import)


def _std_strides(dims: tuple) -> tuple:
    out, acc = [], 1
    for d in reversed(dims):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


@dataclass(frozen=True)
class Tape:
    """A K4 program. ``in_shapes`` and ``out_shapes`` give each input's and
    output's component shape: () for a base-field tensor [..., 32], (2,)
    for an Fq2 [..., 2, 32], (3, 2) for a twist point [..., 3, 2, 32].
    ``rows``: (input, flat component) of each input row. ``steps``:
    (op, dst, a, b), with LOAD slot dst <- row a; ADD and SUB dst <- a op b;
    NEG and CANON dst <- op a; STORE output row dst <- slot a. Output rows
    number the outputs' components in order."""
    name: str
    in_shapes: tuple
    out_shapes: tuple
    rows: tuple
    steps: tuple

    def __post_init__(self):
        _validate(self)
        set_ = object.__setattr__
        set_(self, "in_dims", tuple(tuple(s) + (L,) for s in self.in_shapes))
        set_(self, "in_std", tuple(_std_strides(d) for d in self.in_dims))
        set_(self, "out_dims", tuple(tuple(s) + (L,) for s in self.out_shapes))
        set_(self, "out_rows", tuple(math.prod(s) for s in self.out_shapes))
        k = len(self.in_shapes)
        out = [(k + j, c) for j, m in enumerate(self.out_rows) for c in range(m)]
        # K4's program: (tensor, component) of each input row and output row, then the steps
        set_(self, "prog", bytes(v for pair in (*self.rows, *out) for v in pair)
             + bytes(v for step in self.steps for v in step))


def _validate(t: Tape) -> None:
    def bad(what):
        raise ValueError(f"tape {t.name}: {what}")
    if len(t.steps) > TAPE_MAX_STEPS:
        bad(f"{len(t.steps)} steps, at most {TAPE_MAX_STEPS}")
    if len(t.rows) > TAPE_MAX_ROWS:
        bad(f"{len(t.rows)} input rows, at most {TAPE_MAX_ROWS}")
    n_out = sum(math.prod(s) for s in t.out_shapes)
    if not t.out_shapes or n_out > TAPE_MAX_OUT_ROWS:
        bad(f"{n_out} output rows, 1 to {TAPE_MAX_OUT_ROWS}")
    for i, c in t.rows:
        if not (0 <= i < len(t.in_shapes) and 0 <= c < math.prod(t.in_shapes[i])):
            bad(f"row ({i}, {c}) is no input component")
    slot = range(TAPE_MAX_SLOTS)
    written, stored = set(), set()
    for op, dst, a, b in t.steps:
        if op == LOAD:
            if dst not in slot or not 0 <= a < len(t.rows):
                bad(f"LOAD {dst} <- row {a}: at most {TAPE_MAX_SLOTS} slots, {len(t.rows)} rows")
            written.add(dst)
        elif op == STORE:
            if not 0 <= dst < n_out or a not in written:
                bad(f"STORE row {dst} <- slot {a}")
            stored.add(dst)
        elif op in _ARITY:
            srcs = (a, b)[:_ARITY[op]]
            if dst not in slot or any(s not in written for s in srcs):
                bad(f"op {op} {dst} <- {srcs}: at most {TAPE_MAX_SLOTS} slots, sources written")
            written.add(dst)
        else:
            bad(f"unknown op {op}")
    if stored != set(range(n_out)):
        bad(f"output rows {sorted(set(range(n_out)) - stored)} never stored")


class _Sym:
    """A value of a tape being traced: an input row, or an op's result."""
    __slots__ = ("op", "args", "row")

    def __init__(self, trace: list, op: int, args: tuple = (), row=None):
        self.op, self.args, self.row = op, args, row
        if op != LOAD:
            trace.append(self)

    def _new(self, op, *args):
        return _Sym(_TRACE[-1], op, args)

    def __add__(self, other):
        return self._new(ADD, self, other)

    def __sub__(self, other):
        return self._new(SUB, self, other)

    def __neg__(self):
        return self._new(NEG, self)

    def canon(self):
        return self._new(CANON, self)


_TRACE: list = []            # the trace of the tape being built


def _sym_input(trace: list, i: int, shape: tuple):
    """Input ``i``'s rows as nested lists of ``shape`` (one row for ())."""
    syms = [_Sym(trace, LOAD, row=(i, c)) for c in range(math.prod(shape))]
    for n in reversed(shape[1:]):
        syms = [syms[k:k + n] for k in range(0, len(syms), n)]
    return syms if shape else syms[0]


def _flat(x) -> list:
    return [x] if isinstance(x, _Sym) else [s for e in x for s in _flat(e)]


def _schedule(name: str, trace: list, outs: list):
    """(rows, steps) computing ``outs`` (output rows in order): the needed
    ops in the order they were written, each input row loaded before its
    first use, and a slot freed after its last read. Where all slots are
    live, an input row not read by the step is dropped and loaded again at
    its next use."""
    needed, stack = set(), list(outs)
    while stack:
        s = stack.pop()
        if id(s) not in needed:
            needed.add(id(s))
            stack.extend(s.args)
    uses, store_at = {}, {}
    for s in trace:
        if id(s) in needed:
            for a in s.args:
                uses[id(a)] = uses.get(id(a), 0) + 1
    for r, s in enumerate(outs):
        uses[id(s)] = uses.get(id(s), 0) + 1
        store_at.setdefault(id(s), []).append(r)
    rows, row_index, steps = [], {}, []
    live, free = {}, list(range(TAPE_MAX_SLOTS))     # live: id -> (sym, slot), oldest first

    def alloc(keep):
        if free:
            return heapq.heappop(free)
        for key, (sym, slot) in live.items():
            if sym.op == LOAD and key not in keep:
                del live[key]
                return slot
        raise ValueError(f"tape {name}: more than {TAPE_MAX_SLOTS} live slots")

    def ensure(sym, keep):
        if id(sym) not in live:
            slot = alloc(keep)
            r = row_index.setdefault(sym.row, len(rows))
            if r == len(rows):
                rows.append(sym.row)
            steps.append((LOAD, slot, r, 0))
            live[id(sym)] = (sym, slot)
        return live[id(sym)][1]

    def release(sym):
        uses[id(sym)] -= 1
        if uses[id(sym)] == 0 and id(sym) in live:
            heapq.heappush(free, live.pop(id(sym))[1])

    def store(sym, slot):
        for r in store_at.get(id(sym), ()):
            steps.append((STORE, r, slot, 0))
            release(sym)

    for s in dict.fromkeys(s for s in outs if s.op == LOAD):      # outputs that copy an input
        store(s, ensure(s, ()))
    for s in trace:
        if id(s) not in needed:
            continue
        keep = {id(a) for a in s.args}
        srcs = [ensure(a, keep) for a in s.args]
        for a in s.args:
            release(a)
        dst = alloc(())
        steps.append((s.op, dst, srcs[0], srcs[-1]))
        live[id(s)] = (s, dst)
        store(s, dst)
    return tuple(rows), tuple(steps)


def make_tape(name: str, in_shapes, out_shapes, fn) -> Tape:
    """Trace ``fn`` on symbolic inputs of ``in_shapes`` (nested lists of
    rows that take +, -, unary - and ``.canon()``) into a tape, and register
    it under ``name``. ``fn`` returns one nested list per output shape (a
    tuple of them where there are several outputs)."""
    in_shapes = tuple(tuple(s) for s in in_shapes)
    out_shapes = tuple(tuple(s) for s in out_shapes)
    trace: list = []
    _TRACE.append(trace)
    try:
        res = fn(*(_sym_input(trace, i, s) for i, s in enumerate(in_shapes)))
    finally:
        _TRACE.pop()
    if len(out_shapes) == 1:
        res = (res,)
    outs = []
    for shape, r in zip(out_shapes, res, strict=True):
        flat = _flat(r)
        if len(flat) != math.prod(shape):
            raise ValueError(f"tape {name}: an output of shape {shape} has {len(flat)} rows")
        outs += flat
    rows, steps = _schedule(name, trace, outs)
    tape = Tape(name, in_shapes, out_shapes, rows, steps)
    if TAPES.get(name, tape) != tape:
        raise ValueError(f"tape {name} is registered with other steps")
    TAPES[name] = tape
    return tape


def _run_tape(tape: Tape, *inputs) -> torch.Tensor | tuple:
    """Plain version of K4: the tape's steps through the plain ops."""
    flat = [t if not s else t.flatten(-1 - len(s), -2) for t, s in zip(inputs, tape.in_shapes)]
    rows = [flat[i] if not tape.in_shapes[i] else flat[i][..., c, :] for i, c in tape.rows]
    slots, outs = [None] * TAPE_MAX_SLOTS, [None] * sum(tape.out_rows)
    for op, dst, a, b in tape.steps:
        if op == LOAD:
            slots[dst] = rows[a]
        elif op == STORE:
            outs[dst] = slots[a]
        elif op == ADD:
            slots[dst] = _modadd(slots[a], slots[b])
        elif op == SUB:
            slots[dst] = _modsub(slots[a], slots[b])
        elif op == NEG:
            slots[dst] = _modneg(slots[a])
        else:
            slots[dst] = _canon(slots[a])
    batch = torch.broadcast_shapes(*(t.shape[:t.dim() - len(d)]
                                     for t, d in zip(inputs, tape.in_dims)))
    results, k = [], 0
    for dims, m in zip(tape.out_dims, tape.out_rows):
        part = torch.stack([o.expand(batch + (L,)) for o in outs[k:k + m]], dim=-2)
        results.append(part.reshape(batch + dims))
        k += m
    return results[0] if len(results) == 1 else tuple(results)


def _batch_stride(batch, strides):
    """The one element stride over the batch dims, or None where they do
    not collapse to one (size-1 dims are skipped; a broadcast gives 0)."""
    es, span = 0, None
    for size, st in zip(reversed(batch), reversed(strides[:len(batch)])):
        if size == 1:
            continue
        if span is None:
            es = st
        elif st != span:
            return None
        span = st * size
    return es


def split_strides(t: torch.Tensor, nb: int, std: tuple, k: int = 0):
    """(s_outer, s_inner): the element strides of ``t``'s batch dims [:k]
    and [k:nb], each collapsed to one (size-1 dims skipped; no dims or a
    broadcast give 0), where both collapse, both and ``t`` are 16-byte
    aligned and its trailing dims have the packed strides ``std``; else
    None. The one rule by which K3-K5 read rows in place."""
    st, sh = t.stride(), t.shape
    if st[nb:] != std or t.data_ptr() % 16:
        return None
    so = _batch_stride(sh[:k], st[:k]) if k else 0
    si = _batch_stride(sh[k:nb], st[k:nb])
    if so is None or si is None or so % 4 or si % 4:
        return None
    return so, si


def element_rows(t: torch.Tensor, nb: int, std: tuple):
    """(t, element stride): ``t`` read in place by one element stride over
    its ``nb`` batch dims (``split_strides`` at no split), else a
    contiguous copy."""
    s = split_strides(t, nb, std)
    if s is None:
        t = t.clone(memory_format=torch.contiguous_format)
        return t, math.prod(t.shape[nb:])
    return t, s[1]


def _tape_launch(tape: Tape, inputs):
    """(outputs, the arguments of K4's launch or None where there are no
    lanes): one row pointer and element stride per input row, read in place
    where the batch dims collapse to one stride (0 broadcasts), a copy
    otherwise; the outputs fresh and contiguous. The arguments keep the
    copies alive."""
    dev = inputs[0].device
    shapes = []
    for t, dims in zip(inputs, tape.in_dims):
        sh = t.shape
        nb = len(sh) - len(dims)
        if nb < 0 or sh[nb:] != dims or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"tape {tape.name}: input {t.dtype} {tuple(sh)} on "
                             f"{t.device}, want int32 [..., {', '.join(map(str, dims))}] on {dev}")
        shapes.append(sh[:nb])
    batch = shapes[0]
    if any(s != batch for s in shapes):
        batch = torch.broadcast_shapes(*shapes)
    n = math.prod(batch)
    outs = [torch.empty(batch + d, dtype=torch.int32, device=dev) for d in tape.out_dims]
    if not n:
        return outs, None
    nb, vals, keep = len(batch), [], []
    for t, s, dims, std in zip(inputs, shapes, tape.in_dims, tape.in_std):
        t, es = element_rows(t if s == batch else t.expand(batch + dims), nb, std)
        keep.append(t)
        vals += (t.data_ptr(), es)
    for o, m in zip(outs, tape.out_rows):
        vals += (o.data_ptr(), m * L)
    args = ((ctypes.c_longlong * len(vals))(*vals), len(vals) // 2, tape.prog, len(tape.rows),
            sum(tape.out_rows), len(tape.steps), n)
    return outs, (args, keep)


def _tape_kernel(tape: Tape, inputs) -> torch.Tensor | tuple:
    """K4: ``tape`` over ``inputs`` in one launch."""
    outs, launch = _tape_launch(tape, inputs)
    if launch is not None:
        kernels.launch_on(inputs[0].device, "fp_addsub", *launch[0])
    return outs[0] if len(outs) == 1 else tuple(outs)


def run_tape(tape: Tape, *inputs) -> torch.Tensor | tuple:
    """Run ``tape`` over broadcast inputs: K4 in one launch for CUDA
    tensors, the plain version for CPU tensors and in ``plain_mode``.
    Returns the output tensor [..., *out_shape, 32], or a tuple of them."""
    if len(inputs) != len(tape.in_shapes):
        raise ValueError(f"tape {tape.name} takes {len(tape.in_shapes)} inputs, got {len(inputs)}")
    if not use_kernel(inputs[0]):
        return _run_tape(tape, *inputs)
    return _tape_kernel(tape, inputs)


# --- K3: products and static-exponent ladders ---------------------------------------
#
# K3 (``csrc/fp_modmul.cu``) reads each operand in place: element e =
# (e_outer, e_inner) of the broadcast batch, e_inner < n_inner, at
# data_ptr + e_outer * s_outer + e_inner * s_inner digits (0 broadcasts). The
# batch dims are split once into outer and inner dims such that each operand's
# collapse to one stride on each side (``split_strides``); an operand is copied
# only where no split serves it. Its output is fresh and contiguous.

def _k3_rows(ts: list, batch: tuple):
    """(tensors, [(s_outer, s_inner)] per tensor, n_inner) for K3: ``ts``
    (each already of shape batch + (32,)) read in place at one split of the
    batch dims, copies made only of those that no common split serves."""
    if all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        return ts, [(0, L)] * len(ts), math.prod(batch)      # one run of rows each
    nb = len(batch)

    def splits(t):
        return {k: s for k in range(nb + 1) if (s := split_strides(t, nb, (1,), k)) is not None}

    valid = [splits(t) for t in ts]
    for i in sorted(range(len(ts)), key=lambda i: len(valid[i])):
        if set.intersection(*(set(v) for v in valid)):
            break
        ts[i] = ts[i].clone(memory_format=torch.contiguous_format)
        valid[i] = splits(ts[i])
    k = min(set.intersection(*(set(v) for v in valid)))
    return ts, [v[k] for v in valid], math.prod(batch[k:])


# Elements below which a K3 launch gives each element a group of four lanes
# (one lane from there): from the times of phase 18 of chip_smoke.py on the
# H100, where four lanes win at 16,384 elements and one lane at 32,768 (the
# table in csrc/fp_modmul.cu and PERF.md).
K3_GROUP_BELOW = 32768


def k3_group(n: int) -> int:
    """Lanes per element of a K3 launch over n elements: 4 or 1."""
    return 4 if n < K3_GROUP_BELOW else 1


def _check_pair(a, b, name):
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.shape[-1] != L or b.shape[-1] != L:
        raise ValueError(f"{name}: digit axis must be {L}, got {a.shape} and {b.shape}")


def _modmul_launch(a: torch.Tensor, b: torch.Tensor, group: int | None = None):
    """(out, the arguments of K3's product launch or None where there are no
    elements, the tensors they point into): a and b read in place where
    their batch dims allow, ``group`` lanes per element (``k3_group``)."""
    shape = a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)
    batch = shape[:-1]
    (a, b), (sa, sb), n_inner = _k3_rows(
        [a if a.shape == shape else a.expand(shape), b if b.shape == shape else b.expand(shape)],
        batch)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = math.prod(batch)
    if n >= 2**31:
        raise ValueError(f"modmul: at most 2^31 - 1 elements, got {n}")
    if not n:
        return out, None, ()
    return out, (a.data_ptr(), *sa, b.data_ptr(), *sb, out.data_ptr(), n, n_inner,
                 group or k3_group(n)), (a, b)


def modmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p over broadcast [..., 32] digits, residues in [0, 2p).
    K3 (``csrc/fp_modmul.cu``) for CUDA tensors, the plain version for
    CPU tensors."""
    _check_pair(a, b, "modmul")
    if not use_kernel(a):
        return _modmul(a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"modmul: digits must be int32, got {a.dtype} and {b.dtype}")
    out, args, _keep = _modmul_launch(a, b)
    if args is not None:
        kernels.launch_on(a.device, "fp_modmul", *args)
    return out


_BITS: dict = {}     # bit-string bytes -> (its K3 words, bit count)


def _pack_bits(bits: np.ndarray):
    """An MSB-first bit schedule as K3's argument: bit s at word s // 32,
    bit s % 32 (a ctypes array of 12 uint32), and its length."""
    bits = np.asarray(bits, dtype=bool)
    key = bits.tobytes()
    got = _BITS.get(key)
    if got is None:
        if not 1 <= len(bits) <= 384:
            raise ValueError(f"pow_static: 1 to 384 bits, got {len(bits)}")
        words = [0] * 12
        for i in np.flatnonzero(bits).tolist():
            words[i >> 5] |= 1 << (i & 31)
        got = _BITS[key] = ((ctypes.c_uint32 * 12)(*words), len(bits))
    return got


def _pow_launch(x: torch.Tensor, bits: np.ndarray, group: int | None = None):
    """(out, the arguments of K3's ladder launch or None where there are no
    elements, the tensors they point into), as ``_modmul_launch``."""
    (x,), (sx,), n_inner = _k3_rows([x], x.shape[:-1])
    words, nbits = _pack_bits(bits)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    n = math.prod(x.shape[:-1])
    if n >= 2**31:
        raise ValueError(f"pow_static: at most 2^31 - 1 elements, got {n}")
    if not n:
        return out, None, ()
    return out, (x.data_ptr(), *sx, out.data_ptr(), n, n_inner, words, nbits,
                 group or k3_group(n)), (x,)


def _pow_static(x: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """Plain version of K3's ladder: x^e over the static MSB-first bit
    string ``bits`` by square-and-multiply; a zero bit skips its multiply
    (the JAX scan's select of the unmultiplied value, taken in Python)."""
    acc = ones_like(x)
    for bit in bits:
        acc = _modmul(acc, acc)
        if bit:
            acc = _modmul(acc, x)
    return acc


def pow_static(x: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """x^e over the static MSB-first bit string ``bits`` (1 to 384 bits):
    one K3 launch for CUDA tensors, each element in registers through every
    square and multiply; the plain version for CPU tensors and in
    ``plain_mode``."""
    if x.shape[-1] != L:
        raise ValueError(f"pow_static: digit axis must be {L}, got {tuple(x.shape)}")
    if not use_kernel(x):
        return _pow_static(x, bits)
    if x.dtype != torch.int32:
        raise ValueError(f"pow_static: digits must be int32, got {x.dtype}")
    out, args, _keep = _pow_launch(x, bits)
    if args is not None:
        kernels.launch_on(x.device, "fp_pow", *args)
    return out


# --- the single ops as one-step tapes ----------------------------------------------

_ADD = make_tape("modadd", ((), ()), ((),), lambda a, b: a + b)
_SUB = make_tape("modsub", ((), ()), ((),), lambda a, b: a - b)
_NEG = make_tape("modneg", ((),), ((),), lambda a: -a)
_CANON = make_tape("canon", ((),), ((),), lambda a: a.canon())


def modadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_pair(a, b, "modadd")
    return _tape_kernel(_ADD, (a, b)) if use_kernel(a) else _modadd(a, b)


def modsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_pair(a, b, "modsub")
    return _tape_kernel(_SUB, (a, b)) if use_kernel(a) else _modsub(a, b)


def modneg(a: torch.Tensor) -> torch.Tensor:
    return _tape_kernel(_NEG, (a,)) if use_kernel(a) else _modneg(a)


def canon(a: torch.Tensor) -> torch.Tensor:
    """[0, 2p) -> [0, p): exact canonical form for equality/serialization."""
    return _tape_kernel(_CANON, (a,)) if use_kernel(a) else _canon(a)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canon(a) == canon(b)).all(-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canon(a) == 0).all(-1)


def modinv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) mod p over the static bit string of p-2 (381 squarings and
    229 multiplies, one K3 launch on the card). Returns 0 for a = 0
    (Fermat's convention)."""
    return pow_static(a, _P_MINUS_2_BITS)
