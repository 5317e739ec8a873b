"""Merkleization on the device, and kernel K2 (port of
``pos_evolution_tpu/ops/merkle_device.py`` and ``ops/pallas_sha256.py``).

Every merkle level sweep of a tensor goes through ``pair_hash``, which
hands the level to ``merkle_level``: kernel K2 (``csrc/merkle_level.cu``)
for CUDA tensors, its plain PyTorch version ``_merkle_level`` for CPU
tensors. The tensor's device decides; every level of a CUDA tensor goes
through K2 at its true size.

Host rows (the spec layer's (N, 32) uint8 numpy chunks, through
``ssz/hash.sha256_pairs`` and ``ssz/merkle.merkleize_chunks``) need a
route: ``device_eligible`` sends a sweep to K2 on the active backend's
device when that device is CUDA and the sweep has at least
``Config.merkle_device_min_pairs`` pairs, and keeps it on the host
otherwise; ``set_mode`` forces either side. The decision reads the
backend's device, never its name. The JAX package's fallback ladder
(Pallas -> XLA -> NumPy) and its power-of-two batch padding are not
carried over: on a CUDA device K2 runs or raises.

``LevelSweeper`` advances many trees' level sweeps in lockstep and hashes
each round's pairs of all of them in one ``pair_hash`` call: one K2
launch per level across every dirty field of a state.

Nodes are (N, 8) int32 big-endian words (``device.py``).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from pos_evolution_tpu_torch.device import i32, resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.ops.sha256 import sha256_pair_words
from pos_evolution_tpu_torch.ssz.merkle import (
    _tree_levels,
    build_multiproof,
    merkleize_chunks,
    mix_in_length,
    zero_words,
)

__all__ = [
    "merkle_level", "pair_hash", "merkleize", "merkleize_words_device", "tree_levels",
    "build_multiproof_paths", "multiproof", "digest_bytes", "DIGEST_ALGO",
    "LevelSweeper", "drive", "stats", "reset_stats",
    "set_mode", "get_mode", "small_batch_floor", "device_eligible", "route_device",
    "pair_hash_rows", "host_pair_hash",
]

# Manifest tag of the payload digest: 32-byte chunks (tail zero-padded),
# vector-rule merkleization, byte length mixed in. Every device gives the
# same bytes, and so does the JAX package's ``digest_bytes``.
DIGEST_ALGO = "merkle32-sha256-v1"

# Cumulative counters of this process.
_STATS = {
    "sweeps": 0,            # pair_hash calls with at least one pair
    "pairs": 0,             # sibling pairs hashed
    "batched_launches": 0,  # LevelSweeper rounds (one pair_hash call each)
    "batched_jobs": 0,      # tree-update jobs coalesced into those rounds
}


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


# --- the host/device route of host rows ------------------------------------------

_MODES = ("auto", "device", "host")
_MODE = "auto"


def set_mode(mode: str) -> str:
    """Force the route of host rows: ``"device"`` (K2 whenever the active
    backend's device is CUDA), ``"host"`` (never), ``"auto"`` (CUDA and
    the crossover). Returns the previous mode."""
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"merkle dispatch mode must be one of {_MODES}")
    prev, _MODE = _MODE, mode
    return prev


def get_mode() -> str:
    return _MODE


def _min_pairs() -> int:
    from pos_evolution_tpu_torch.config import cfg
    return cfg().merkle_device_min_pairs


def small_batch_floor(per_item_pairs: int = 1) -> int:
    """The crossover in items of ``per_item_pairs`` pair compressions each
    (a DAS sample is about 16): below it a batch stays on the host."""
    return max(_min_pairs() // max(per_item_pairs, 1), 1)


def route_device() -> torch.device:
    """The active backend's device, where eligible host rows are hashed."""
    from pos_evolution_tpu_torch.backend import get_backend
    return get_backend().device


def device_eligible(n_pairs: int) -> bool:
    """Would a sweep of ``n_pairs`` host pairs go to K2? Only on a CUDA
    backend device: in ``"device"`` mode always, in ``"auto"`` mode from
    ``merkle_device_min_pairs`` pairs. The size is read before the
    backend, so small sweeps never touch it."""
    if _MODE == "host" or n_pairs <= 0:
        return False
    if _MODE == "auto" and n_pairs < _min_pairs():
        return False
    return route_device().type == "cuda"


def host_pair_hash(left, right):
    """``pair_hash`` of CPU word tensors on the host's SHA-256
    (``ssz/hash.sha256_pairs_host``: hashlib for small batches, numpy lanes
    for large), counted in ``stats()``: the spec state's trees on a CPU
    device, whose many small sweeps the plain version's ~2,300 tensor ops
    a compression would dominate. Same words as K2 and its plain version."""
    from pos_evolution_tpu_torch.ssz.hash import sha256_pairs_host
    n = left.shape[0]
    if n:
        _STATS["sweeps"] += 1
        _STATS["pairs"] += n
    rows = sha256_pairs_host(words_to_rows(left).numpy(), words_to_rows(right).numpy())
    return rows_to_words(torch.from_numpy(rows))


def pair_hash_rows(left: np.ndarray, right: np.ndarray, device=None) -> np.ndarray:
    """SHA-256 of (N, 32) uint8 host row pairs on ``device`` (the active
    backend's by default) through ``pair_hash``, back as (N, 32) rows."""
    dev = route_device() if device is None else resolve_device(device)

    def up(rows):
        return rows_to_words(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint8)).to(dev))

    return words_to_rows(pair_hash(up(left), up(right))).cpu().numpy()


# --- kernel K2 and its plain version --------------------------------------------

def _merkle_level(left, right):
    """Plain version of K2: SHA-256(left[i] || right[i]) for (N, 8) words
    -> (N, 8) int32 words (counterpart of ``pallas_sha256._level_xla``)."""
    return i32(sha256_pair_words(left, right))


def _check_rows(name: str, t, n: int, dev) -> None:
    if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (n, 8):
        raise ValueError(f"merkle_level: {name} must be int32 ({n}, 8) on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1 or t.stride(0) % 4 or t.data_ptr() % 16:
        raise ValueError(f"merkle_level: {name}'s rows must be 8 contiguous words, "
                         f"16-byte aligned (strides {t.stride()})")


def merkle_level(left, right):
    """K2's wrapper: one merkle level, (N, 8) + (N, 8) int32 words ->
    (N, 8) int32 digests. CUDA tensors: launch ``csrc/merkle_level.cu`` on
    the current stream, or raise; rows may be strided (the even and odd
    rows of one level). CPU tensors: the plain version. N = 0 returns an
    empty result without a launch."""
    dev = left.device
    if dev.type == "cpu":
        return _merkle_level(left, right)
    if dev.type != "cuda":
        raise ValueError(f"merkle_level: no kernel for device {dev}")
    n = left.shape[0]
    _check_rows("left", left, n, dev)
    _check_rows("right", right, n, dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if n >= 2**31:
        raise ValueError(f"merkle_level: at most 2^31 - 1 pairs, got {n}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.launch("merkle_level", left.data_ptr(), left.stride(0), right.data_ptr(),
                       right.stride(0), out.data_ptr(), n, stream)
    return out


def pair_hash(left, right, *, plain: bool = False):
    """The merkle combiner: SHA-256(left[i] || right[i]) over (N, 8) words,
    counted in ``stats()``. ``plain=True`` takes K2's plain version on any
    device: the reference the kernel is held against."""
    n = left.shape[0]
    if n:
        _STATS["sweeps"] += 1
        _STATS["pairs"] += n
    return (_merkle_level if plain else merkle_level)(left, right)


# --- whole trees ------------------------------------------------------------------

def merkleize(chunks, limit: int | None = None, *, plain: bool = False) -> bytes:
    """``ssz.merkle.merkleize_chunks`` with every level through ``pair_hash``
    (``plain=True``: K2's plain version on any device)."""
    return merkleize_chunks(chunks, limit, combine=partial(pair_hash, plain=plain))


def merkleize_words_device(leaves, depth: int):
    """Merkle root of (N, 8) word leaves, N a power of two, folded with
    zero-subtree roots up to depth ``depth``: (8,) int32 words on the
    leaves' device. Every level, the fold's included, goes through K2 on a
    CUDA tensor (counterpart of ``pallas_sha256.merkleize_words_device``)."""
    n = leaves.shape[0]
    if n == 0 or n & (n - 1) or n > 1 << depth:
        raise ValueError(f"need a power of two of at most 2^{depth} leaves, got {n}")
    zero = zero_words(leaves.device)
    nodes = leaves
    level = 0
    while nodes.shape[0] > 1:
        nodes = merkle_level(nodes[0::2], nodes[1::2])
        level += 1
    for lv in range(level, depth):
        nodes = merkle_level(nodes, zero[lv:lv + 1])
    return nodes[0]


def tree_levels(leaves, depth: int) -> list:
    """All levels of the padded tree, leaves first, each through ``pair_hash``."""
    return _tree_levels(leaves, depth, combine=pair_hash)


def _paths_from_levels(levels: list, indices, depth: int):
    """Sibling gather off a built tree, on its device: ``(leaves[indices]
    (S, 8), branches (S, depth, 8))``."""
    idx = torch.as_tensor(indices, dtype=torch.int64, device=levels[0].device).reshape(-1)
    zero = zero_words(idx.device)
    out = []
    cur = idx
    for d in range(depth):
        layer = levels[d]
        sib = cur ^ 1
        in_range = sib < layer.shape[0]
        row = layer[sib.clamp(max=layer.shape[0] - 1)]
        out.append(torch.where(in_range[:, None], row, zero[d]))
        cur = cur >> 1
    branches = (torch.stack(out, dim=1) if out
                else torch.empty((idx.numel(), 0, 8), dtype=torch.int32, device=idx.device))
    return levels[0][idx], branches


def build_multiproof_paths(leaves, indices, depth: int):
    """Batched proof branches: one tree build through ``pair_hash``, then
    the sibling gather."""
    return _paths_from_levels(tree_levels(leaves, depth), indices, depth)


def multiproof(leaves, leaf_indices, depth: int) -> list[bytes]:
    """``ssz.merkle.build_multiproof`` with every level through ``pair_hash``."""
    return build_multiproof(leaves, leaf_indices, depth, combine=pair_hash)


# --- byte-blob digests --------------------------------------------------------------

def digest_bytes(blob, device="cuda", *, plain: bool = False) -> bytes:
    """Length-bound merkle digest of a byte string (``DIGEST_ALGO``).

    ``blob`` is bytes or a uint8 numpy array, hashed on ``device`` (CUDA
    unless the caller asks for another), or a tensor of any dtype, whose
    raw bytes are hashed where it lies. The chunks are packed on that device;
    ``plain=True`` hashes with K2's plain version."""
    if isinstance(blob, torch.Tensor):
        data = blob.detach().contiguous().reshape(-1).view(torch.uint8)
    else:
        raw = (np.frombuffer(blob, dtype=np.uint8)
               if isinstance(blob, (bytes, bytearray, memoryview))
               else np.ascontiguousarray(blob, dtype=np.uint8).reshape(-1))
        data = torch.from_numpy(raw.copy()).to(resolve_device(device))
    n = data.numel()
    padded = torch.zeros(-(-n // 32) * 32, dtype=torch.uint8, device=data.device)
    padded[:n] = data
    return mix_in_length(merkleize(rows_to_words(padded.reshape(-1, 32)), plain=plain), n)


# --- lockstep batching --------------------------------------------------------------

class LevelSweeper:
    """Coalesce many trees' level sweeps into one ``pair_hash`` call per
    level. Jobs are generators that yield ``(left, right)`` pair blocks and
    receive the digests back through ``send``; each round of ``run``
    concatenates every active job's block, hashes it in one call, and hands
    each job its slice. ``plain=True`` hashes with K2's plain version,
    ``host=True`` with ``host_pair_hash`` (CPU words only)."""

    def __init__(self, *, plain: bool = False, host: bool = False):
        self.plain = plain
        self.host = host
        self._jobs: list = []

    def combine(self, left, right):
        """This sweeper's combiner: one ``pair_hash`` (or host) call."""
        if self.host:
            return host_pair_hash(left, right)
        return pair_hash(left, right, plain=self.plain)

    def add(self, gen) -> None:
        """Register one tree-update generator (primed to its first pair
        block; a generator with no hashing to do completes here)."""
        try:
            req = next(gen)
        except StopIteration:
            return
        self._jobs.append((gen, req))

    def run(self) -> None:
        jobs, self._jobs = self._jobs, []
        if jobs:
            _STATS["batched_jobs"] += len(jobs)
        while jobs:
            lefts = [left for _, (left, _r) in jobs]
            rights = [right for _, (_l, right) in jobs]
            digests = self.combine(torch.cat(lefts) if len(lefts) > 1 else lefts[0],
                                   torch.cat(rights) if len(rights) > 1 else rights[0])
            _STATS["batched_launches"] += 1
            nxt = []
            off = 0
            for gen, (left, _right) in jobs:
                k = left.shape[0]
                try:
                    req = gen.send(digests[off:off + k])
                except StopIteration:
                    pass
                else:
                    nxt.append((gen, req))
                off += k
            jobs = nxt


def drive(gen) -> None:
    """Run one tree-update generator alone: every pair block it yields goes
    straight through ``pair_hash``."""
    try:
        req = next(gen)
        while True:
            req = gen.send(pair_hash(*req))
    except StopIteration:
        return
