"""SSZ merkleization over device words (port of ``pos_evolution_tpu/ssz/merkle.py``).

Padded binary merkle trees, the length mix-in, branch proofs and
generalized-index multiproofs. Tree nodes are (N, 8) int32 word tensors
on a device (``device.py``); a root or a proof node is handed back as 32
bytes. Every tree level runs through ``combine``, by default kernel K2's
wrapper ``ops/merkle_device.merkle_level`` (the plain version for CPU
tensors). Checks over a handful of nodes (``mix_in_length``,
``is_valid_merkle_branch``, ``verify_multiproof``) hash on the host with
hashlib.

``merkleize_chunks``, ``merkleize`` and ``merkle_tree_branch`` also take
(N, 32) uint8 numpy chunks, the JAX package's contract, which the spec
layer (``ssz/core.py``, ``specs/``) calls them with. Such chunks go to
the active backend's device through K2 when the first level has at least
``merkle_device_min_pairs`` pairs and that device is CUDA
(``ops/merkle_device.device_eligible``), and through the host SHA-256
(``ssz/hash.sha256_pairs_host``) otherwise.

The JAX package's whole-tree native call (``native.merkleize_chunks``,
host C++ and not JAX) has no counterpart here: every level goes through
the combiner.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pos_evolution_tpu_torch.device import (
    rows_to_words,
    words_to_bytes,
    words_to_numpy,
    words_to_torch,
)
from pos_evolution_tpu_torch.ssz.hash import sha256, sha256_pairs_host

MAX_DEPTH = 64

# ZERO_HASHES[d] = root of an all-zero subtree of depth d, as 32 bytes and
# as (MAX_DEPTH + 1, 8) uint32 big-endian words.
ZERO_HASHES = [bytes(32)]
for _ in range(MAX_DEPTH):
    ZERO_HASHES.append(sha256(ZERO_HASHES[-1] * 2))
ZERO_WORDS = np.frombuffer(b"".join(ZERO_HASHES), dtype=">u4").astype(np.uint32).reshape(-1, 8)
ZERO_ROWS = np.frombuffer(b"".join(ZERO_HASHES), dtype=np.uint8).reshape(-1, 32)


@lru_cache(maxsize=None)
def zero_words(device: torch.device) -> torch.Tensor:
    """``ZERO_WORDS`` as int32 words on ``device``, copied there once."""
    return words_to_torch(ZERO_WORDS, device)


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _depth_for(limit: int) -> int:
    return (next_pow_of_two(limit) - 1).bit_length() if limit > 1 else 0


def _merkle_level(left, right):
    # ops/merkle_device builds on this module, so it is reached at first use
    from pos_evolution_tpu_torch.ops.merkle_device import merkle_level
    return merkle_level(left, right)


def _row_bytes(rows: torch.Tensor) -> list[bytes]:
    """(S, 8) words -> S 32-byte strings, in one copy to the host."""
    words = words_to_numpy(rows)
    return [words_to_bytes(w) for w in words]


def _next_level(layer: torch.Tensor, level: int, combine) -> torch.Tensor:
    """Hash one level: an odd layer takes ``ZERO_HASHES[level]`` as its last
    right sibling, then even rows pair with odd rows (strided views)."""
    if layer.shape[0] % 2:
        layer = torch.cat([layer, zero_words(layer.device)[level:level + 1]])
    return combine(layer[0::2], layer[1::2])


def merkleize_chunks(chunks, limit: int | None = None, combine=None) -> bytes:
    """Merkle root of chunks, virtually padded to ``limit`` chunks
    (``limit=None``: the vector rule, the next power of two of N). Returns
    the 32-byte root.

    ``chunks`` is an (N, 8) word tensor, hashed where it lies through
    ``combine`` (by default K2's wrapper), or (N, 32) uint8 numpy rows (a
    flat array is read as rows), which ``ops/merkle_device.device_eligible``
    routes to K2 on the active backend's device or to the host."""
    if isinstance(chunks, torch.Tensor):
        return _merkleize_words(chunks, limit, combine or _merkle_level)
    rows = np.ascontiguousarray(chunks, dtype=np.uint8)
    if rows.ndim == 1:
        rows = rows.reshape(-1, 32)
    count = rows.shape[0]
    from pos_evolution_tpu_torch.ops.merkle_device import device_eligible, route_device
    if device_eligible(count // 2):
        words = rows_to_words(torch.from_numpy(rows).to(route_device()))
        return _merkleize_words(words, limit, _merkle_level)
    if limit is None:
        limit = max(count, 1)
    if count > limit:
        raise ValueError(f"{count} chunks exceed limit {limit}")
    depth = _depth_for(limit)
    if count == 0:
        return ZERO_HASHES[depth]
    layer = rows
    for level in range(depth):
        if layer.shape[0] % 2:
            layer = np.concatenate([layer, ZERO_ROWS[level:level + 1]])
        layer = sha256_pairs_host(np.ascontiguousarray(layer[0::2]),
                                  np.ascontiguousarray(layer[1::2]))
    return layer[0].tobytes()


def _merkleize_words(chunks: torch.Tensor, limit: int | None, combine) -> bytes:
    count = chunks.shape[0]
    if limit is None:
        limit = max(count, 1)
    if count > limit:
        raise ValueError(f"{count} chunks exceed limit {limit}")
    depth = _depth_for(limit)
    if count == 0:
        return ZERO_HASHES[depth]
    layer = chunks
    for level in range(depth):
        layer = _next_level(layer, level, combine)
    return _row_bytes(layer[:1])[0]


def merkleize(chunks, limit: int | None = None) -> bytes:
    """``merkleize_chunks`` of a list of 32-byte chunks or of an array."""
    if isinstance(chunks, (np.ndarray, torch.Tensor)):
        return merkleize_chunks(chunks, limit)
    if len(chunks) == 0:
        return merkleize_chunks(np.empty((0, 32), dtype=np.uint8), limit)
    return merkleize_chunks(np.frombuffer(b"".join(bytes(c) for c in chunks),
                                          dtype=np.uint8).reshape(-1, 32), limit)


def mix_in_length(root: bytes, length: int) -> bytes:
    return sha256(root + length.to_bytes(32, "little"))


def is_valid_merkle_branch(leaf: bytes, branch, depth: int, index: int, root: bytes) -> bool:
    """Verify a merkle inclusion proof (pos-evolution.md:141-147 contract)."""
    value = bytes(leaf)
    for i in range(depth):
        sibling = bytes(branch[i])
        value = sha256(sibling + value) if (index >> i) & 1 else sha256(value + sibling)
    return value == bytes(root)


# --- generalized-index multiproofs --------------------------------------------
# Node 1 is the root, node g's children are 2g and 2g+1, leaf i of a
# depth-d tree is 2**d + i. One proof covers many leaves by shipping only
# the siblings off the union of their root paths.


def multiproof_helper_gindices(leaf_indices, depth: int) -> list[int]:
    """Sibling generalized indices a multiproof over ``leaf_indices`` must
    carry, sorted descending (deepest first, the canonical SSZ order)."""
    on_path: set[int] = {1}
    for i in leaf_indices:
        g = (1 << depth) + int(i)
        while g > 1:
            on_path.add(g)
            g >>= 1
    helpers = {g ^ 1 for g in on_path if g > 1 and (g ^ 1) not in on_path}
    return sorted(helpers, reverse=True)


def _tree_levels(leaves: torch.Tensor, depth: int, combine=_merkle_level) -> list[torch.Tensor]:
    """All ``depth + 1`` levels of the padded tree, leaves first. Virtual
    zero padding stays virtual: out-of-range nodes read ``ZERO_HASHES``."""
    levels = [leaves]
    for level in range(depth):
        levels.append(_next_level(levels[-1], level, combine))
    return levels


def _node_bytes(levels: list[torch.Tensor], gindices, depth: int) -> list[bytes]:
    """The 32-byte values of nodes ``gindices`` of a built tree."""
    if not gindices:
        return []
    zero = zero_words(levels[0].device)
    rows = []
    for g in gindices:
        level = depth - (g.bit_length() - 1)
        idx = g - (1 << (g.bit_length() - 1))
        layer = levels[level]
        rows.append(layer[idx] if idx < layer.shape[0] else zero[level])
    return _row_bytes(torch.stack(rows))


def build_multiproof(leaves: torch.Tensor, leaf_indices, depth: int,
                     combine=_merkle_level) -> list[bytes]:
    """One proof for all ``leaf_indices`` of a depth-``depth`` tree over
    ``leaves``: the helper-sibling values in ``multiproof_helper_gindices``
    order."""
    levels = _tree_levels(leaves, depth, combine)
    return _node_bytes(levels, multiproof_helper_gindices(leaf_indices, depth), depth)


def verify_multiproof(leaf_values, leaf_indices, proof, depth: int, root: bytes) -> bool:
    """Recompute the root from leaves and helper siblings, deepest level
    first. Duplicate generalized indices must carry equal values."""
    leaf_indices = [int(i) for i in leaf_indices]
    helpers = multiproof_helper_gindices(leaf_indices, depth)
    if len(proof) != len(helpers) or len(leaf_values) != len(leaf_indices):
        return False
    objects: dict[int, bytes] = {}
    for g, v in zip(((1 << depth) + i for i in leaf_indices), leaf_values):
        if objects.setdefault(g, bytes(v)) != bytes(v):
            return False
    for g, v in zip(helpers, proof):
        if objects.setdefault(g, bytes(v)) != bytes(v):
            return False
    for length in range(depth + 1, 1, -1):  # bit_length of gindices, deep -> shallow
        for p in sorted({g >> 1 for g in objects if g.bit_length() == length}):
            if p in objects:
                continue
            left, right = objects.get(p << 1), objects.get((p << 1) | 1)
            if left is None or right is None:
                return False  # malformed proof: a needed sibling is absent
            objects[p] = sha256(left + right)
    return objects.get(1) == bytes(root)


def merkle_tree_branch(leaves, index: int, depth: int, combine=_merkle_level) -> list[bytes]:
    """The merkle proof for ``leaves[index]`` in a depth-``depth`` tree:
    over an (N, 8) word tensor through ``combine``, or over (N, 32) uint8
    numpy rows on the host (the JAX package's contract)."""
    if isinstance(leaves, torch.Tensor):
        levels = _tree_levels(leaves, depth, combine)
        leaf = (1 << depth) + index
        return _node_bytes(levels, [(leaf >> d) ^ 1 for d in range(depth)], depth)
    layer = np.ascontiguousarray(leaves, dtype=np.uint8).reshape(-1, 32)
    branch: list[bytes] = []
    for level in range(depth):
        sib = index ^ 1
        branch.append(layer[sib].tobytes() if sib < layer.shape[0] else ZERO_HASHES[level])
        if layer.shape[0] % 2:
            layer = np.concatenate([layer, ZERO_ROWS[level:level + 1]])
        layer = sha256_pairs_host(layer[0::2], layer[1::2])
        index //= 2
    return branch
