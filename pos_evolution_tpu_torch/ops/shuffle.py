"""Swap-or-not shuffle of the whole registry (port of
``pos_evolution_tpu/ops/shuffle.py``).

Each round hashes the ceil(n/256) position blocks once and applies the
flip decision to every index in parallel. The round digests depend only
on (seed, round, block), never on the indices, so all rounds' digests
are computed up front in one batched SHA-256 pass; the round loop that
follows is a few elementwise ops per round.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device
from pos_evolution_tpu_torch.ops.sha256 import sha256_words
from pos_evolution_tpu_torch.ssz.hash import hash_eth2


def host_pivots(seed: bytes, n: int, rounds: int) -> np.ndarray:
    """pivot[r] = bytes_to_uint64(H(seed | r)[:8]) % n."""
    return np.array(
        [int.from_bytes(hash_eth2(seed + bytes([r]))[:8], "little") % n
         for r in range(rounds)],
        dtype=np.int64)


def _seed_words(seed: bytes) -> np.ndarray:
    return np.frombuffer(seed, dtype=">u4").astype(np.uint32)


def _round_digests(seed_words, n: int, rounds: int, device):
    """(rounds, n_blocks, 8) digests of seed(32) | round(1) | block_le(4),
    one padded 64-byte block each (bit length 37 * 8)."""
    n_blocks = (n + 255) // 256
    block_ids = torch.arange(n_blocks, dtype=torch.int64, device=device)
    b0, b1, b2, b3 = ((block_ids >> s) & 0xFF for s in (0, 8, 16, 24))
    r = torch.arange(rounds, dtype=torch.int64, device=device)[:, None]
    msgs = torch.zeros((rounds, n_blocks, 16), dtype=torch.int64, device=device)
    msgs[..., 0:8] = torch.as_tensor(np.asarray(seed_words, np.int64), device=device)
    msgs[..., 8] = (r << 24) | (b0 << 16) | (b1 << 8) | b2
    msgs[..., 9] = (b3 << 24) | 0x00800000
    msgs[..., 15] = 37 * 8
    return sha256_words(msgs)


def _shuffle_rounds(seed_words, pivots, idx0, n: int, rounds: int):
    """Run the swap-or-not round schedule on ``idx0`` (int32, any slice of
    [0, n): each index's trajectory is independent). ``pivots`` is an
    int64 tensor of ``rounds`` entries."""
    digests = _round_digests(seed_words, n, rounds, idx0.device)
    idx = idx0
    for r in range(rounds):
        # torch.remainder follows the divisor's sign, as the spec's % does
        flip = torch.remainder(pivots[r] - idx.long(), n).to(torch.int32)
        pos = torch.maximum(idx, flip).long()
        # byte k of a digest lives in word k >> 2 at big-endian shift 24 - 8*(k & 3)
        k = (pos & 0xFF) >> 3
        word = digests[r, pos >> 8, k >> 2]
        byte = (word >> (24 - ((k & 3) << 3))) & 0xFF
        bit = (byte >> (pos & 7)) & 1
        idx = torch.where(bit.bool(), flip, idx)
    return idx


def shuffle_permutation(seed: bytes, n: int, rounds: int, device="cuda"):
    """Permutation p (int32[n]) with p[i] = the shuffled index of i."""
    dev = resolve_device(device)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    pivots = torch.as_tensor(host_pivots(seed, n, rounds), device=dev)
    idx0 = torch.arange(n, dtype=torch.int32, device=dev)
    return _shuffle_rounds(_seed_words(seed), pivots, idx0, n, rounds)
