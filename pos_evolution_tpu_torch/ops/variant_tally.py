"""Host oracles of the protocol-variant tallies (port of
``pos_evolution_tpu/ops/variant_tally.py:40-93``).

The expiry-windowed vote tally and the supermajority-link /
acknowledgment tally of Goldfish, RLMD-GHOST and single-slot finality,
as masked int64 segment sums in numpy: the bit-exact oracles the dense
variants read on a single device. The jitted device twins of the JAX
module (``:95-144``) are not ported here.
"""

from __future__ import annotations

import numpy as np


def next_pow2(x: int) -> int:
    """Shape-padding floor (>= 2)."""
    return max(int(2 ** np.ceil(np.log2(max(int(x), 2)))), 2)


def windowed_vote_tally_host(block_idx: np.ndarray, vote_slot: np.ndarray,
                             weight: np.ndarray, active: np.ndarray,
                             lo_slot: int, hi_slot: int,
                             n_blocks: int) -> np.ndarray:
    """Per-block summed weight of votes inside the expiry window
    ``[lo_slot, hi_slot]``: ``block_idx[K]`` (-1 = no vote),
    ``vote_slot[K]``, ``weight[K]`` Gwei, ``active[K]`` bool ->
    int64[n_blocks]."""
    block_idx = np.asarray(block_idx, np.int64)
    vote_slot = np.asarray(vote_slot, np.int64)
    weight = np.asarray(weight, np.int64)
    active = np.asarray(active, bool)
    ok = (active & (block_idx >= 0) & (block_idx < n_blocks)
          & (vote_slot >= int(lo_slot)) & (vote_slot <= int(hi_slot)))
    out = np.zeros(n_blocks, np.int64)
    np.add.at(out, block_idx[ok], weight[ok])
    return out


def link_tally_host(link_idx: np.ndarray, weight: np.ndarray,
                    active: np.ndarray, n_links: int) -> np.ndarray:
    """Per-link summed weight (``link_idx[K]``, -1 = none) ->
    int64[n_links]."""
    link_idx = np.asarray(link_idx, np.int64)
    weight = np.asarray(weight, np.int64)
    active = np.asarray(active, bool)
    ok = active & (link_idx >= 0) & (link_idx < n_links)
    out = np.zeros(n_links, np.int64)
    np.add.at(out, link_idx[ok], weight[ok])
    return out
