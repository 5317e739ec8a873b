"""The protocol-variant tallies (port of
``pos_evolution_tpu/ops/variant_tally.py``, Queue 2 B10).

The expiry-windowed vote tally and the supermajority-link /
acknowledgment tally of Goldfish, RLMD-GHOST and single-slot finality,
as masked int64 segment sums: the numpy host oracles, and their device
twins (``windowed_vote_tally_device``, ``link_tally_device``), one masked
``index_add_`` on a device, exact in any order. The backend's
``variant_tally`` and ``link_tally`` call the device twins.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _masked_tally(idx, weight, ok, n: int, device) -> np.ndarray:
    """int64[n]: ``weight`` summed by ``idx`` where ``ok``, on ``device``."""
    dev = torch.device(device)
    i = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(dev)
    ok_t = torch.from_numpy(np.ascontiguousarray(ok, dtype=bool)).to(dev)
    w = torch.from_numpy(np.ascontiguousarray(weight, dtype=np.int64)).to(dev)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    out.index_add_(0, torch.where(ok_t, i, 0), torch.where(ok_t, w, 0))
    return out.cpu().numpy()


def windowed_vote_tally_device(block_idx, vote_slot, weight, active, lo_slot: int,
                               hi_slot: int, n_blocks: int, device="cuda") -> np.ndarray:
    """Device twin of ``windowed_vote_tally_host`` on ``device``: the same
    mask, one int64 ``index_add_`` -> int64[n_blocks] numpy."""
    bi = np.asarray(block_idx, np.int64)
    vs = np.asarray(vote_slot, np.int64)
    ok = (np.asarray(active, bool) & (bi >= 0) & (bi < n_blocks)
          & (vs >= int(lo_slot)) & (vs <= int(hi_slot)))
    return _masked_tally(bi, np.asarray(weight, np.int64), ok, int(n_blocks), device)


def link_tally_device(link_idx, weight, active, n_links: int, device="cuda") -> np.ndarray:
    """Device twin of ``link_tally_host`` on ``device`` -> int64[n_links]
    numpy."""
    li = np.asarray(link_idx, np.int64)
    ok = np.asarray(active, bool) & (li >= 0) & (li < n_links)
    return _masked_tally(li, np.asarray(weight, np.int64), ok, int(n_links), device)
