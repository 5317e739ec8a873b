"""Dense HLMD-GHOST fork choice (port of
``pos_evolution_tpu/ops/forkchoice.py``: the full-rescan head query).

Per-block vote weights by an int64 ``index_add_`` over the latest-message
table (exact in any order), subtree sums by binary lifting over the
parent array, and a greedy descent with the (weight, rank) tie-break.
The descent runs a fixed ``capacity`` steps of ``torch.where`` on the
device, which change nothing once a leaf is reached, so no step waits
on the host. ``head_host`` is the numpy twin of the head query, the
dense driver's independent oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.ops.variant_tally import next_pow2

__all__ = ["DenseStore", "head_and_weights", "head_from_buckets", "head_host",
           "next_pow2", "rebuild_buckets"]


class DenseStore(NamedTuple):
    """Fixed-capacity array image of the fork-choice Store."""

    parent: torch.Tensor          # int32[B]; -1 for the anchor root
    slot: torch.Tensor            # int32[B]
    rank: torch.Tensor            # int32[B] lexicographic rank of the block root
    real: torch.Tensor            # bool[B] slot occupied
    leaf_viable: torch.Tensor     # bool[B] leaf carries the store's justified/finalized view
    justified_idx: torch.Tensor   # int32 scalar: descent start
    msg_block: torch.Tensor       # int32[N]; -1 = no message
    msg_epoch: torch.Tensor       # int64[N]
    weight: torch.Tensor          # int64[N] effective balance, 0 if masked out
    boost_idx: torch.Tensor       # int32 scalar; -1 = no boost
    boost_amount: torch.Tensor    # int64 scalar


def _segment_sum(values, segment_ids, num_segments: int):
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, segment_ids.long(), values)


def _subtree_accumulate(parent, real, values, capacity: int):
    """Per-node subtree sums over a parent-index forest by binary lifting:
    round k folds each node's partial sum into its 2^k-th ancestor, then
    squares the ancestor pointer. ``values`` is [B] or [B, C]."""
    null = capacity
    anc = torch.where((parent >= 0) & real, parent.long(), null)
    null_ext = torch.full((1,), null, dtype=torch.int64, device=anc.device)
    w = values
    hops = max(int(np.ceil(np.log2(max(capacity, 2)))), 1)
    for _ in range(hops):
        w = w + _segment_sum(w, anc, capacity + 1)[:capacity]
        anc = torch.cat([anc, null_ext])[anc]
    return w


def _descend(parent, real, rank, keep, subtree, justified_idx):
    """Greedy descent with the exact (weight, rank) tie-break. Depth is
    below the capacity, so ``capacity`` steps always reach the leaf; among
    equal-weight children the highest rank wins (ranks are unique; argmax
    returns the first maximum, as jnp.argmax does)."""
    capacity = parent.shape[0]
    movable = keep & real
    head = torch.as_tensor(justified_idx, device=parent.device).to(torch.int64)
    for _ in range(capacity):
        children = (parent.long() == head) & movable
        w = torch.where(children, subtree, -1)
        rank_key = torch.where(children & (w == w.max()), rank.long(), -1)
        head = torch.where(children.any(), torch.argmax(rank_key), head)
    return head.to(torch.int32)


def head_from_buckets(parent, real, rank, leaf_viable, justified_idx,
                      vote_weight, boost_idx, boost_amount, capacity: int):
    """Head query from resident per-block vote buckets (no registry scan)
    -> (head, subtree weights). One lifted pass
    carries three columns: vote weight, a one-hot of the boosted block
    (its accumulation marks the boost block's ancestors-or-self) and the
    viable-leaf indicators (blocks with a viable leaf below them)."""
    dev = parent.device
    boost_idx = torch.as_tensor(boost_idx, device=dev)
    boost_onehot = ((torch.arange(capacity, device=dev) == boost_idx)
                    & (boost_idx >= 0)).to(torch.int64)
    has_parent = (parent >= 0) & real
    is_parent = torch.zeros(capacity, dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.where(parent >= 0, parent.long(), 0), has_parent.to(torch.int32),
        reduce="amax")
    leaf = real & (is_parent == 0)
    ok_leaf = (leaf & leaf_viable).to(torch.int64)

    cols = torch.stack([vote_weight.to(torch.int64), boost_onehot, ok_leaf], dim=1)
    acc = _subtree_accumulate(parent, real, cols, capacity)
    subtree = acc[:, 0] + acc[:, 1] * torch.as_tensor(boost_amount, device=dev)
    keep = acc[:, 2] > 0
    head = _descend(parent, real, rank, keep, subtree, justified_idx)
    return head, subtree


def head_and_weights(store: DenseStore, capacity: int, min_vote_epoch=None):
    """(head index int32, subtree weights int64[B]) from one scan of the
    latest-message table. ``min_vote_epoch`` drops votes whose target
    epoch is below it (the RLMD-GHOST expiry window; None = LMD)."""
    votes_valid = store.msg_block >= 0
    if min_vote_epoch is not None:
        votes_valid = votes_valid & (store.msg_epoch >= min_vote_epoch)
    seg_ids = torch.where(votes_valid, store.msg_block.long(), capacity)
    vote_weight = _segment_sum(torch.where(votes_valid, store.weight, 0),
                               seg_ids, capacity + 1)[:capacity]
    return head_from_buckets(
        store.parent, store.real, store.rank, store.leaf_viable,
        store.justified_idx, vote_weight, store.boost_idx,
        store.boost_amount, capacity)


def rebuild_buckets(msg_block, weight, capacity: int):
    """Per-block vote buckets from the whole message table: one int64
    ``index_add_`` (exact in any order) of ``weight`` by ``msg_block``,
    -1 entries dropped -> int64[capacity]."""
    valid = msg_block >= 0
    seg = torch.where(valid, msg_block.long(), capacity)
    return _segment_sum(torch.where(valid, weight.to(torch.int64), 0), seg,
                        capacity + 1)[:capacity]


def head_host(parent, real, rank, leaf_viable, justified_idx, vote_weight,
              boost_idx, boost_amount) -> int:
    """Numpy twin of ``head_from_buckets``: reverse-topological subtree
    sums (a parent's index is below its child's) and the greedy
    (weight, rank) descent -> the head's index."""
    b = parent.shape[0]
    subtree = vote_weight.astype(np.int64).copy()
    boost_col = np.zeros(b, np.int64)
    if boost_idx >= 0:
        boost_col[boost_idx] = 1
    is_parent = np.zeros(b, bool)
    valid_parent = (parent >= 0) & real
    is_parent[parent[valid_parent]] = True
    leaf_ok = ((real & ~is_parent) & leaf_viable).astype(np.int64)
    for i in range(b - 1, 0, -1):
        p = parent[i]
        if p >= 0 and real[i]:
            subtree[p] += subtree[i]
            boost_col[p] += boost_col[i]
            leaf_ok[p] += leaf_ok[i]
    subtree = subtree + boost_col * np.int64(boost_amount)
    keep = leaf_ok > 0

    head = int(justified_idx)
    while True:
        children = np.nonzero((parent == head) & keep & real)[0]
        if children.size == 0:
            return head
        w = subtree[children]
        tied = children[w == w.max()]
        head = int(tied[np.argmax(rank[tied])])
