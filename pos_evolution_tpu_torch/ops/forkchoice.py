"""Dense HLMD-GHOST fork choice (port of
``pos_evolution_tpu/ops/forkchoice.py``).

Per-block vote weights by an int64 ``index_add_`` over the latest-message
table (exact in any order), subtree sums by binary lifting over the
parent array, and a greedy descent with the (weight, rank) tie-break.
The descent runs a fixed ``capacity`` steps of ``torch.where`` on the
device, which change nothing once a leaf is reached, so no step waits
on the host. ``head_host`` is the numpy twin of the head query, the
dense driver's independent oracle.

The incremental half (Queue 2 B9) keeps the per-block vote buckets
resident and moves them by scatter deltas as votes land
(``apply_latest_messages``), as equivocators are discounted
(``remove_latest_messages``), and per target epoch for the expiry
variants (``rebuild_epoch_buckets``, ``apply_latest_messages_windowed``,
``head_from_epoch_buckets``). The JAX package's ``mode="drop"`` scatters
write into a buffer one longer than the table, whose last entry is cut
off, and its in-batch dedup tournament is a per-validator ``amax`` of
unique keys instead of K x K masks. ``build_dense_arrays`` stages a spec
``Store`` as numpy columns, ``get_head_host`` is the vectorized host walk
over them, and ``get_head_dense`` the one-shot rescan on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.ops.variant_tally import next_pow2

__all__ = ["DenseStore", "apply_latest_messages", "apply_latest_messages_windowed",
           "build_dense_arrays", "build_dense_store", "get_head_dense", "get_head_host",
           "head_and_weights", "head_from_buckets", "head_from_epoch_buckets", "head_host",
           "next_pow2", "rebuild_buckets", "rebuild_epoch_buckets", "remove_latest_messages"]


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


# --- incremental vote buckets (Queue 2 B9) ------------------------------------


def _dropping_index(idx: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as int64 where ``ok`` and inside [0, n), else ``n``: the
    spare last slot of a buffer one longer than ``n``, which the caller
    cuts off (the JAX package's ``mode="drop"``)."""
    idx = idx.long()
    return torch.where(ok & (idx >= 0) & (idx < n), idx, n)


def _add_dropping(buckets: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``buckets`` (1-D) with ``values`` added at ``idx`` where ``ok``; an
    index outside the buckets adds nothing."""
    n = buckets.shape[0]
    ext = torch.cat([buckets, buckets.new_zeros(1)])
    ext.index_add_(0, _dropping_index(idx, ok, n), torch.where(ok, values, 0).to(ext.dtype))
    return ext[:n]


def _set_dropping(table: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``table`` with ``values`` written at ``idx`` where ``ok``; the
    winners' indices are unique, the rest land in the cut-off slot."""
    n = table.shape[0]
    ext = torch.cat([table, table.new_zeros(1)])
    ext[_dropping_index(idx, ok, n)] = values.to(table.dtype)
    return ext[:n]


def _vote_landing(msg_block, msg_epoch, val_idx, new_block, new_epoch, active):
    """Which batch entries update the LMD table -> (lands, old_block,
    old_epoch). An entry lands if it is active, votes for a block, and
    its validator has no message yet or an older target epoch; among
    duplicate ``val_idx`` the first entry carrying the maximum target
    epoch of the entries that could land wins, as sequential application
    would give. Each entry's key ``epoch * 2K + (K - pos)`` is unique, so
    an entry wins iff its key is its validator's maximum over competing
    entries, one ``scatter_reduce_`` with ``amax`` (no K x K masks)."""
    val = val_idx.long()
    old_block = msg_block[val]
    old_epoch = msg_epoch[val]
    lands = (active & (new_block >= 0)
             & ((old_block < 0) | (new_epoch > old_epoch)))
    k = val.shape[0]
    pos = torch.arange(k, dtype=torch.int64, device=val.device)
    key = new_epoch.to(torch.int64) * (2 * k) + (k - pos)
    competitor = active & (new_block >= 0)
    floor = torch.iinfo(torch.int64).min
    best = torch.full((msg_block.shape[0],), floor, dtype=torch.int64, device=val.device)
    best.scatter_reduce_(0, val, torch.where(competitor, key, floor), reduce="amax")
    return lands & (best[val] == key), old_block, old_epoch


def apply_latest_messages(msg_block, msg_epoch, vote_weight, val_idx, new_block,
                          new_epoch, weight, active):
    """Incremental LMD table update: ``val_idx[K]`` validators vote for
    ``new_block[K]`` with target ``new_epoch[K]`` -> (msg_block,
    msg_epoch, vote_weight), the per-block buckets moved by the landed
    votes' weights (old block minus, new block plus). ``weight`` must be
    what previously landed for the same validators; after a balance
    change call ``rebuild_buckets``."""
    lands, old_block, _ = _vote_landing(msg_block, msg_epoch, val_idx, new_block,
                                        new_epoch, active)
    w = weight.to(vote_weight.dtype)
    vote_weight = _add_dropping(vote_weight, old_block, lands & (old_block >= 0), -w)
    vote_weight = _add_dropping(vote_weight, new_block, lands, w)
    msg_block = _set_dropping(msg_block, val_idx, lands, new_block)
    msg_epoch = _set_dropping(msg_epoch, val_idx, lands, new_epoch)
    return msg_block, msg_epoch, vote_weight


def remove_latest_messages(msg_block, msg_epoch, vote_weight, val_idx, weight):
    """Discount validators whose vote already landed (equivocation): their
    bucketed weight comes off and their table entries clear, so no later
    vote of theirs lands through the table (callers also mark them
    inactive). ``weight`` must match what landed for each validator."""
    val = val_idx.long()
    old_block = msg_block[val]
    had = old_block >= 0
    vote_weight = _add_dropping(vote_weight, old_block, had,
                                -weight.to(vote_weight.dtype))
    msg_block = msg_block.clone()
    msg_epoch = msg_epoch.clone()
    msg_block[val] = -1
    msg_epoch[val] = 0
    return msg_block, msg_epoch, vote_weight


# --- epoch-windowed buckets: incremental heads for the expiry variants --------


def _window_column(epoch, base_epoch, window: int) -> torch.Tensor:
    """A vote's bucket column: its target epoch less ``base_epoch`` (int32,
    as the JAX package casts it), clamped into the top column."""
    rel = (epoch.to(torch.int64) - torch.as_tensor(base_epoch, dtype=torch.int64,
                                                   device=epoch.device)).to(torch.int32)
    return torch.clamp(rel, max=window - 1)


def rebuild_epoch_buckets(msg_block, msg_epoch, weight, capacity: int, window: int,
                          base_epoch):
    """[capacity, window] int64 weight columns: column e holds the summed
    weight of latest messages with target epoch ``base_epoch + e``. Votes
    below ``base_epoch`` carry no weight (expired); votes above the window
    clamp into the top column, which is exact for every ``min_vote_epoch``
    the window can express."""
    col = _window_column(msg_epoch, base_epoch, window)
    valid = (msg_block >= 0) & (col >= 0)
    flat = torch.zeros(capacity * window, dtype=torch.int64, device=msg_block.device)
    seg = msg_block.long() * window + col.long()
    flat = _add_dropping(flat, seg, valid, weight.to(torch.int64))
    return flat.reshape(capacity, window)


def apply_latest_messages_windowed(msg_block, msg_epoch, epoch_buckets, base_epoch,
                                   val_idx, new_block, new_epoch, weight, active):
    """Windowed twin of ``apply_latest_messages``: the same landing and
    dedup, with each bucket delta in its vote's target-epoch column. Votes
    below ``base_epoch`` move no bucket; votes above the window land in the
    top column."""
    lands, old_block, old_epoch = _vote_landing(msg_block, msg_epoch, val_idx, new_block,
                                                new_epoch, active)
    capacity, window = epoch_buckets.shape
    flat = epoch_buckets.reshape(capacity * window)

    def seg(block, epoch, ok):
        col = _window_column(epoch, base_epoch, window)
        return block.long() * window + col.long(), ok & (col >= 0)

    w = weight.to(flat.dtype)
    sub_seg, sub_ok = seg(old_block, old_epoch, lands & (old_block >= 0))
    add_seg, add_ok = seg(new_block, new_epoch, lands)
    flat = _add_dropping(flat, sub_seg, sub_ok, -w)
    flat = _add_dropping(flat, add_seg, add_ok, w)
    msg_block = _set_dropping(msg_block, val_idx, lands, new_block)
    msg_epoch = _set_dropping(msg_epoch, val_idx, lands, new_epoch)
    return msg_block, msg_epoch, flat.reshape(capacity, window)


def head_from_epoch_buckets(parent, real, rank, leaf_viable, justified_idx, epoch_buckets,
                            base_epoch, min_vote_epoch, boost_idx, boost_amount,
                            capacity: int, window: int):
    """Expiry-windowed head from the resident columns: the columns below
    ``min_vote_epoch`` masked, the rest summed, then ``head_from_buckets``.
    ``min_vote_epoch`` above the top column (``base_epoch + window - 1``)
    would mask out the clamped votes, so it raises."""
    hi = int(base_epoch) + window - 1
    mve = int(min_vote_epoch)
    if mve > hi:
        raise ValueError(
            f"min_vote_epoch {mve} is above the top "
            f"resident column (base_epoch {hi - window + 1} + window "
            f"{window} - 1 = {hi}); clamped votes would be masked out. "
            f"Rebuild the buckets with a higher base_epoch instead.")
    cols = int(base_epoch) + torch.arange(window, dtype=torch.int64,
                                          device=epoch_buckets.device)
    vote_weight = torch.where((cols >= mve)[None, :], epoch_buckets, 0).sum(dim=1)
    return head_from_buckets(parent, real, rank, leaf_viable, justified_idx, vote_weight,
                             boost_idx, boost_amount, capacity)


# --- host-side densification --------------------------------------------------


def build_dense_arrays(store, capacity: int | None = None):
    """Host-numpy image of a spec ``Store`` -> (dict of numpy columns,
    roots, capacity): the staging that ``build_dense_store`` places on a
    device and ``get_head_host`` walks on the host."""
    from pos_evolution_tpu_torch.specs.forkchoice import (
        _leaf_is_viable,
        get_current_slot,
        get_proposer_boost,
        justified_checkpoint_state,
    )
    from pos_evolution_tpu_torch.specs.helpers import compute_epoch_at_slot

    roots = list(store.blocks.keys())  # insertion = topological order
    b = len(roots)
    if capacity is None:
        capacity = next_pow2(b)
    index_of = {r: i for i, r in enumerate(roots)}
    rank = np.argsort(np.argsort(np.array(roots, dtype=object)))

    parent = np.full(capacity, -1, dtype=np.int32)
    slot = np.zeros(capacity, dtype=np.int32)
    real = np.zeros(capacity, dtype=bool)
    leaf_viable = np.zeros(capacity, dtype=bool)
    rank_arr = np.zeros(capacity, dtype=np.int32)
    rank_arr[:b] = rank
    for i, root in enumerate(roots):
        block = store.blocks[root]
        real[i] = True
        slot[i] = int(block.slot)
        parent[i] = index_of.get(bytes(block.parent_root), -1)
        leaf_viable[i] = _leaf_is_viable(store, root)

    reg = justified_checkpoint_state(store).validators
    n = len(reg)
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    active = ((reg.activation_epoch <= np.uint64(current_epoch))
              & (np.uint64(current_epoch) < reg.exit_epoch))
    msg_block = np.full(n, -1, dtype=np.int32)
    msg_epoch = np.zeros(n, dtype=np.int64)
    weight = np.zeros(n, dtype=np.int64)
    for v, message in store.latest_messages.items():
        if v >= n or v in store.equivocating_indices:
            continue
        idx = index_of.get(message.root)
        if idx is None:
            continue
        msg_block[v] = idx
        msg_epoch[v] = message.epoch
    valid = (msg_block >= 0) & active & ~reg.slashed
    weight[valid] = reg.effective_balance[valid].astype(np.int64)
    msg_block[~valid] = -1

    boost_idx = index_of.get(bytes(store.proposer_boost_root), -1) \
        if store.proposer_boost_root != b"\x00" * 32 else -1
    boost_amount = get_proposer_boost(store) if boost_idx >= 0 else 0
    cols = dict(
        parent=parent, slot=slot, rank=rank_arr, real=real, leaf_viable=leaf_viable,
        justified_idx=np.int32(index_of[bytes(store.justified_checkpoint.root)]),
        msg_block=msg_block, msg_epoch=msg_epoch, weight=weight,
        boost_idx=np.int32(boost_idx), boost_amount=np.int64(boost_amount),
    )
    return cols, roots, capacity


def _device_of(device) -> torch.device:
    """``device``, or the thread backend's when None."""
    if device is not None:
        return torch.device(device)
    from pos_evolution_tpu_torch.backend import get_backend
    return get_backend().device


def build_dense_store(store, capacity: int | None = None, device=None):
    """A ``DenseStore`` of a spec ``Store`` on ``device`` (the thread
    backend's when None) -> (dense, roots, capacity), ``roots[i]`` the
    block root at index i."""
    cols, roots, capacity = build_dense_arrays(store, capacity)
    dev = _device_of(device)
    dense = DenseStore(*(torch.as_tensor(np.asarray(cols[f])).to(dev)
                         for f in DenseStore._fields))
    return dense, roots, capacity


def get_head_host(store) -> bytes:
    """Vectorized host ``get_head``: one numpy pass over the latest-message
    table and the O(B) host walk (``head_host``), the same math as the
    spec walk; the resident store's periodic self-check."""
    cols, roots, capacity = build_dense_arrays(store)
    msg_block = cols["msg_block"]
    valid = msg_block >= 0
    vw = np.zeros(capacity + 1, np.int64)
    np.add.at(vw, np.where(valid, msg_block, capacity), np.where(valid, cols["weight"], 0))
    head = head_host(cols["parent"], cols["real"], cols["rank"], cols["leaf_viable"],
                     cols["justified_idx"], vw[:capacity], int(cols["boost_idx"]),
                     int(cols["boost_amount"]))
    return roots[head]


def get_head_dense(store, device=None) -> bytes:
    """The one-shot rescan ``get_head`` of a spec ``Store`` on ``device``
    (the thread backend's when None)."""
    dense, roots, capacity = build_dense_store(store, device=device)
    head_idx, _ = head_and_weights(dense, capacity)
    return roots[int(head_idx)]
