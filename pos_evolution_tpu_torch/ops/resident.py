"""Persistent device fork-choice store (port of
``pos_evolution_tpu/ops/resident.py``, Queue 2 B11).

The spec driver asks for the head on every propose and attest duty over
a store that changes by small deltas: one block row per ``on_block``, a
handful of latest-message updates per ``on_attestation``, rare
equivocator removals. This class keeps the dense image of one spec
``Store`` resident on the backend's device and mirrors it incrementally:

- ``note_block``      — append one row (parent/slot/rank/viability);
- ``note_attestation``— queue votes; flushed as one padded
                        ``apply_latest_messages`` scatter batch;
- ``note_slashing``   — ``remove_latest_messages`` + weight zeroing;
- ``head()``          — flush, then ``head_from_buckets`` on the device,
                        no registry rescan, no host rebuild.

A wholesale ``rebuild`` happens where the incremental contracts demand it:
effective balances and activation windows move at epoch processing, and
viability and vote weights re-anchor when the justified or finalized
checkpoints move; ``sync()`` detects those events by fingerprint.

Any device error, and any divergence the periodic self-check finds,
drops the instance to the host spec walk for good (``degraded``, with
the reason in ``incidents``), as in the JAX package. ``stats`` counts
head queries (fresh device queries and memo hits), flushes and rebuilds
for the driver's report; a degradation is emitted on the global
telemetry sink, and every flush and fresh head query is counted as a
dispatch (the head's index read-back as a transfer) through
``telemetry/torchrt.py``. The JAX package's sharded mode (its
``_active_mesh``) is ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pos_evolution_tpu_torch.ops.forkchoice import (
    apply_latest_messages,
    build_dense_store,
    head_from_buckets,
    next_pow2,
    rebuild_buckets,
    remove_latest_messages,
)
from pos_evolution_tpu_torch.telemetry import emit_global, torchrt

logger = logging.getLogger("pos_evolution_tpu_torch.resident")


class ResidentForkChoice:
    """Device-resident dense mirror of one spec-level ``Store`` on the
    thread backend's device at construction.

    Graceful degradation: the accelerated path is an optimization of the
    spec walk, never a source of truth, so any device error, and any
    divergence caught by the periodic self-check (every
    ``selfcheck_every`` fresh head queries, against
    ``ops/forkchoice.get_head_host``; every ``DEEPCHECK_FACTOR``-th
    against ``specs/forkchoice.get_head``), permanently drops this
    instance to the host path (``degraded=True``, the reason in
    ``incidents``). ``selfcheck_every=0`` disables the audit."""

    DEEPCHECK_FACTOR = 16

    def __init__(self, store, capacity: int = 64, selfcheck_every: int = 64):
        from pos_evolution_tpu_torch.backend import get_backend
        self.device = get_backend().device
        self._min_capacity = capacity
        self.selfcheck_every = selfcheck_every
        self.degraded = False
        self.incidents: list[str] = []
        self._head_queries = 0
        self._pending = []
        # fresh device head queries, memo answers, flushes and rebuilds
        self.stats = {"device_heads": 0, "memo_hits": 0, "flushes": 0, "rebuilds": 0}
        # Head-query memo: ``_rev`` bumps on every mutation of the dense
        # image; the key adds the store-side inputs the device query reads
        # (fingerprint, boost root, block count), so a cached answer is
        # exactly what a fresh ``_device_head`` would return.
        self._rev = 0
        self._head_memo: tuple | None = None
        try:
            self.rebuild(store)
        except Exception as e:
            self._degrade(f"initial rebuild failed: {e!r}")

    def _degrade(self, reason: str) -> None:
        self.degraded = True
        self.incidents.append(reason)
        logger.warning("resident fork choice degraded to the host spec path: %s", reason)
        emit_global("degradation", component="resident_forkchoice", reason=reason[:400],
                    fallback="host_spec_walk", head_queries=self._head_queries)

    # -- full (re)build --------------------------------------------------------

    def rebuild(self, store) -> None:
        """Densify the spec store from scratch (anchor init, capacity
        growth, or a contract-mandated epoch/checkpoint refresh)."""
        capacity = max(self._min_capacity, next_pow2(len(store.blocks)))
        dense, roots, capacity = build_dense_store(store, capacity, device=self.device)
        self.capacity = capacity
        self.roots: list[bytes] = list(roots)
        self.index_of = {r: i for i, r in enumerate(self.roots)}
        self.parent = dense.parent
        self.slot = dense.slot
        self.rank = dense.rank
        self.real = dense.real
        self.leaf_viable = dense.leaf_viable
        self.msg_block = dense.msg_block
        self.msg_epoch = dense.msg_epoch
        # Full per-validator weights: effective balance under the
        # justified-checkpoint registry, masked by activation window,
        # slashing and equivocation, so that future voters weigh too.
        from pos_evolution_tpu_torch.specs.forkchoice import (
            get_current_slot,
            justified_checkpoint_state,
        )
        from pos_evolution_tpu_torch.specs.helpers import compute_epoch_at_slot
        reg = justified_checkpoint_state(store).validators
        current_epoch = compute_epoch_at_slot(get_current_slot(store))
        active = ((reg.activation_epoch <= np.uint64(current_epoch))
                  & (np.uint64(current_epoch) < reg.exit_epoch))
        weight = np.where(active & ~reg.slashed, reg.effective_balance.astype(np.int64), 0)
        ok = np.ones(len(reg), dtype=bool)
        for v in store.equivocating_indices:
            if v < ok.shape[0]:
                ok[v] = False
                weight[v] = 0
        self.ok = torch.from_numpy(ok).to(self.device)
        self.weight = torch.from_numpy(np.ascontiguousarray(weight)).to(self.device)
        self.buckets = rebuild_buckets(self.msg_block, self.weight, self.capacity)
        self._pending: list[tuple[np.ndarray, int, int]] = []
        self._fingerprint = self._store_fingerprint(store)
        self._rev += 1
        self.stats["rebuilds"] += 1

    def _store_fingerprint(self, store):
        """Events that void the incremental contracts: justified /
        finalized checkpoint moves and epoch rollover."""
        from pos_evolution_tpu_torch.config import cfg
        from pos_evolution_tpu_torch.specs.forkchoice import get_current_slot
        epoch = get_current_slot(store) // cfg().slots_per_epoch
        return (int(store.justified_checkpoint.epoch),
                bytes(store.justified_checkpoint.root),
                int(store.finalized_checkpoint.epoch),
                bytes(store.finalized_checkpoint.root),
                epoch)

    def sync(self, store) -> None:
        """Rebuild if a rebuild-mandating event occurred. Pending votes
        are already in the spec store, so the rebuild re-reads them."""
        if (len(store.blocks) > self.capacity
                or len(self.roots) != len(store.blocks)
                or self._fingerprint != self._store_fingerprint(store)):
            self.rebuild(store)

    # -- incremental handlers --------------------------------------------------

    def note_block(self, store, block_root: bytes) -> None:
        """Mirror one ``on_block``: append a row; ranks above the new root
        shift, recomputed on the host in O(B log B)."""
        if self.degraded:
            return
        try:
            self._note_block(store, block_root)
        except Exception as e:
            self._degrade(f"note_block failed: {e!r}")

    def _note_block(self, store, block_root: bytes) -> None:
        if len(self.roots) + 1 > self.capacity:
            self.rebuild(store)
            return
        from pos_evolution_tpu_torch.specs.forkchoice import _leaf_is_viable
        i = len(self.roots)
        block = store.blocks[block_root]
        self.roots.append(block_root)
        self.index_of[block_root] = i
        self.parent[i] = self.index_of.get(bytes(block.parent_root), -1)
        self.slot[i] = int(block.slot)
        self.real[i] = True
        self.leaf_viable[i] = bool(_leaf_is_viable(store, block_root))
        order = np.argsort(np.argsort(np.array(self.roots, dtype=object)))
        rank = np.zeros(self.capacity, np.int32)
        rank[: len(self.roots)] = order
        self.rank = torch.from_numpy(rank).to(self.device)
        self._rev += 1
        self.sync(store)

    def note_attestation(self, attesting_indices, target_epoch: int,
                         beacon_block_root: bytes) -> None:
        """Queue latest-message updates; one padded scatter batch lands
        them at the next flush point (head query / slashing / sync)."""
        if self.degraded:
            return
        try:
            self._note_attestation(attesting_indices, target_epoch, beacon_block_root)
        except Exception as e:
            self._degrade(f"note_attestation failed: {e!r}")

    def _note_attestation(self, attesting_indices, target_epoch: int,
                          beacon_block_root: bytes) -> None:
        idx = self.index_of.get(bytes(beacon_block_root))
        if idx is None:
            return
        vi = np.asarray(attesting_indices, dtype=np.int32)
        # indices past the resident registry (deposits after the justified
        # state) carry no weight in the spec walk either
        vi = vi[vi < self.weight.shape[0]]
        if vi.size == 0:
            return
        self._pending.append((vi, int(target_epoch), idx))

    def flush(self) -> None:
        """Apply queued votes in one ``apply_latest_messages`` batch,
        padded to the next power of two (the in-batch dedup keeps batched
        semantics equal to sequential application)."""
        if not self._pending:
            return
        val_idx = np.concatenate([p[0] for p in self._pending])
        epochs = np.concatenate(
            [np.full(p[0].shape[0], p[1], np.int64) for p in self._pending])
        blocks = np.concatenate(
            [np.full(p[0].shape[0], p[2], np.int32) for p in self._pending])
        self._pending.clear()
        torchrt.record_dispatch(site="resident_flush")
        k = next_pow2(val_idx.shape[0])
        pad = k - val_idx.shape[0]
        # padded entries: new_block = -1 never lands; epoch 0 and a later
        # position never beat a real entry in the dedup tournament
        val_idx = np.concatenate([val_idx, np.zeros(pad, np.int32)])
        blocks = np.concatenate([blocks, np.full(pad, -1, np.int32)])
        epochs = np.concatenate([epochs, np.zeros(pad, np.int64)])
        host = np.concatenate([val_idx.astype(np.int64), blocks.astype(np.int64), epochs])
        dev = torch.from_numpy(host).to(self.device)
        vi, nb, ne = dev[:k], dev[k:2 * k].to(torch.int32), dev[2 * k:]
        self.msg_block, self.msg_epoch, self.buckets = apply_latest_messages(
            self.msg_block, self.msg_epoch, self.buckets, vi, nb, ne,
            self.weight[vi], self.ok[vi])
        self._rev += 1
        self.stats["flushes"] += 1

    def note_slashing(self, indices) -> None:
        """Mirror ``on_attester_slashing``: discount landed votes and bar
        future ones."""
        if self.degraded:
            return
        try:
            self._note_slashing(indices)
        except Exception as e:
            self._degrade(f"note_slashing failed: {e!r}")

    def _note_slashing(self, indices) -> None:
        idx = np.asarray(sorted(set(int(i) for i in indices)), dtype=np.int64)
        idx = idx[idx < self.weight.shape[0]]
        if idx.size == 0:
            return
        self.flush()  # ordering: votes before the evidence still land
        vi = torch.from_numpy(idx).to(self.device)
        self.msg_block, self.msg_epoch, self.buckets = remove_latest_messages(
            self.msg_block, self.msg_epoch, self.buckets, vi, self.weight[vi])
        self.ok[vi] = False
        self.weight[vi] = 0
        self._rev += 1

    # -- queries ---------------------------------------------------------------

    def _memo_key(self, store) -> tuple:
        return (self._rev, self._store_fingerprint(store),
                bytes(store.proposer_boost_root), len(store.blocks))

    def head(self, store) -> bytes:
        """Flush pending votes, read the boost scalars from the spec store,
        descend on the device. A repeated query with no mutation between
        answers from the memo. Fresh computations are audited every
        ``selfcheck_every`` against the host walk. Once degraded every
        query answers from the spec walk."""
        from pos_evolution_tpu_torch.specs.forkchoice import get_head
        if self.degraded:
            return get_head(store)
        try:
            if not self._pending and self._head_memo is not None:
                key, root = self._head_memo
                if key == self._memo_key(store):
                    self.stats["memo_hits"] += 1
                    return root
            root = self._device_head(store)
            self._head_memo = (self._memo_key(store), root)
        except Exception as e:
            self._degrade(f"device head query failed: {e!r}")
            return get_head(store)
        self._head_queries += 1
        self.stats["device_heads"] += 1
        if self.selfcheck_every and self._head_queries % self.selfcheck_every == 0:
            deep_period = self.selfcheck_every * self.DEEPCHECK_FACTOR
            if self._head_queries % deep_period == 0:
                spec_root = get_head(store)   # fully independent oracle
            else:
                from pos_evolution_tpu_torch.ops import forkchoice
                spec_root = forkchoice.get_head_host(store)
            if spec_root != root:
                self._degrade(
                    f"divergence self-check at query {self._head_queries}: "
                    f"device={root.hex()[:8]} spec={spec_root.hex()[:8]}")
                return spec_root
        return root

    def _device_head(self, store) -> bytes:
        from pos_evolution_tpu_torch.specs.forkchoice import get_proposer_boost
        self.sync(store)
        self.flush()
        boost_idx = -1
        boost_amount = 0
        if store.proposer_boost_root != b"\x00" * 32:
            bi = self.index_of.get(bytes(store.proposer_boost_root))
            if bi is not None:
                boost_idx = bi
                boost_amount = get_proposer_boost(store)
        justified_idx = self.index_of[bytes(store.justified_checkpoint.root)]
        torchrt.record_dispatch(site="resident_head")
        head_idx, _ = head_from_buckets(
            self.parent, self.real, self.rank, self.leaf_viable, justified_idx,
            self.buckets, boost_idx, boost_amount, self.capacity)
        # the int() readback is the query's one device-to-host copy
        torchrt.record_transfer(4, direction="d2h", site="resident_head")
        return self.roots[int(head_idx)]

    def arrays(self) -> dict:
        """The resident image as host numpy, by the JAX store's attribute
        names (``convert.resident_to_port`` takes the same dict)."""
        out = {f: getattr(self, f).cpu().numpy() for f in RESIDENT_ARRAYS}
        out["roots"] = list(self.roots)
        return out


# the device columns of a resident store, by attribute name
RESIDENT_ARRAYS = ("parent", "slot", "rank", "real", "leaf_viable", "msg_block",
                   "msg_epoch", "ok", "weight", "buckets")


def apply_block_batch(state, signed_blocks, validate_result: bool = True,
                      pre_block=None, on_applied=None) -> None:
    """Apply a parent-linked run of signed blocks to ``state`` in place
    through the thread backend's ``multi_block_apply`` (one carried state,
    the block sweep's resident columns kept from block to block)."""
    from pos_evolution_tpu_torch.backend import get_backend
    get_backend().multi_block_apply(state, signed_blocks, validate_result,
                                    pre_block=pre_block, on_applied=on_applied)
