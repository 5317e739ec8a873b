"""``LightClientNode``: a simulation participant that follows the chain
through light-client updates only.

The node never holds a ``BeaconState``: it boots from a weak-subjectivity
checkpoint (``LightClientBootstrap``), consumes one update per slot from a
serving full node (subject to the run's ``FaultPlan`` — dropped updates are
simply never seen), force-updates after a sync-committee-period timeout, and
reports head-lag / finality-lag through ``utils/metrics``.
"""

from __future__ import annotations

from pos_evolution_tpu_torch.lightclient.spec import (
    LightClientStore,
    initialize_light_client_store,
    process_light_client_store_force_update,
    process_light_client_update,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root
from pos_evolution_tpu_torch.utils.metrics import HandlerTimer, light_client_lag_record

__all__ = ["LightClientNode"]


class LightClientNode:
    """One light client following a simulated chain."""

    def __init__(self, store: LightClientStore, node_id: int = 0):
        self.store = store
        self.id = node_id
        self.records: list[dict] = []
        self.timer = HandlerTimer()
        self.updates_applied = 0
        self.updates_rejected = 0
        self.forced_updates = 0

    @classmethod
    def from_bootstrap(cls, trusted_block_root: bytes, bootstrap,
                       fork_version: bytes, genesis_validators_root: bytes,
                       node_id: int = 0) -> "LightClientNode":
        store = initialize_light_client_store(
            trusted_block_root, bootstrap, fork_version, genesis_validators_root)
        return cls(store, node_id=node_id)

    # -- protocol events -------------------------------------------------------

    def on_update(self, update, current_slot: int) -> bool:
        """Process one served update; invalid updates are counted and
        dropped (a real client would also descore the peer)."""
        try:
            with self.timer.track("process_light_client_update"):
                process_light_client_update(self.store, update, current_slot)
            self.updates_applied += 1
            return True
        except AssertionError:
            self.updates_rejected += 1
            return False

    def advance(self, slot: int, full_head_slot: int,
                full_finalized_epoch: int) -> dict:
        """End-of-slot housekeeping: run the force-update timeout and record
        how far this client trails the full node it follows."""
        before = int(self.store.finalized_header.slot)
        with self.timer.track("force_update"):
            process_light_client_store_force_update(self.store, slot)
        if int(self.store.finalized_header.slot) != before:
            self.forced_updates += 1
        record = light_client_lag_record(
            self.store, slot, full_head_slot, full_finalized_epoch)
        self.records.append(record)
        return record

    # -- accessors --------------------------------------------------------------

    @property
    def head_slot(self) -> int:
        return int(self.store.optimistic_header.slot)

    @property
    def finalized_slot(self) -> int:
        return int(self.store.finalized_header.slot)

    def finalized_root(self) -> bytes:
        return hash_tree_root(self.store.finalized_header)

    def summary(self) -> dict:
        return {
            "applied": self.updates_applied,
            "rejected": self.updates_rejected,
            "forced": self.forced_updates,
            "head_slot": self.head_slot,
            "finalized_slot": self.finalized_slot,
            "timing": self.timer.summary(),
        }
