"""Light-client containers (Altair sync protocol, pyspec dialect).

Sync committees exist solely so resource-constrained clients can follow the
chain without replaying state transitions (pos-evolution.md:542): a light
client holds a ~500-key committee, verifies one aggregate signature per
update, and checks two merkle branches into the attested ``BeaconState``.

The branch geometry is *derived from the container layout* rather than
hard-coded: ``BeaconState`` has 25 fields, so its field tree is depth
``STATE_TREE_DEPTH`` (= 5, padded to 32 chunks), ``finalized_checkpoint``
sits at field index 20 and its ``root`` one level deeper (generalized index
2**6 + 41 — the Altair ``FINALIZED_ROOT_INDEX`` layout, which this state
reproduces field-for-field), and the two sync committees at field indices
22/23. If a later fork appends state fields the constants move with it.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.specs.containers import (
    BeaconBlockHeader,
    BeaconState,
    RootVector,
    SyncAggregate,
    SyncCommittee,
)
from pos_evolution_tpu_torch.ssz.core import Container, uint64
from pos_evolution_tpu_torch.ssz.merkle import next_pow_of_two

__all__ = [
    "STATE_TREE_DEPTH",
    "FINALIZED_ROOT_DEPTH",
    "FINALIZED_ROOT_INDEX",
    "CURRENT_SYNC_COMMITTEE_INDEX",
    "NEXT_SYNC_COMMITTEE_INDEX",
    "LightClientHeader",
    "LightClientBootstrap",
    "LightClientUpdate",
    "LightClientFinalityUpdate",
    "LightClientOptimisticUpdate",
    "sync_committee_lanes",
    "participation_bits",
]

_STATE_FIELDS = list(BeaconState._fields)

#: Depth of the BeaconState field tree (fields padded to a power of two).
STATE_TREE_DEPTH = (next_pow_of_two(len(_STATE_FIELDS)) - 1).bit_length()

#: ``state.finalized_checkpoint.root``: one Checkpoint level below the field
#: tree — leaf is the checkpoint's ``root`` chunk (right child, hence ``*2+1``).
FINALIZED_ROOT_DEPTH = STATE_TREE_DEPTH + 1
FINALIZED_ROOT_INDEX = _STATE_FIELDS.index("finalized_checkpoint") * 2 + 1

#: ``state.current_sync_committee`` / ``state.next_sync_committee`` field leaves.
CURRENT_SYNC_COMMITTEE_INDEX = _STATE_FIELDS.index("current_sync_committee")
NEXT_SYNC_COMMITTEE_INDEX = _STATE_FIELDS.index("next_sync_committee")


class LightClientHeader(Container):
    """Altair-style header envelope (just the beacon header; later forks add
    execution fields here, which is why it is a container and not an alias)."""

    beacon: BeaconBlockHeader


class LightClientBootstrap(Container):
    """Trusted starting point: the checkpoint header plus its state's current
    sync committee, proven into ``header.beacon.state_root``."""

    header: LightClientHeader
    current_sync_committee: SyncCommittee
    current_sync_committee_branch: RootVector(STATE_TREE_DEPTH)


class LightClientUpdate(Container):
    """One step of the sync protocol: a sync-aggregate-signed attested header,
    optional proof of the attested state's next sync committee, and optional
    proof of its finalized checkpoint."""

    attested_header: LightClientHeader
    next_sync_committee: SyncCommittee
    next_sync_committee_branch: RootVector(STATE_TREE_DEPTH)
    finalized_header: LightClientHeader
    finality_branch: RootVector(FINALIZED_ROOT_DEPTH)
    sync_aggregate: SyncAggregate
    signature_slot: uint64


class LightClientFinalityUpdate(Container):
    attested_header: LightClientHeader
    finalized_header: LightClientHeader
    finality_branch: RootVector(FINALIZED_ROOT_DEPTH)
    sync_aggregate: SyncAggregate
    signature_slot: uint64


class LightClientOptimisticUpdate(Container):
    attested_header: LightClientHeader
    sync_aggregate: SyncAggregate
    signature_slot: uint64


def sync_committee_lanes(committee: SyncCommittee) -> int:
    """Runtime lane count of a committee (``cfg().sync_committee_size``; the
    container's declared 512 limit is the mainnet preset)."""
    return len(committee.pubkeys)


def participation_bits(aggregate: SyncAggregate, lanes: int) -> np.ndarray:
    """First ``lanes`` bits of the (container-width) sync committee bitvector."""
    bits = np.asarray(aggregate.sync_committee_bits, dtype=bool)
    return bits[:lanes]
