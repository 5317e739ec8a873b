"""Light-client store state machine (Altair sync protocol, pyspec dialect).

The client holds only headers and sync committees — never a ``BeaconState``
— and advances by verifying ``LightClientUpdate``s: check the two merkle
branches into the attested state root, check the sync-aggregate signature
with the committee for the signature period, then

- finalize when a supermajority-signed update carries a finality proof
  (``process_light_client_update``);
- track the best-seen update per period otherwise, and **force-apply** it
  when no finalizing update has arrived for a whole sync-committee period
  (``process_light_client_store_force_update``) — the liveness escape hatch
  for lossy links where every finality update was dropped.

Crypto and hashing route through lightclient/verify.py, i.e. through the
ExecutionBackend dispatch (batched on device under the ``jax`` backend).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.lightclient.containers import (
    CURRENT_SYNC_COMMITTEE_INDEX,
    STATE_TREE_DEPTH,
    LightClientBootstrap,
    LightClientFinalityUpdate,
    LightClientOptimisticUpdate,
    LightClientUpdate,
    participation_bits,
    sync_committee_lanes,
)
from pos_evolution_tpu_torch.lightclient.verify import (
    is_finality_update,
    is_sync_committee_update,
    verify_updates,
)
from pos_evolution_tpu_torch.specs.containers import BeaconBlockHeader, SyncCommittee
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    compute_sync_committee_period,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root, is_valid_merkle_branch

__all__ = [
    "LightClientStore",
    "MIN_SYNC_COMMITTEE_PARTICIPANTS",
    "initialize_light_client_store",
    "validate_light_client_update",
    "apply_light_client_update",
    "process_light_client_update",
    "process_light_client_finality_update",
    "process_light_client_optimistic_update",
    "process_light_client_store_force_update",
    "is_better_update",
    "sync_period_at_slot",
    "update_timeout_slots",
    "finality_update_from",
    "optimistic_update_from",
]

MIN_SYNC_COMMITTEE_PARTICIPANTS = 1


def sync_period_at_slot(slot: int) -> int:
    return compute_sync_committee_period(compute_epoch_at_slot(int(slot)))


def update_timeout_slots() -> int:
    """Force-update timeout: one full sync-committee period of slots."""
    c = cfg()
    return c.epochs_per_sync_committee_period * c.slots_per_epoch


@dataclass
class LightClientStore:
    """Everything a light client persists (pos-evolution.md:542 capability)."""

    finalized_header: BeaconBlockHeader
    current_sync_committee: SyncCommittee
    next_sync_committee: SyncCommittee | None = None
    best_valid_update: LightClientUpdate | None = None
    optimistic_header: BeaconBlockHeader = field(default_factory=BeaconBlockHeader)
    previous_max_active_participants: int = 0
    current_max_active_participants: int = 0
    # Signature-domain inputs captured at bootstrap (the client never sees a
    # state to call get_domain on).
    fork_version: bytes = b"\x00" * 4
    genesis_validators_root: bytes = b"\x00" * 32

    def finalized_period(self) -> int:
        return sync_period_at_slot(int(self.finalized_header.slot))


def initialize_light_client_store(trusted_block_root: bytes,
                                  bootstrap: LightClientBootstrap,
                                  fork_version: bytes,
                                  genesis_validators_root: bytes) -> LightClientStore:
    """Bootstrap from a trusted (weak-subjectivity) block root: the header
    must hash to the trusted root and the committee must prove into its
    state root."""
    header = bootstrap.header.beacon
    assert hash_tree_root(header) == bytes(trusted_block_root), \
        "bootstrap header does not match trusted root"
    branch = bootstrap.current_sync_committee_branch
    assert is_valid_merkle_branch(
        leaf=hash_tree_root(bootstrap.current_sync_committee),
        branch=[branch[i].tobytes() for i in range(branch.shape[0])],
        depth=STATE_TREE_DEPTH,
        index=CURRENT_SYNC_COMMITTEE_INDEX,
        root=bytes(header.state_root),
    ), "invalid current-sync-committee proof"
    return LightClientStore(
        finalized_header=header.copy(),
        current_sync_committee=bootstrap.current_sync_committee.copy(),
        optimistic_header=header.copy(),
        fork_version=bytes(fork_version),
        genesis_validators_root=bytes(genesis_validators_root),
    )


def _participation(store: LightClientStore, update) -> int:
    return int(participation_bits(
        update.sync_aggregate,
        sync_committee_lanes(store.current_sync_committee)).sum())


def validate_light_client_update(store: LightClientStore, update,
                                 current_slot: int) -> None:
    """All asserts of one update; crypto via the ExecutionBackend batch op."""
    assert _participation(store, update) >= MIN_SYNC_COMMITTEE_PARTICIPANTS, \
        "no sync committee participation"
    attested = update.attested_header.beacon
    assert int(current_slot) >= int(update.signature_slot) > int(attested.slot), \
        "update from the future / signature not after attested slot"

    store_period = store.finalized_period()
    sig_period = sync_period_at_slot(int(update.signature_slot))
    if store.next_sync_committee is not None:
        assert sig_period in (store_period, store_period + 1), \
            "signature period out of range"
    else:
        assert sig_period == store_period, \
            "next committee unknown: can only verify the current period"

    # Relevance: new finality, or teaches us the unknown next committee.
    attested_period = sync_period_at_slot(int(attested.slot))
    has_next = is_sync_committee_update(update)
    assert (int(attested.slot) > int(store.finalized_header.slot)
            or (attested_period == store_period and has_next
                and store.next_sync_committee is None)), "irrelevant update"

    if is_finality_update(update):
        finalized = update.finalized_header.beacon
        assert int(attested.slot) >= int(finalized.slot), \
            "finalized header newer than attested"
    if has_next:
        assert attested_period == sig_period, \
            "next-committee proof must come from the signature period"

    committee = (store.current_sync_committee if sig_period == store_period
                 else store.next_sync_committee)
    res = verify_updates([update], [committee], store.fork_version,
                         store.genesis_validators_root)
    assert bool(res["sig_ok"][0]), "bad sync aggregate signature"
    if is_finality_update(update):
        assert bool(res["fin_ok"][0]), "invalid finality proof"
    if has_next:
        assert bool(res["sc_ok"][0]), "invalid next-sync-committee proof"


def _effective_finalized(update) -> BeaconBlockHeader:
    """Header an applied update finalizes: the proven finalized header, or —
    for force-applied proofless updates — the attested header itself."""
    if is_finality_update(update):
        return update.finalized_header.beacon
    return update.attested_header.beacon


def apply_light_client_update(store: LightClientStore, update,
                              finalized: BeaconBlockHeader | None = None) -> None:
    store_period = store.finalized_period()
    if finalized is None:
        finalized = _effective_finalized(update)
    finalized_period = sync_period_at_slot(int(finalized.slot))
    if store.next_sync_committee is None:
        assert finalized_period == store_period
        if is_sync_committee_update(update):
            store.next_sync_committee = update.next_sync_committee.copy()
    elif finalized_period == store_period + 1:
        store.current_sync_committee = store.next_sync_committee
        store.next_sync_committee = (update.next_sync_committee.copy()
                                     if is_sync_committee_update(update) else None)
        store.previous_max_active_participants = store.current_max_active_participants
        store.current_max_active_participants = 0
    if int(finalized.slot) > int(store.finalized_header.slot):
        store.finalized_header = finalized.copy()
        if int(finalized.slot) > int(store.optimistic_header.slot):
            store.optimistic_header = finalized.copy()


def is_better_update(store: LightClientStore, new, old) -> bool:
    """Ranked preference for the force-update candidate: supermajority, then
    finality proof, then participation, then newer attested head."""
    lanes = sync_committee_lanes(store.current_sync_committee)

    def score(u):
        p = _participation(store, u)
        return (int(p * 3 >= lanes * 2), int(is_finality_update(u)), p,
                int(u.attested_header.beacon.slot))

    return score(new) > score(old)


def process_light_client_update(store: LightClientStore, update,
                                current_slot: int) -> None:
    validate_light_client_update(store, update, current_slot)
    participation = _participation(store, update)
    lanes = sync_committee_lanes(store.current_sync_committee)

    if (store.best_valid_update is None
            or is_better_update(store, update, store.best_valid_update)):
        store.best_valid_update = update
    store.current_max_active_participants = max(
        store.current_max_active_participants, participation)

    # Optimistic head: enough participation to beat the safety threshold.
    safety_threshold = max(store.previous_max_active_participants,
                           store.current_max_active_participants) // 2
    attested = update.attested_header.beacon
    if (participation > safety_threshold
            and int(attested.slot) > int(store.optimistic_header.slot)):
        store.optimistic_header = attested.copy()

    # Finalize on a 2/3-supermajority update that makes finality PROGRESS
    # (or teaches the unknown next committee). Without the progress gate, a
    # long non-finality stretch of updates re-proving the same old
    # checkpoint would repeatedly clear ``best_valid_update`` and starve
    # the force-update escape hatch.
    finalized = update.finalized_header.beacon if is_finality_update(update) else None
    teaches_next_committee = (
        store.next_sync_committee is None
        and is_sync_committee_update(update) and finalized is not None
        and sync_period_at_slot(int(finalized.slot))
        == sync_period_at_slot(int(attested.slot)))
    makes_progress = (finalized is not None
                      and int(finalized.slot) > int(store.finalized_header.slot))
    if (participation * 3 >= lanes * 2
            and (makes_progress or teaches_next_committee)):
        apply_light_client_update(store, update)
        store.best_valid_update = None


def process_light_client_finality_update(store: LightClientStore,
                                         finality_update: LightClientFinalityUpdate,
                                         current_slot: int) -> None:
    process_light_client_update(store, _expand(finality_update), current_slot)


def process_light_client_optimistic_update(store: LightClientStore,
                                           optimistic_update: LightClientOptimisticUpdate,
                                           current_slot: int) -> None:
    process_light_client_update(store, _expand(optimistic_update), current_slot)


def process_light_client_store_force_update(store: LightClientStore,
                                            current_slot: int) -> None:
    """Timeout path: if a whole sync-committee period has elapsed without a
    finalizing update, trust the best-seen valid update. A stale finality
    proof (during a finality stall every served update re-proves the OLD
    checkpoint) is substituted with the attested header — otherwise the
    escape hatch would never advance the store and the client would wedge
    once signature slots outran its known committee periods."""
    if (int(current_slot) > int(store.finalized_header.slot) + update_timeout_slots()
            and store.best_valid_update is not None):
        update = store.best_valid_update
        finalized = _effective_finalized(update)
        if int(finalized.slot) <= int(store.finalized_header.slot):
            finalized = update.attested_header.beacon
        apply_light_client_update(store, update, finalized=finalized)
        store.best_valid_update = None


def _expand(partial_update) -> LightClientUpdate:
    """Lift a finality/optimistic slice to a full update (absent proof
    groups stay zeroed, i.e. "not present")."""
    kw = dict(attested_header=partial_update.attested_header,
              sync_aggregate=partial_update.sync_aggregate,
              signature_slot=int(partial_update.signature_slot))
    if hasattr(partial_update, "finalized_header"):
        kw["finalized_header"] = partial_update.finalized_header
        kw["finality_branch"] = partial_update.finality_branch
    return LightClientUpdate(**kw)


def finality_update_from(update: LightClientUpdate) -> LightClientFinalityUpdate:
    return LightClientFinalityUpdate(
        attested_header=update.attested_header,
        finalized_header=update.finalized_header,
        finality_branch=update.finality_branch,
        sync_aggregate=update.sync_aggregate,
        signature_slot=int(update.signature_slot),
    )


def optimistic_update_from(update: LightClientUpdate) -> LightClientOptimisticUpdate:
    return LightClientOptimisticUpdate(
        attested_header=update.attested_header,
        sync_aggregate=update.sync_aggregate,
        signature_slot=int(update.signature_slot),
    )
