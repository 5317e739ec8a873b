"""Validator duties (L5): proposing and attesting (pos-evolution.md:597,
681-683, 762-764).

Proposers build a ``BeaconBlock`` on the head output of their fork choice;
attesters cast a combined LMD-GHOST head vote + FFG source/target vote
(pos-evolution.md:683). These builders are used by the round-based
simulation driver (L6) and by the transition/fork-choice tests.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    cfg,
)
from pos_evolution_tpu_torch.crypto.bls import bls
from pos_evolution_tpu_torch.specs.containers import (
    Attestation,
    AttestationData,
    BeaconBlock,
    BeaconBlockBody,
    BeaconState,
    Checkpoint,
    SignedBeaconBlock,
    SyncAggregate,
)
from pos_evolution_tpu_torch.specs.genesis import validator_secret_key
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_domain,
)
from pos_evolution_tpu_torch.specs.transition import (
    process_block,
    process_slots,
    verify_block_signature,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root
from pos_evolution_tpu_torch.ssz.core import uint64
from pos_evolution_tpu_torch.config import DOMAIN_BEACON_PROPOSER


def get_committee_assignment(state: BeaconState, epoch: int,
                             validator_index: int):
    """Duty lookup: (committee, committee_index, slot) for the validator's
    attestation duty in ``epoch``, or None (pos-evolution.md:450-455: one
    committee per validator per epoch)."""
    from pos_evolution_tpu_torch.specs.helpers import get_committee_count_per_slot
    next_epoch = get_current_epoch(state) + 1
    assert epoch <= next_epoch
    start_slot = compute_start_slot_at_epoch(epoch)
    committees_per_slot = get_committee_count_per_slot(state, epoch)
    for slot in range(start_slot, start_slot + cfg().slots_per_epoch):
        for index in range(committees_per_slot):
            committee = get_beacon_committee(state, slot, index)
            if validator_index in committee:
                return committee, index, slot
    return None


def advance_state_to_slot(state: BeaconState, slot: int) -> BeaconState:
    """Copy of ``state`` advanced through empty slots to ``slot``."""
    out = state.copy()
    if int(out.slot) < slot:
        process_slots(out, slot)
    return out


def sign_block(state: BeaconState, block: BeaconBlock) -> SignedBeaconBlock:
    sk = validator_secret_key(int(block.proposer_index))
    signing_root = compute_signing_root(block, get_domain(state, DOMAIN_BEACON_PROPOSER))
    return SignedBeaconBlock(message=block, signature=bls.Sign(sk, signing_root))


def make_sync_aggregate(state: BeaconState, block_root: bytes,
                        participants=None) -> SyncAggregate:
    """Sync-committee duty (pos-evolution.md:548-557): current committee
    members sign the head ``block_root`` for inclusion in the next block.

    ``state`` must be advanced to the including block's slot, so the signed
    root is what ``process_sync_aggregate`` reconstructs (the block root at
    the previous slot — the proposal's parent). ``participants`` restricts
    signing to a validator-index subset (sleepy/corrupted members abstain);
    None signs with the full committee. Bits are container-width (the
    mainnet 512 limit) with one lane per committee pubkey.
    """
    previous_slot = max(int(state.slot), 1) - 1
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE,
                        compute_epoch_at_slot(previous_slot))
    from pos_evolution_tpu_torch.specs.transition import compute_signing_root_bytes
    signing_root = compute_signing_root_bytes(bytes(block_root), domain)
    width = SyncAggregate._fields["sync_committee_bits"].length
    bits = np.zeros(width, dtype=bool)
    participant_set = (set(int(v) for v in participants)
                       if participants is not None else None)
    sigs = []
    for lane, pubkey in enumerate(state.current_sync_committee.pubkeys):
        index = state.validators.find_pubkey(bytes(pubkey))
        if index is None:
            continue
        if participant_set is not None and index not in participant_set:
            continue
        bits[lane] = True
        sigs.append(bls.Sign(validator_secret_key(index), signing_root))
    if not sigs:
        return SyncAggregate()
    return SyncAggregate(sync_committee_bits=bits,
                         sync_committee_signature=bls.Aggregate(sigs))


def build_block(parent_state: BeaconState, slot: int, attestations=(),
                attester_slashings=(), deposits=(), voluntary_exits=(),
                graffiti: bytes = b"\x00" * 32,
                execution_payload=None, sync_aggregate=None) -> SignedBeaconBlock:
    """Produce a valid signed block for ``slot`` on top of ``parent_state``.

    Follows the proposer duty of pos-evolution.md:597: run the state forward,
    pick the proposer, reveal RANDAO, pack operations, then fill in the
    post-state root (pos-evolution.md:423 check).
    """
    state = advance_state_to_slot(parent_state, slot)
    proposer_index = get_beacon_proposer_index(state)
    epoch = get_current_epoch(state)

    sk = validator_secret_key(proposer_index)
    randao_reveal = bls.Sign(
        sk, compute_signing_root(epoch, get_domain(state, DOMAIN_RANDAO), uint64))

    body = BeaconBlockBody(
        randao_reveal=randao_reveal,
        eth1_data=state.eth1_data.copy(),
        graffiti=graffiti,
        attestations=list(attestations),
        attester_slashings=list(attester_slashings),
        deposits=list(deposits),
        voluntary_exits=list(voluntary_exits),
    )
    if execution_payload is not None:
        body.execution_payload = execution_payload
    if sync_aggregate is not None:
        body.sync_aggregate = sync_aggregate
    block = BeaconBlock(
        slot=slot,
        proposer_index=proposer_index,
        parent_root=hash_tree_root(state.latest_block_header),
        state_root=b"\x00" * 32,
        body=body,
    )
    # Compute the post-state root by applying the block to the advanced state.
    post = state.copy()
    process_block(post, block)
    block.state_root = hash_tree_root(post)
    return sign_block(state, block)


def make_attestation_data(state: BeaconState, slot: int, index: int,
                          head_root: bytes) -> AttestationData:
    """Combined GHOST + FFG vote (pos-evolution.md:681-683, 689-696).

    ``state`` must be (a copy of) the head state advanced to ``slot``.
    """
    epoch = compute_epoch_at_slot(slot)
    start_slot = compute_start_slot_at_epoch(epoch)
    if start_slot == int(state.slot):
        epoch_boundary_root = bytes(head_root)
    else:
        epoch_boundary_root = get_block_root_at_slot(state, start_slot)
    return AttestationData(
        slot=slot,
        index=index,
        beacon_block_root=bytes(head_root),
        source=state.current_justified_checkpoint.copy(),
        target=Checkpoint(epoch=epoch, root=epoch_boundary_root),
    )


def sign_attestation_data(state: BeaconState, data: AttestationData,
                          validator_index: int) -> bytes:
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, int(data.target.epoch))
    signing_root = compute_signing_root(data, domain)
    return bls.Sign(validator_secret_key(validator_index), signing_root)


def make_committee_attestation(state: BeaconState, slot: int, index: int,
                               head_root: bytes,
                               participants: np.ndarray | None = None) -> Attestation:
    """Aggregate attestation by (a subset of) committee ``index`` at ``slot``."""
    committee = get_beacon_committee(state, slot, index)
    data = make_attestation_data(state, slot, index, head_root)
    bits = np.zeros(committee.shape[0], dtype=bool)
    sigs = []
    participant_set = set(int(v) for v in participants) if participants is not None else None
    for pos, vidx in enumerate(committee):
        vidx = int(vidx)
        if participant_set is not None and vidx not in participant_set:
            continue
        bits[pos] = True
        sigs.append(sign_attestation_data(state, data, vidx))
    if not sigs:
        raise ValueError("no participants in committee")
    return Attestation(aggregation_bits=bits, data=data, signature=bls.Aggregate(sigs))


def attest_all_committees(state: BeaconState, slot: int, head_root: bytes,
                          participants: np.ndarray | None = None) -> list[Attestation]:
    """One aggregate per committee of ``slot`` (full or masked participation)."""
    epoch = compute_epoch_at_slot(slot)
    count = get_committee_count_per_slot(state, epoch)
    out = []
    for index in range(count):
        try:
            out.append(make_committee_attestation(state, slot, index, head_root,
                                                  participants))
        except ValueError:
            continue
    return out
