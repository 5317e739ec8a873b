"""Beacon state transition (L2): ``state_transition`` and block processing.

The single mutation entry point of the reference (pos-evolution.md:412-424)
with slot processing, signature verification, and the per-operation
processors: attestations (:722-755), deposits (:139-175), proposer/attester
slashings (:1154-1162), voluntary exits (:251-259), RANDAO, eth1 data,
sync aggregate (:642), execution payload (:374, simulated).
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import (
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_VOLUNTARY_EXIT,
    FAR_FUTURE_EPOCH,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    WEIGHT_DENOMINATOR,
    cfg,
)
from pos_evolution_tpu_torch.crypto.bls import bls
from pos_evolution_tpu_torch.specs.containers import (
    Attestation,
    AttesterSlashing,
    BeaconBlock,
    BeaconBlockHeader,
    BeaconState,
    Deposit,
    DepositMessage,
    ProposerSlashing,
    SignedBeaconBlock,
    SignedVoluntaryExit,
    SyncAggregate,
)
from pos_evolution_tpu_torch.specs.epoch import process_epoch
from pos_evolution_tpu_torch.specs.helpers import (
    compute_domain,
    compute_epoch_at_slot,
    compute_signing_root,
    decrease_balance,
    get_attestation_participation_flag_indices,
    get_attesting_indices,
    get_base_reward_per_increment,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_domain,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_validator_from_deposit,
    increase_balance,
    is_active_validator,
    is_slashable_attestation_data,
    is_slashable_validator,
    is_valid_indexed_attestation,
    slash_validator,
)
from pos_evolution_tpu_torch.ssz import hash_eth2, hash_tree_root, is_valid_merkle_branch
from pos_evolution_tpu_torch.ssz.core import uint64


def state_transition(state: BeaconState, signed_block: SignedBeaconBlock,
                     validate_result: bool = True) -> None:
    """pos-evolution.md:412-424: slots -> signature -> block -> state root."""
    block = signed_block.message
    process_slots(state, int(block.slot))
    if validate_result:
        assert verify_block_signature(state, signed_block), "invalid block signature"
    process_block(state, block)
    if validate_result:
        assert bytes(block.state_root) == hash_tree_root(state), "state root mismatch"


def process_slots(state: BeaconState, slot: int) -> None:
    """Advance through (possibly empty) slots; run epoch processing at
    boundaries (pos-evolution.md:415, 426)."""
    assert state.slot < slot
    c = cfg()
    while state.slot < slot:
        process_slot(state)
        if (int(state.slot) + 1) % c.slots_per_epoch == 0:
            process_epoch(state)
        state.slot = int(state.slot) + 1


def process_slot(state: BeaconState) -> None:
    """Cache the state root and block root for the slot just completed."""
    sphr = state.state_roots.shape[0]
    previous_state_root = hash_tree_root(state)
    state.state_roots[int(state.slot) % sphr] = np.frombuffer(
        previous_state_root, dtype=np.uint8)
    if bytes(state.latest_block_header.state_root) == b"\x00" * 32:
        state.latest_block_header.state_root = previous_state_root
    previous_block_root = hash_tree_root(state.latest_block_header)
    state.block_roots[int(state.slot) % sphr] = np.frombuffer(
        previous_block_root, dtype=np.uint8)


def verify_block_signature(state: BeaconState, signed_block: SignedBeaconBlock) -> bool:
    """pos-evolution.md:418."""
    proposer_pubkey = state.validators.pubkeys[
        int(signed_block.message.proposer_index)].tobytes()
    signing_root = compute_signing_root(
        signed_block.message, get_domain(state, DOMAIN_BEACON_PROPOSER))
    return bls.Verify(proposer_pubkey, signing_root, signed_block.signature)


def process_block(state: BeaconState, block: BeaconBlock) -> None:
    """pos-evolution.md:420 umbrella."""
    process_block_header(state, block)
    process_randao(state, block.body)
    process_eth1_data(state, block.body)
    process_operations(state, block.body)
    process_sync_aggregate(state, block.body.sync_aggregate)
    process_execution_payload(state, block.body)


def process_block_header(state: BeaconState, block: BeaconBlock) -> None:
    assert int(block.slot) == int(state.slot), "block/state slot mismatch"
    assert int(block.slot) > int(state.latest_block_header.slot), "not newer than head"
    assert int(block.proposer_index) == get_beacon_proposer_index(state), "wrong proposer"
    assert bytes(block.parent_root) == hash_tree_root(state.latest_block_header), \
        "parent root mismatch"
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # overwritten at the next process_slot
        body_root=hash_tree_root(block.body),
    )
    assert not state.validators.slashed[int(block.proposer_index)], "proposer slashed"


def process_randao(state: BeaconState, body) -> None:
    epoch = get_current_epoch(state)
    proposer_pubkey = state.validators.pubkeys[get_beacon_proposer_index(state)].tobytes()
    signing_root = compute_signing_root(epoch, get_domain(state, DOMAIN_RANDAO), uint64)
    assert bls.Verify(proposer_pubkey, signing_root, body.randao_reveal), "bad randao reveal"
    mix = bytes(a ^ b for a, b in zip(get_randao_mix(state, epoch),
                                      hash_eth2(bytes(body.randao_reveal))))
    state.randao_mixes[epoch % state.randao_mixes.shape[0]] = np.frombuffer(
        mix, dtype=np.uint8)


def process_eth1_data(state: BeaconState, body) -> None:
    c = cfg()
    state.eth1_data_votes.append(body.eth1_data)
    period_len = c.epochs_per_eth1_voting_period * c.slots_per_epoch
    votes = sum(1 for v in state.eth1_data_votes if v == body.eth1_data)
    if votes * 2 > period_len:
        state.eth1_data = body.eth1_data


def process_operations(state: BeaconState, body) -> None:
    c = cfg()
    expected_deposits = min(c.max_deposits,
                            int(state.eth1_data.deposit_count) - int(state.eth1_deposit_index))
    assert len(body.deposits) == expected_deposits, "wrong deposit count in block"
    for op in body.proposer_slashings:
        process_proposer_slashing(state, op)
    for op in body.attester_slashings:
        process_attester_slashing(state, op)
    # Attestations: validate sequentially (spec order), then apply the whole
    # block's batch as ONE fused sweep through the ExecutionBackend
    # (ops/transition.py). Bit-identical to the per-attestation reference
    # loop: validation reads only state that attestation application never
    # mutates (committees/seeds, checkpoints, block roots, pubkeys), and the
    # sweep preserves sequential flag/reward semantics within the batch.
    atts = list(body.attestations)
    if atts:
        rows = [_validate_attestation(state, op) for op in atts]
        from pos_evolution_tpu_torch.backend import get_backend
        get_backend().block_sweep(state, rows)
    for op in body.deposits:
        process_deposit(state, op)
    for op in body.voluntary_exits:
        process_voluntary_exit(state, op)


# --- attestations (pos-evolution.md:722-755) ----------------------------------

def _validate_attestation(state: BeaconState, attestation: Attestation):
    """Everything ``process_attestation`` checks before its first mutation.

    Returns the validated row ``(attesting_indices int64[k], flag_indices,
    is_current)`` consumed by the fused sweep
    (``ops/transition.apply_attestation_rows_*``).
    """
    c = cfg()
    data = attestation.data
    assert int(data.target.epoch) in (get_previous_epoch(state), get_current_epoch(state))
    assert int(data.target.epoch) == compute_epoch_at_slot(int(data.slot))
    assert (int(data.slot) + c.min_attestation_inclusion_delay <= int(state.slot)
            <= int(data.slot) + c.slots_per_epoch)
    assert int(data.index) < get_committee_count_per_slot(state, int(data.target.epoch))

    committee = get_beacon_committee(state, int(data.slot), int(data.index))
    bits = np.asarray(attestation.aggregation_bits, dtype=bool)
    assert bits.shape[0] == committee.shape[0], "aggregation bits length mismatch"

    participation_flag_indices = get_attestation_participation_flag_indices(
        state, data, int(state.slot) - int(data.slot))

    assert is_valid_indexed_attestation(
        state, get_indexed_attestation(state, attestation)), "bad attestation signature"

    attesting = get_attesting_indices(state, data, bits).astype(np.int64)
    is_current = int(data.target.epoch) == get_current_epoch(state)
    return attesting, participation_flag_indices, is_current


def process_attestation(state: BeaconState, attestation: Attestation) -> None:
    """Reference-shaped single-attestation entry (validation + host apply).

    Hot paths batch through ``process_operations``; this keeps the spec
    signature for tests and one-off call sites, applying via the NumPy
    oracle sweep (bit-identical to the reference loop :744-749 — the
    per-attester ``get_base_reward`` collapses to the hoisted
    per-increment constant, same integer arithmetic)."""
    row = _validate_attestation(state, attestation)
    from pos_evolution_tpu_torch.ops.transition import apply_attestation_rows_host
    apply_attestation_rows_host(state, [row])


# --- deposits (pos-evolution.md:139-175) --------------------------------------

def process_deposit(state: BeaconState, deposit: Deposit) -> None:
    c = cfg()
    assert is_valid_merkle_branch(
        leaf=hash_tree_root(deposit.data),
        branch=[deposit.proof[i].tobytes() for i in range(deposit.proof.shape[0])],
        depth=c.deposit_contract_tree_depth + 1,  # +1 for the length mix-in
        index=int(state.eth1_deposit_index),
        root=bytes(state.eth1_data.deposit_root),
    ), "invalid deposit proof"

    state.eth1_deposit_index = int(state.eth1_deposit_index) + 1

    pubkey = bytes(deposit.data.pubkey)
    amount = int(deposit.data.amount)
    existing = state.validators.find_pubkey(pubkey)
    if existing is None:
        deposit_message = DepositMessage(
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
        )
        domain = compute_domain(DOMAIN_DEPOSIT)  # fork-agnostic
        signing_root = compute_signing_root(deposit_message, domain)
        if bls.Verify(pubkey, signing_root, deposit.data.signature):
            state.validators.append(get_validator_from_deposit(state, deposit.data))
            state.balances = np.append(state.balances, np.uint64(amount))
            state.previous_epoch_participation = np.append(
                state.previous_epoch_participation, np.uint8(0))
            state.current_epoch_participation = np.append(
                state.current_epoch_participation, np.uint8(0))
            state.inactivity_scores = np.append(state.inactivity_scores, np.uint64(0))
    else:
        increase_balance(state, existing, amount)


# --- slashings ----------------------------------------------------------------

def process_proposer_slashing(state: BeaconState, slashing: ProposerSlashing) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    assert int(h1.slot) == int(h2.slot), "headers from different slots"
    assert int(h1.proposer_index) == int(h2.proposer_index), "different proposers"
    assert h1 != h2, "headers identical"
    proposer_index = int(h1.proposer_index)
    proposer = state.validators[proposer_index]
    assert is_slashable_validator(proposer, get_current_epoch(state))
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER,
                            compute_epoch_at_slot(int(signed_header.message.slot)))
        signing_root = compute_signing_root(signed_header.message, domain)
        assert bls.Verify(bytes(proposer.pubkey), signing_root, signed_header.signature)
    slash_validator(state, proposer_index)


def process_attester_slashing(state: BeaconState, slashing: AttesterSlashing) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    assert is_slashable_attestation_data(a1.data, a2.data), "not slashable"
    assert is_valid_indexed_attestation(state, a1)
    assert is_valid_indexed_attestation(state, a2)
    slashed_any = False
    common = sorted(set(int(i) for i in np.asarray(a1.attesting_indices))
                    & set(int(i) for i in np.asarray(a2.attesting_indices)))
    for index in common:
        if is_slashable_validator(state.validators[index], get_current_epoch(state)):
            slash_validator(state, index)
            slashed_any = True
    assert slashed_any, "no slashable intersection"


def process_voluntary_exit(state: BeaconState, signed_exit: SignedVoluntaryExit) -> None:
    c = cfg()
    exit_msg = signed_exit.message
    index = int(exit_msg.validator_index)
    validator = state.validators[index]
    assert is_active_validator(validator, get_current_epoch(state))
    assert validator.exit_epoch == FAR_FUTURE_EPOCH
    assert get_current_epoch(state) >= int(exit_msg.epoch)
    assert get_current_epoch(state) >= validator.activation_epoch + c.shard_committee_period
    domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, int(exit_msg.epoch))
    signing_root = compute_signing_root(exit_msg, domain)
    assert bls.Verify(bytes(validator.pubkey), signing_root, signed_exit.signature)
    from pos_evolution_tpu_torch.specs.helpers import initiate_validator_exit
    initiate_validator_exit(state, index)


# --- sync aggregate (pos-evolution.md:642, 548-557) ---------------------------

def process_sync_aggregate(state: BeaconState, aggregate: SyncAggregate) -> None:
    c = cfg()
    bits = np.asarray(aggregate.sync_committee_bits, dtype=bool)
    committee_pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    if bits.shape[0] != len(committee_pubkeys):
        bits = bits[: len(committee_pubkeys)]
    participant_pubkeys = [pk for pk, b in zip(committee_pubkeys, bits) if b]

    previous_slot = max(int(state.slot), 1) - 1
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, compute_epoch_at_slot(previous_slot))
    signing_root = compute_signing_root_bytes(
        get_block_root_at_slot(state, previous_slot), domain)
    if participant_pubkeys:
        assert bls.FastAggregateVerify(
            participant_pubkeys, signing_root,
            aggregate.sync_committee_signature), "bad sync aggregate"

    # Rewards: participants and proposer.
    total_active_increments = (get_total_active_balance(state)
                               // c.effective_balance_increment)
    total_base_rewards = get_base_reward_per_increment(state) * total_active_increments
    max_participant_rewards = (total_base_rewards * SYNC_REWARD_WEIGHT
                               // WEIGHT_DENOMINATOR // c.slots_per_epoch)
    committee_size = max(len(committee_pubkeys), 1)
    participant_reward = max_participant_rewards // committee_size
    proposer_reward = (participant_reward * PROPOSER_WEIGHT
                       // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT))
    proposer_index = get_beacon_proposer_index(state)
    for pk, participated in zip(committee_pubkeys, bits):
        idx = state.validators.find_pubkey(pk)
        if idx is None:
            continue
        if participated:
            increase_balance(state, idx, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, idx, participant_reward)


def compute_signing_root_bytes(root: bytes, domain: bytes) -> bytes:
    """Signing root where the object is already a 32-byte root."""
    from pos_evolution_tpu_torch.specs.helpers import SigningData
    return hash_tree_root(SigningData(object_root=root, domain=domain))


def process_execution_payload(state: BeaconState, body) -> None:
    """Simulated execution layer (pos-evolution.md:374, 644): record the
    payload header; consensus-only simulation performs no EL validation."""
    payload = body.execution_payload
    from pos_evolution_tpu_torch.specs.containers import ExecutionPayloadHeader
    tx_sedes = type(payload)._fields["transactions"]
    state.latest_execution_payload_header = ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=hash_tree_root(payload.transactions, tx_sedes),
    )
