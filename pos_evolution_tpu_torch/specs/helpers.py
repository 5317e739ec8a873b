"""Spec helper functions (L2/L3 support; SURVEY.md §2.3, §2.6).

All ~35 helpers the reference calls but does not inline
(pos-evolution.md:412-424, 467, 485, 729-749, 798-811, 832-836, 953-976,
1005-1058, 1104-1116, 1234, 1267-1270), plus the committee/randomness/
proposer machinery it does inline (:461-624). Registry-wide predicates are
vectorized over the dense columns; the full shuffle permutation is computed
once per (seed, count) through the ExecutionBackend and memoized.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from pos_evolution_tpu_torch.backend import get_backend
from pos_evolution_tpu_torch.config import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_SYNC_COMMITTEE,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PROPOSER_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    cfg,
)
from pos_evolution_tpu_torch.crypto.bls import bls
from pos_evolution_tpu_torch.specs.containers import (
    Attestation,
    AttestationData,
    BeaconState,
    DepositData,
    IndexedAttestation,
    Validator,
)
from pos_evolution_tpu_torch.ssz import hash_eth2, hash_tree_root
from pos_evolution_tpu_torch.ssz.core import Container, Bytes4, Bytes32, uint64


# --- math / time -------------------------------------------------------------

def integer_squareroot(n: int) -> int:
    import math
    return math.isqrt(int(n))


def compute_epoch_at_slot(slot: int) -> int:
    return int(slot) // cfg().slots_per_epoch


def compute_start_slot_at_epoch(epoch: int) -> int:
    return int(epoch) * cfg().slots_per_epoch


def compute_activation_exit_epoch(epoch: int) -> int:
    return int(epoch) + 1 + cfg().max_seed_lookahead


def get_current_epoch(state: BeaconState) -> int:
    return compute_epoch_at_slot(state.slot)


def get_previous_epoch(state: BeaconState) -> int:
    current = get_current_epoch(state)
    return GENESIS_EPOCH if current == GENESIS_EPOCH else current - 1


def uint_to_bytes(value: int, length: int = 8) -> bytes:
    return int(value).to_bytes(length, "little")


def bytes_to_uint64(data: bytes) -> int:
    return int.from_bytes(data, "little")


# --- validator predicates (vectorized over the dense registry) ---------------

def is_active_validator(validator: Validator, epoch: int) -> bool:
    """pos-evolution.md:467 contract: activation <= epoch < exit."""
    return validator.activation_epoch <= epoch < validator.exit_epoch


def active_validator_mask(state: BeaconState, epoch: int) -> np.ndarray:
    reg = state.validators
    e = np.uint64(epoch)
    return (reg.activation_epoch <= e) & (e < reg.exit_epoch)


def get_active_validator_indices(state: BeaconState, epoch: int) -> np.ndarray:
    """Referenced at pos-evolution.md:467, 1234, 1267."""
    return np.nonzero(active_validator_mask(state, epoch))[0]


def get_validator_churn_limit(state: BeaconState) -> int:
    """pos-evolution.md:1270."""
    c = cfg()
    active = int(active_validator_mask(state, get_current_epoch(state)).sum())
    return max(c.min_per_epoch_churn_limit, active // c.churn_limit_quotient)


def is_slashable_validator(validator: Validator, epoch: int) -> bool:
    return (not validator.slashed) and (
        validator.activation_epoch <= epoch < validator.withdrawable_epoch)


def is_slashable_attestation_data(data_1: AttestationData, data_2: AttestationData) -> bool:
    """Double vote or surround vote (pos-evolution.md:1134-1143)."""
    double = data_1 != data_2 and data_1.target.epoch == data_2.target.epoch
    surround = (data_1.source.epoch < data_2.source.epoch
                and data_2.target.epoch < data_1.target.epoch)
    return double or surround


# --- domains / signing roots --------------------------------------------------

class ForkData(Container):
    current_version: Bytes4
    genesis_validators_root: Bytes32


class SigningData(Container):
    object_root: Bytes32
    domain: Bytes32


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return hash_tree_root(ForkData(current_version=current_version,
                                   genesis_validators_root=genesis_validators_root))


def compute_domain(domain_type: bytes, fork_version: bytes | None = None,
                   genesis_validators_root: bytes | None = None) -> bytes:
    """pos-evolution.md:162."""
    if fork_version is None:
        fork_version = b"\x00" * 4
    if genesis_validators_root is None:
        genesis_validators_root = b"\x00" * 32
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return bytes(domain_type) + fork_data_root[:28]


def get_domain(state: BeaconState, domain_type: bytes, epoch: int | None = None) -> bytes:
    if epoch is None:
        epoch = get_current_epoch(state)
    fork_version = (state.fork.previous_version if epoch < state.fork.epoch
                    else state.fork.current_version)
    return compute_domain(domain_type, fork_version, state.genesis_validators_root)


def compute_signing_root(ssz_object, domain: bytes, sedes=None) -> bytes:
    """pos-evolution.md:163."""
    return hash_tree_root(SigningData(object_root=hash_tree_root(ssz_object, sedes),
                                      domain=domain))


# --- history accessors --------------------------------------------------------

def get_block_root_at_slot(state: BeaconState, slot: int) -> bytes:
    assert slot < state.slot <= slot + state.block_roots.shape[0]
    return state.block_roots[slot % state.block_roots.shape[0]].tobytes()


def get_block_root(state: BeaconState, epoch: int) -> bytes:
    """EBB root for ``epoch`` (pos-evolution.md:832, 836)."""
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch))


def get_randao_mix(state: BeaconState, epoch: int) -> bytes:
    """pos-evolution.md:485."""
    return state.randao_mixes[epoch % state.randao_mixes.shape[0]].tobytes()


# --- balances ----------------------------------------------------------------

def increase_balance(state: BeaconState, index: int, delta: int) -> None:
    """pos-evolution.md:174, 754."""
    state.balances[index] += np.uint64(delta)


def decrease_balance(state: BeaconState, index: int, delta: int) -> None:
    bal = int(state.balances[index])
    state.balances[index] = np.uint64(max(bal - int(delta), 0))


def get_total_balance(state: BeaconState, indices) -> int:
    """Sum of effective balances over ``indices``; floored at one increment
    (pos-evolution.md:807-811)."""
    idx = np.asarray(list(indices) if not isinstance(indices, np.ndarray) else indices,
                     dtype=np.int64)
    total = int(state.validators.effective_balance[idx].sum()) if idx.size else 0
    return max(cfg().effective_balance_increment, total)


def get_total_active_balance(state: BeaconState) -> int:
    mask = active_validator_mask(state, get_current_epoch(state))
    total = int(state.validators.effective_balance[mask].sum())
    return max(cfg().effective_balance_increment, total)


# --- participation flags ------------------------------------------------------

def has_flag(flags: int, flag_index: int) -> bool:
    return bool((int(flags) >> flag_index) & 1)


def add_flag(flags: int, flag_index: int) -> int:
    return int(flags) | (1 << flag_index)


def get_unslashed_participating_indices(state: BeaconState, flag_index: int,
                                        epoch: int) -> np.ndarray:
    """pos-evolution.md:798-799 — vectorized flag/slash/activity mask."""
    assert epoch in (get_previous_epoch(state), get_current_epoch(state))
    participation = (state.current_epoch_participation
                     if epoch == get_current_epoch(state)
                     else state.previous_epoch_participation)
    mask = (active_validator_mask(state, epoch)
            & (((participation >> np.uint8(flag_index)) & np.uint8(1)).astype(bool))
            & ~state.validators.slashed)
    return np.nonzero(mask)[0]


def get_base_reward_per_increment(state: BeaconState) -> int:
    c = cfg()
    return (c.effective_balance_increment * c.base_reward_factor
            // integer_squareroot(get_total_active_balance(state)))


def get_base_reward(state: BeaconState, index: int) -> int:
    """pos-evolution.md:749."""
    c = cfg()
    increments = int(state.validators.effective_balance[index]) // c.effective_balance_increment
    return increments * get_base_reward_per_increment(state)


def get_finality_delay(state: BeaconState) -> int:
    return get_previous_epoch(state) - int(state.finalized_checkpoint.epoch)


def is_in_inactivity_leak(state: BeaconState) -> bool:
    return get_finality_delay(state) > 4  # MIN_EPOCHS_TO_INACTIVITY_PENALTY


# --- committees (L3) ----------------------------------------------------------

def get_committee_count_per_slot(state: BeaconState, epoch: int) -> int:
    """pos-evolution.md:461-469."""
    c = cfg()
    active = int(active_validator_mask(state, epoch).sum())
    return max(1, min(c.max_committees_per_slot,
                      active // c.slots_per_epoch // c.target_committee_size))


def get_seed(state: BeaconState, epoch: int, domain_type: bytes) -> bytes:
    """pos-evolution.md:481-487."""
    c = cfg()
    mix = get_randao_mix(
        state, epoch + c.epochs_per_historical_vector - c.min_seed_lookahead - 1)
    return hash_eth2(bytes(domain_type) + uint_to_bytes(epoch) + mix)


def compute_shuffled_index(index: int, index_count: int, seed: bytes) -> int:
    """Scalar swap-or-not shuffle (pos-evolution.md:513-535).

    Kept for spec fidelity and as the oracle for the vectorized backend
    permutation; hot paths use ``get_shuffled_permutation``.
    """
    assert index < index_count
    rounds = cfg().shuffle_round_count
    for r in range(rounds):
        pivot = bytes_to_uint64(hash_eth2(seed + bytes([r]))[:8]) % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = hash_eth2(seed + bytes([r]) + uint_to_bytes(position // 256, 4))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) % 2:
            index = flip
    return index


@lru_cache(maxsize=128)
def _cached_permutation(backend_name: str, seed: bytes, index_count: int,
                        rounds: int) -> np.ndarray:
    perm = np.asarray(get_backend().shuffle_permutation(seed, index_count, rounds))
    perm.setflags(write=False)
    return perm


def get_shuffled_permutation(seed: bytes, index_count: int) -> np.ndarray:
    """p[i] = compute_shuffled_index(i, index_count, seed), via the backend."""
    return _cached_permutation(get_backend().name, bytes(seed), int(index_count),
                               cfg().shuffle_round_count)


def compute_committee(indices: np.ndarray, seed: bytes, index: int, count: int) -> np.ndarray:
    """pos-evolution.md:495-506, on the cached full permutation."""
    n = len(indices)
    start = (n * index) // count
    end = (n * (index + 1)) // count
    perm = get_shuffled_permutation(seed, n)
    return np.asarray(indices)[perm[start:end].astype(np.int64)]


def get_beacon_committee(state: BeaconState, slot: int, index: int) -> np.ndarray:
    """pos-evolution.md:729."""
    epoch = compute_epoch_at_slot(slot)
    committees_per_slot = get_committee_count_per_slot(state, epoch)
    return compute_committee(
        indices=get_active_validator_indices(state, epoch),
        seed=get_seed(state, epoch, DOMAIN_BEACON_ATTESTER),
        index=(slot % cfg().slots_per_epoch) * committees_per_slot + index,
        count=committees_per_slot * cfg().slots_per_epoch,
    )


def compute_proposer_index(state: BeaconState, indices: np.ndarray, seed: bytes) -> int:
    """Effective-balance-weighted rejection sampling (pos-evolution.md:604-619)."""
    assert len(indices) > 0
    c = cfg()
    total = len(indices)
    perm = get_shuffled_permutation(seed, total)
    i = 0
    while True:
        candidate_index = int(np.asarray(indices)[perm[i % total]])
        random_byte = hash_eth2(seed + uint_to_bytes(i // 32))[i % 32]
        effective_balance = int(state.validators.effective_balance[candidate_index])
        if effective_balance * c.max_random_byte >= c.max_effective_balance * random_byte:
            return candidate_index
        i += 1


def get_beacon_proposer_index(state: BeaconState) -> int:
    """Proposer for the current slot (pos-evolution.md:597, 604)."""
    epoch = get_current_epoch(state)
    seed = hash_eth2(get_seed(state, epoch, DOMAIN_BEACON_PROPOSER)
                     + uint_to_bytes(int(state.slot)))
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed)


# --- sync committee (pos-evolution.md:542, 564-589) ---------------------------

def compute_sync_committee_period(epoch: int) -> int:
    return int(epoch) // cfg().epochs_per_sync_committee_period


def get_next_sync_committee_indices(state: BeaconState) -> list[int]:
    """Balance-weighted sampling of the next 512-validator sync committee."""
    c = cfg()
    epoch = get_current_epoch(state) + 1
    indices = get_active_validator_indices(state, epoch)
    total = len(indices)
    assert total > 0
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE)
    perm = get_shuffled_permutation(seed, total)
    out: list[int] = []
    i = 0
    while len(out) < c.sync_committee_size:
        candidate_index = int(indices[perm[i % total]])
        random_byte = hash_eth2(seed + uint_to_bytes(i // 32))[i % 32]
        effective_balance = int(state.validators.effective_balance[candidate_index])
        if effective_balance * c.max_random_byte >= c.max_effective_balance * random_byte:
            out.append(candidate_index)
        i += 1
    return out


def get_next_sync_committee(state: BeaconState):
    from pos_evolution_tpu_torch.specs.containers import SyncCommittee
    indices = get_next_sync_committee_indices(state)
    pubkeys = [state.validators.pubkeys[i].tobytes() for i in indices]
    return SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=bls.AggregatePKs(pubkeys))


def is_assigned_to_sync_committee(state: BeaconState, epoch: int,
                                  validator_index: int) -> bool:
    """pos-evolution.md:564-578."""
    sync_committee_period = compute_sync_committee_period(epoch)
    current_period = compute_sync_committee_period(get_current_epoch(state))
    assert sync_committee_period in (current_period, current_period + 1)
    pubkey = state.validators.pubkeys[validator_index].tobytes()
    committee = (state.current_sync_committee if sync_committee_period == current_period
                 else state.next_sync_committee)
    return pubkey in [bytes(pk) for pk in committee.pubkeys]


# --- attestation machinery ----------------------------------------------------

def get_attesting_indices(state: BeaconState, data: AttestationData,
                          bits: np.ndarray) -> np.ndarray:
    """pos-evolution.md:745."""
    committee = get_beacon_committee(state, int(data.slot), int(data.index))
    bits = np.asarray(bits, dtype=bool)
    assert bits.shape[0] == committee.shape[0]
    return np.unique(committee[bits])


def get_indexed_attestation(state: BeaconState, attestation: Attestation) -> IndexedAttestation:
    """pos-evolution.md:736, 975."""
    attesting = get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    return IndexedAttestation(
        attesting_indices=np.sort(attesting).astype(np.uint64),
        data=attestation.data,
        signature=attestation.signature,
    )


def is_valid_indexed_attestation(state: BeaconState, indexed: IndexedAttestation) -> bool:
    """pos-evolution.md:736, 976, 1456-1457: sorted non-empty indices and a
    valid aggregate signature over the attestation data."""
    indices = np.asarray(indexed.attesting_indices, dtype=np.int64)
    if indices.size == 0 or not np.all(indices[:-1] < indices[1:]):
        return False
    pubkeys = [state.validators.pubkeys[i].tobytes() for i in indices]
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, int(indexed.data.target.epoch))
    signing_root = compute_signing_root(indexed.data, domain)
    return bls.FastAggregateVerify(pubkeys, signing_root, indexed.signature)


def get_attestation_participation_flag_indices(state: BeaconState, data: AttestationData,
                                               inclusion_delay: int) -> list[int]:
    """Altair participation flags (pos-evolution.md:733)."""
    c = cfg()
    if data.target.epoch == get_current_epoch(state):
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    is_matching_target = is_matching_source and bytes(data.target.root) == get_block_root(
        state, int(data.target.epoch))
    is_matching_head = is_matching_target and bytes(data.beacon_block_root) == \
        get_block_root_at_slot(state, int(data.slot))
    assert is_matching_source

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(c.slots_per_epoch):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= c.slots_per_epoch:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == c.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


# --- validator lifecycle ------------------------------------------------------

def initiate_validator_exit(state: BeaconState, index: int) -> None:
    """Queue an exit, respecting the per-epoch churn limit."""
    c = cfg()
    reg = state.validators
    if reg.exit_epoch[index] != np.uint64(FAR_FUTURE_EPOCH):
        return
    exiting = reg.exit_epoch[reg.exit_epoch != np.uint64(FAR_FUTURE_EPOCH)]
    exit_queue_epoch = max(
        int(exiting.max()) if exiting.size else 0,
        compute_activation_exit_epoch(get_current_epoch(state)),
    )
    exit_queue_churn = int((exiting == np.uint64(exit_queue_epoch)).sum())
    if exit_queue_churn >= get_validator_churn_limit(state):
        exit_queue_epoch += 1
    reg.exit_epoch[index] = exit_queue_epoch
    reg.withdrawable_epoch[index] = exit_queue_epoch + c.min_validator_withdrawability_delay


def slash_validator(state: BeaconState, slashed_index: int,
                    whistleblower_index: int | None = None) -> None:
    """Slash + penalize + reward whistleblower/proposer."""
    c = cfg()
    epoch = get_current_epoch(state)
    initiate_validator_exit(state, slashed_index)
    reg = state.validators
    reg.slashed[slashed_index] = True
    reg.withdrawable_epoch[slashed_index] = max(
        int(reg.withdrawable_epoch[slashed_index]),
        epoch + c.epochs_per_slashings_vector)
    eff = int(reg.effective_balance[slashed_index])
    state.slashings[epoch % state.slashings.shape[0]] += np.uint64(eff)
    decrease_balance(state, slashed_index, eff // c.min_slashing_penalty_quotient)

    proposer_index = get_beacon_proposer_index(state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = eff // c.whistleblower_reward_quotient
    proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)


def get_validator_from_deposit(state: BeaconState, deposit_data: DepositData) -> Validator:
    """pos-evolution.md:166."""
    c = cfg()
    amount = int(deposit_data.amount)
    effective = min(amount - amount % c.effective_balance_increment, c.max_effective_balance)
    return Validator(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        effective_balance=effective,
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )
