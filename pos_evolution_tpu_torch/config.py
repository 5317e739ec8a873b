"""Frozen protocol configuration: the port's own copy of
``pos_evolution_tpu/config.py`` (``Config``, the presets and the
participation-flag constants). The port imports nothing of the JAX
package, so the copy is kept here; a test holds it equal, field by field.
"""

from __future__ import annotations

import dataclasses

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0
ETH_TO_GWEI = 10**9

# Participation flag indices (Altair participation accounting).
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)  # source, target, head
WEIGHT_DENOMINATOR = 64
PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2


@dataclasses.dataclass(frozen=True)
class Config:
    """All protocol constants for one protocol instance (hashable, immutable)."""

    name: str = "mainnet"

    # --- time / slot structure ---
    seconds_per_slot: int = 12
    intervals_per_slot: int = 3
    slots_per_epoch: int = 32

    # --- committees ---
    max_committees_per_slot: int = 64
    target_committee_size: int = 128
    max_validators_per_committee: int = 2048
    shuffle_round_count: int = 90
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4

    # --- registry / balances ---
    validator_registry_limit: int = 2**40
    max_effective_balance: int = 32 * ETH_TO_GWEI
    effective_balance_increment: int = ETH_TO_GWEI
    ejection_balance: int = 16 * ETH_TO_GWEI
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5
    min_deposit_amount: int = ETH_TO_GWEI

    # --- state history vectors ---
    slots_per_historical_root: int = 8192
    epochs_per_historical_vector: int = 65536
    epochs_per_slashings_vector: int = 8192
    historical_roots_limit: int = 2**24

    # --- attestations ---
    min_attestation_inclusion_delay: int = 1

    # --- justification / finalization ---
    justification_bits_length: int = 4

    # --- fork choice ---
    safe_slots_to_update_justified: int = 8
    proposer_score_boost_percent: int = 25

    # --- rewards ---
    base_reward_factor: int = 64
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    inactivity_penalty_quotient: int = 2**24
    min_slashing_penalty_quotient: int = 64
    whistleblower_reward_quotient: int = 512
    proportional_slashing_multiplier: int = 2

    # --- deposits ---
    deposit_contract_tree_depth: int = 32
    max_deposits: int = 16

    # --- block body operation limits ---
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_voluntary_exits: int = 16

    # --- sync committee ---
    sync_committee_size: int = 512
    epochs_per_sync_committee_period: int = 256

    # --- validator lifecycle / churn ---
    min_validator_withdrawability_delay: int = 256
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_seed_lookahead_epochs: int = 4
    shard_committee_period: int = 256

    # --- weak subjectivity ---
    safety_decay: int = 10  # percent

    # --- eth1 ---
    epochs_per_eth1_voting_period: int = 64

    # --- merge transition ---
    terminal_total_difficulty: int = 2**20
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = 2**64 - 1

    # --- data availability sampling ---
    das_cell_bytes: int = 64
    das_cells_per_blob: int = 16
    das_max_blobs_per_block: int = 2
    das_samples_per_client: int = 8

    # --- KZG cell commitments ---
    kzg_setup_seed: int = 0

    # --- device merkleization ---
    merkle_device_min_pairs: int = 4096

    # --- protocol-variant knobs ---
    vote_expiry_slots: int = 2**62
    phases_per_slot: int = 3
    confirmation_depth: int = 4

    @property
    def max_random_byte(self) -> int:
        return 2**8 - 1

    def slot_at_epoch(self, epoch: int) -> int:
        return epoch * self.slots_per_epoch

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def mainnet_config() -> Config:
    return Config()


def minimal_config() -> Config:
    """Small preset for fast unit tests (analogous to pyspec 'minimal')."""
    return Config(
        name="minimal",
        slots_per_epoch=8,
        max_committees_per_slot=4,
        target_committee_size=4,
        shuffle_round_count=10,
        slots_per_historical_root=64,
        epochs_per_historical_vector=64,
        epochs_per_slashings_vector=64,
        sync_committee_size=32,
        epochs_per_sync_committee_period=8,
        min_validator_withdrawability_delay=32,
        safe_slots_to_update_justified=2,
        epochs_per_eth1_voting_period=4,
        inactivity_penalty_quotient=2**24,
        das_cells_per_blob=8,
        das_samples_per_client=4,
    )
