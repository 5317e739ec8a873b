"""Frozen protocol configuration.

The reference spec is parameterized by named constants used throughout
(`pos-evolution.md:465-467,521,1021-1022,1054,126-128,587,1272,1355,1585,1589`).
We gather every knob into one frozen, hashable dataclass so it can be threaded
statically into jitted functions, with a mainnet-like preset and a small
"minimal" preset for fast tests (mirroring the pyspec mainnet/minimal split).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

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

# BLS signature domains (4-byte little-endian tags).
DOMAIN_BEACON_PROPOSER = b"\x00\x00\x00\x00"
DOMAIN_BEACON_ATTESTER = b"\x01\x00\x00\x00"
DOMAIN_RANDAO = b"\x02\x00\x00\x00"
DOMAIN_DEPOSIT = b"\x03\x00\x00\x00"
DOMAIN_VOLUNTARY_EXIT = b"\x04\x00\x00\x00"
DOMAIN_SYNC_COMMITTEE = b"\x07\x00\x00\x00"


@dataclasses.dataclass(frozen=True)
class Config:
    """All protocol constants for one simulation/protocol instance.

    Hashable and immutable so it can be a static argument to ``jax.jit``.
    """

    name: str = "mainnet"

    # --- time / slot structure (pos-evolution.md:191-199, 1536) ---
    seconds_per_slot: int = 12
    intervals_per_slot: int = 3  # 3Δ slot: propose / attest / aggregate
    slots_per_epoch: int = 32

    # --- committees (pos-evolution.md:461-475) ---
    max_committees_per_slot: int = 64
    target_committee_size: int = 128
    max_validators_per_committee: int = 2048
    shuffle_round_count: int = 90  # pos-evolution.md:521
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4

    # --- registry / balances (pos-evolution.md:110-134) ---
    validator_registry_limit: int = 2**40
    max_effective_balance: int = 32 * ETH_TO_GWEI
    effective_balance_increment: int = ETH_TO_GWEI
    ejection_balance: int = 16 * ETH_TO_GWEI
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5
    min_deposit_amount: int = ETH_TO_GWEI

    # --- state history vectors (pos-evolution.md:346-357) ---
    slots_per_historical_root: int = 8192
    epochs_per_historical_vector: int = 65536
    epochs_per_slashings_vector: int = 8192
    historical_roots_limit: int = 2**24

    # --- attestations (pos-evolution.md:722-758) ---
    min_attestation_inclusion_delay: int = 1

    # --- justification / finalization (pos-evolution.md:817-852) ---
    justification_bits_length: int = 4

    # --- fork choice (pos-evolution.md:1021-1024, 1054, 1355) ---
    safe_slots_to_update_justified: int = 8
    # Boost as a percentage of one slot's committee weight. The reference
    # mainline uses W/4 (pos-evolution.md:1355); its attack analyses use
    # 0.7W and 0.8W (:1385, :1525), so this is a percent knob.
    proposer_score_boost_percent: int = 25

    # --- rewards ---
    base_reward_factor: int = 64
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    inactivity_penalty_quotient: int = 2**24
    min_slashing_penalty_quotient: int = 64
    whistleblower_reward_quotient: int = 512
    proportional_slashing_multiplier: int = 2

    # --- deposits (pos-evolution.md:105-107, 139-175) ---
    deposit_contract_tree_depth: int = 32
    max_deposits: int = 16

    # --- block body operation limits (pos-evolution.md:632-644) ---
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_voluntary_exits: int = 16

    # --- sync committee (pos-evolution.md:542, 564-589) ---
    sync_committee_size: int = 512
    epochs_per_sync_committee_period: int = 256

    # --- validator lifecycle / churn ---
    min_validator_withdrawability_delay: int = 256
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_seed_lookahead_epochs: int = 4
    shard_committee_period: int = 256

    # --- weak subjectivity (pos-evolution.md:1225-1302) ---
    safety_decay: int = 10  # percent

    # --- eth1 ---
    epochs_per_eth1_voting_period: int = 64

    # --- merge transition (pos-evolution.md:1011-1013) ---
    # The simulator's PoW chain is tiny, so the default threshold is small;
    # mainnet's 5.875e22 would just be this knob set higher.
    terminal_total_difficulty: int = 2**20
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = 2**64 - 1

    # --- data availability sampling (das/, DESIGN.md §15) ---
    # One blob = ``das_cells_per_blob`` data cells of ``das_cell_bytes``
    # bytes; Reed-Solomon extension doubles it to a 2k-cell grid, any k of
    # which reconstruct the blob. 2k must stay <= 256 (GF(2^8) evaluation
    # points) and power-of-two (the commitment tree is a padded binary
    # merkle tree over the extended grid).
    das_cell_bytes: int = 64
    das_cells_per_blob: int = 16
    das_max_blobs_per_block: int = 2
    das_samples_per_client: int = 8

    # --- KZG cell commitments (kzg/, DESIGN.md §23) ---
    # Seed of the deterministic (insecure-by-design) powers-of-tau
    # setup: every node and every resumed checkpoint must regenerate
    # the identical SRS from config alone, so tau derives from this
    # public value. The domain size is n_cells * cell_bytes/16.
    kzg_setup_seed: int = 0

    # --- device merkleization (ops/merkle_device.py, DESIGN.md §22) ---
    # Level sweeps with fewer sibling pairs than this stay on the host
    # SHA-256 path: below the crossover the fixed device-dispatch
    # overhead (transfer + launch) loses to the host kernel. Measured by
    # ``scripts/bench_merkle.py``; auto-dispatch additionally requires a
    # real accelerator (jax-on-CPU never wins against the native core).
    merkle_device_min_pairs: int = 4096

    # --- protocol-variant knobs (L7) ---
    # Vote expiry period η: ∞ (None→2**62) = LMD, 1 = Goldfish
    # (pos-evolution.md:1585).
    vote_expiry_slots: int = 2**62
    # Slot structure for propose-vote-merge protocols: 3 phases (3Δ) or
    # 4 phases (4Δ with fast confirmation, pos-evolution.md:1562,1617).
    phases_per_slot: int = 3
    # κ-deep (slow) confirmation rule depth (pos-evolution.md:1556).
    confirmation_depth: int = 4

    # ------------------------------------------------------------------
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


# --- active-config context ---------------------------------------------------
# The spec-level functions keep the reference signatures
# (e.g. ``state_transition(state, signed_block)``) and therefore read the
# active config from a context, exactly like pyspec modules read module
# constants. Jitted array-level kernels instead take the config explicitly
# as a static argument.

_local = threading.local()


def cfg() -> Config:
    c = getattr(_local, "cfg", None)
    if c is None:
        c = mainnet_config()
        _local.cfg = c
    return c


def set_config(c: Config) -> None:
    _local.cfg = c


@contextmanager
def use_config(c: Config):
    prev = getattr(_local, "cfg", None)
    _local.cfg = c
    try:
        yield c
    finally:
        _local.cfg = prev
