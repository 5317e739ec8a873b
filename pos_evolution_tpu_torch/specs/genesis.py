"""Genesis state construction and deterministic test keypairs.

The reference's system model starts from a genesis block at slot 0
(pos-evolution.md:193) with a known validator set (:31). This module builds
a config-sized ``BeaconState`` + anchor ``BeaconBlock`` the way pyspec
genesis tooling does, with all history vectors sized from the active config.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.crypto.bls import bls
from pos_evolution_tpu_torch.specs.containers import (
    BeaconBlock,
    BeaconBlockBody,
    BeaconBlockHeader,
    BeaconState,
    Checkpoint,
    Eth1Data,
    Fork,
    SyncCommittee,
    ValidatorRegistry,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root


def validator_secret_key(index: int) -> int:
    return index + 1


def validator_pubkey(index: int) -> bytes:
    return bls.SkToPk(validator_secret_key(index))


def make_genesis_state(n_validators: int, genesis_time: int = 0) -> BeaconState:
    """Build a genesis BeaconState with ``n_validators`` active at epoch 0."""
    c = cfg()
    reg = ValidatorRegistry(n_validators)
    all_pks = np.zeros((n_validators, 48), dtype=np.uint8)
    for i in range(n_validators):
        all_pks[i] = np.frombuffer(validator_pubkey(i), dtype=np.uint8)
    reg.set_pubkeys(all_pks)
    wc = bytes([0x00]) + bytes(31)  # placeholder withdrawal credentials
    reg.withdrawal_credentials[:] = np.frombuffer(wc, dtype=np.uint8)
    reg.effective_balance[:] = c.max_effective_balance
    reg.activation_eligibility_epoch[:] = 0
    reg.activation_epoch[:] = 0

    state = BeaconState(
        genesis_time=genesis_time,
        slot=0,
        fork=Fork(previous_version=b"\x00" * 4, current_version=b"\x00" * 4, epoch=0),
        latest_block_header=BeaconBlockHeader(
            body_root=hash_tree_root(BeaconBlockBody())),
        block_roots=np.zeros((c.slots_per_historical_root, 32), dtype=np.uint8),
        state_roots=np.zeros((c.slots_per_historical_root, 32), dtype=np.uint8),
        historical_roots=np.zeros((0, 32), dtype=np.uint8),
        eth1_data=Eth1Data(deposit_count=n_validators),
        eth1_deposit_index=n_validators,
        validators=reg,
        balances=np.full(n_validators, c.max_effective_balance, dtype=np.uint64),
        randao_mixes=np.zeros((c.epochs_per_historical_vector, 32), dtype=np.uint8),
        slashings=np.zeros(c.epochs_per_slashings_vector, dtype=np.uint64),
        previous_epoch_participation=np.zeros(n_validators, dtype=np.uint8),
        current_epoch_participation=np.zeros(n_validators, dtype=np.uint8),
        justification_bits=np.zeros(c.justification_bits_length, dtype=bool),
        previous_justified_checkpoint=Checkpoint(),
        current_justified_checkpoint=Checkpoint(),
        finalized_checkpoint=Checkpoint(),
        inactivity_scores=np.zeros(n_validators, dtype=np.uint64),
    )
    state.genesis_validators_root = state.validators.__ssz_root__()

    # Seed the sync committees from the genesis registry (pos-evolution.md:542).
    if n_validators > 0:
        from pos_evolution_tpu_torch.specs.helpers import get_next_sync_committee
        committee = get_next_sync_committee(state)
        state.current_sync_committee = committee
        state.next_sync_committee = get_next_sync_committee(state)
    return state


def make_genesis(n_validators: int, genesis_time: int = 0):
    """Return (genesis_state, anchor_block) consistent for the fork-choice
    store init contract ``anchor_block.state_root == hash_tree_root(state)``
    (pos-evolution.md:1078)."""
    state = make_genesis_state(n_validators, genesis_time)
    anchor = BeaconBlock(
        slot=0,
        proposer_index=0,
        parent_root=b"\x00" * 32,
        state_root=hash_tree_root(state),
        body=BeaconBlockBody(),
    )
    return state, anchor
