"""Full-node side of the sync protocol: derive bootstraps and updates.

A full node (here: a simulation view group's fork-choice store plus the
block archive) serves light clients by packaging what the chain already
contains — the sync aggregate a block carried, its attested (parent) header,
and merkle proofs built from the attested post-state's field roots
(lightclient/proofs.py). Bootstraps come from the node's finalized
checkpoint and pass the weak-subjectivity gate before being served
(specs/weak_subjectivity.checkpoint_for_state).
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.lightclient.containers import (
    LightClientBootstrap,
    LightClientHeader,
    LightClientUpdate,
)
from pos_evolution_tpu_torch.lightclient.proofs import (
    current_sync_committee_branch,
    finality_branch,
    header_for_block,
    next_sync_committee_branch,
    state_field_roots,
)
from pos_evolution_tpu_torch.lightclient.spec import sync_period_at_slot
from pos_evolution_tpu_torch.ssz import hash_tree_root

__all__ = ["make_bootstrap", "bootstrap_from_store", "build_update",
           "build_head_update"]


def make_bootstrap(state, block) -> tuple[bytes, LightClientBootstrap]:
    """(trusted_block_root, bootstrap) for a checkpoint ``block`` whose
    post-state is ``state``."""
    header = header_for_block(block)
    bootstrap = LightClientBootstrap(
        header=LightClientHeader(beacon=header),
        current_sync_committee=state.current_sync_committee.copy(),
        current_sync_committee_branch=current_sync_committee_branch(state),
    )
    return hash_tree_root(header), bootstrap


def bootstrap_from_store(store) -> tuple[bytes, LightClientBootstrap]:
    """Bootstrap from the node's finalized checkpoint — the same anchor a
    crash-restarted full node would sync from — after checking it is still
    within the weak-subjectivity period (pos-evolution.md:1293-1302)."""
    from pos_evolution_tpu_torch.specs.weak_subjectivity import (
        checkpoint_for_state,
        is_within_weak_subjectivity_period,
    )
    froot = bytes(store.finalized_checkpoint.root)
    state = store.block_states[froot]
    block = store.blocks[froot]
    ws_state, ws_checkpoint = checkpoint_for_state(state)
    assert is_within_weak_subjectivity_period(store, ws_state, ws_checkpoint), (
        "finalized checkpoint outside the weak-subjectivity period — a light "
        "client syncing from it would be vulnerable to long-range forks")
    return make_bootstrap(state, block)


def _lookup_block(store, archive, root: bytes):
    block = store.blocks.get(root)
    if block is not None:
        return block
    if archive is not None:
        signed = archive.get(root)
        if signed is not None:
            return signed.message
    return None


def _update_for(attested_block, attested_state, aggregate, signature_slot: int,
                store, archive: dict | None) -> LightClientUpdate:
    """Assemble an update around one (attested block, sync aggregate) pair.

    Proofs come from the attested block's post-state. The
    next-sync-committee proof is only attached when the attested slot and
    the signature slot share a sync-committee period (otherwise the proof
    would be for the wrong period's committee).
    """
    chunks = state_field_roots(attested_state)
    update = LightClientUpdate(
        attested_header=LightClientHeader(beacon=header_for_block(attested_block)),
        sync_aggregate=aggregate.copy(),
        signature_slot=int(signature_slot),
    )
    finalized_root = bytes(attested_state.finalized_checkpoint.root)
    finalized_block = _lookup_block(store, archive, finalized_root)
    if finalized_block is not None:
        update.finalized_header = LightClientHeader(
            beacon=header_for_block(finalized_block))
        update.finality_branch = finality_branch(attested_state, chunks)
    if (sync_period_at_slot(int(attested_block.slot))
            == sync_period_at_slot(int(signature_slot))):
        update.next_sync_committee = attested_state.next_sync_committee.copy()
        update.next_sync_committee_branch = next_sync_committee_branch(
            attested_state, chunks)
    return update


def build_update(store, head_root: bytes,
                 archive: dict | None = None) -> LightClientUpdate | None:
    """Best update derivable from the head block, or None.

    The head block's sync aggregate attests to its parent, so this is the
    on-chain serving path (one update per included block).
    """
    block = store.blocks.get(bytes(head_root))
    if block is None or int(block.slot) == 0:
        return None
    aggregate = block.body.sync_aggregate
    if not np.asarray(aggregate.sync_committee_bits, dtype=bool).any():
        return None
    parent_root = bytes(block.parent_root)
    attested_block = _lookup_block(store, archive, parent_root)
    attested_state = store.block_states.get(parent_root)
    if attested_block is None or attested_state is None:
        return None
    return _update_for(attested_block, attested_state, aggregate,
                       int(block.slot), store, archive)


def build_head_update(store, head_root: bytes, aggregate, signature_slot: int,
                      archive: dict | None = None) -> LightClientUpdate | None:
    """Off-chain serving path: an update whose attested header is the head
    itself, signed by a sync aggregate that has not been packed into a
    block yet. Real light-client networks gossip exactly this
    (FinalityUpdates assembled from sync-committee messages), which is what
    lets a client reach the full node's *current* finalized head instead of
    trailing one inclusion round behind."""
    head_root = bytes(head_root)
    head_block = store.blocks.get(head_root)
    head_state = store.block_states.get(head_root)
    if head_block is None or head_state is None:
        return None
    if not np.asarray(aggregate.sync_committee_bits, dtype=bool).any():
        return None
    return _update_for(head_block, head_state, aggregate,
                       int(signature_slot), store, archive)
