"""Server-side proof construction: merkle branches into a ``BeaconState``.

A full node proving facts to light clients builds branches over the same
field-root chunks ``Container.htr`` hashes (``Container.field_roots``), so a
proof is correct by construction against ``hash_tree_root(state)``. All
branch hashing runs through the batched SHA-256 in ``ssz/merkle`` — building
every per-slot proof is a handful of 32-leaf sweeps, not a tree walk.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.lightclient.containers import (
    CURRENT_SYNC_COMMITTEE_INDEX,
    FINALIZED_ROOT_DEPTH,
    FINALIZED_ROOT_INDEX,
    NEXT_SYNC_COMMITTEE_INDEX,
    STATE_TREE_DEPTH,
)
from pos_evolution_tpu_torch.specs.containers import BeaconBlock, BeaconBlockHeader, BeaconState
from pos_evolution_tpu_torch.ssz import hash_tree_root
from pos_evolution_tpu_torch.ssz.core import uint64
from pos_evolution_tpu_torch.ssz.merkle import merkle_tree_branch

__all__ = [
    "state_field_roots",
    "state_field_branch",
    "finality_branch",
    "current_sync_committee_branch",
    "next_sync_committee_branch",
    "header_for_block",
    "branch_array",
]


def state_field_roots(state: BeaconState) -> np.ndarray:
    """(n_fields, 32) chunk roots of the state's field tree."""
    return BeaconState.field_roots(state)


def branch_array(branch: list[bytes]) -> np.ndarray:
    """List of 32-byte siblings -> (depth, 32) uint8 rows (container form)."""
    return np.frombuffer(b"".join(branch), dtype=np.uint8).reshape(-1, 32).copy()


def state_field_branch(chunks: np.ndarray, field_index: int) -> np.ndarray:
    """Depth-``STATE_TREE_DEPTH`` branch for one state field leaf."""
    return branch_array(merkle_tree_branch(chunks, field_index, STATE_TREE_DEPTH))


def finality_branch(state: BeaconState, chunks: np.ndarray | None = None) -> np.ndarray:
    """Branch proving ``state.finalized_checkpoint.root``.

    Level 0 is inside the Checkpoint container (sibling = the epoch chunk);
    the remaining levels walk the state field tree from field
    ``finalized_checkpoint``. Verifies at depth ``FINALIZED_ROOT_DEPTH``,
    index ``FINALIZED_ROOT_INDEX`` against ``hash_tree_root(state)``.
    """
    if chunks is None:
        chunks = state_field_roots(state)
    epoch_chunk = uint64.htr(state.finalized_checkpoint.epoch)
    upper = merkle_tree_branch(chunks, FINALIZED_ROOT_INDEX >> 1, STATE_TREE_DEPTH)
    return branch_array([epoch_chunk] + upper)


def current_sync_committee_branch(state: BeaconState,
                                  chunks: np.ndarray | None = None) -> np.ndarray:
    if chunks is None:
        chunks = state_field_roots(state)
    return state_field_branch(chunks, CURRENT_SYNC_COMMITTEE_INDEX)


def next_sync_committee_branch(state: BeaconState,
                               chunks: np.ndarray | None = None) -> np.ndarray:
    if chunks is None:
        chunks = state_field_roots(state)
    return state_field_branch(chunks, NEXT_SYNC_COMMITTEE_INDEX)


def header_for_block(block: BeaconBlock) -> BeaconBlockHeader:
    """Header whose hash_tree_root equals the block root (body collapsed to
    its root; state_root as recorded in the block)."""
    return BeaconBlockHeader(
        slot=int(block.slot),
        proposer_index=int(block.proposer_index),
        parent_root=bytes(block.parent_root),
        state_root=bytes(block.state_root),
        body_root=hash_tree_root(block.body),
    )
