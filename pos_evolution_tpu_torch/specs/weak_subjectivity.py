"""Weak subjectivity (cross-cutting layer LX; pos-evolution.md:1198-1317).

Long-range attacks rewrite history with old keys (pos-evolution.md:1200);
the mitigation is weak-subjectivity checkpoints that act as new genesis
(:1216): clients reject blocks conflicting with the checkpoint and must
sync from a checkpoint no older than the weak subjectivity period.
"""

from __future__ import annotations

from pos_evolution_tpu_torch.config import ETH_TO_GWEI, cfg
from pos_evolution_tpu_torch.specs.containers import BeaconState, Checkpoint
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    get_active_validator_indices,
    get_current_epoch,
    get_total_active_balance,
    get_validator_churn_limit,
)


def get_latest_weak_subjectivity_checkpoint_epoch(state: BeaconState,
                                                  safety_decay: float = 0.1) -> int:
    """Latest WS checkpoint epoch for ``state`` (pos-evolution.md:1225-1242)."""
    c = cfg()
    weak_subjectivity_mod = c.min_validator_withdrawability_delay
    val_count = len(get_active_validator_indices(state, get_current_epoch(state)))
    if val_count >= c.min_per_epoch_churn_limit * c.churn_limit_quotient:
        weak_subjectivity_mod += 256 * int((safety_decay * c.churn_limit_quotient / 2) // 256)
    else:
        weak_subjectivity_mod += 256 * int(
            (safety_decay * val_count / (2 * c.min_per_epoch_churn_limit)) // 256)
    finalized = int(state.finalized_checkpoint.epoch)
    return finalized - (finalized % weak_subjectivity_mod)


def compute_weak_subjectivity_period(state: BeaconState) -> int:
    """WS period from churn + top-up bounds (pos-evolution.md:1257-1288).

    E.g. 3,277 epochs (~2 weeks) at >=262,144 validators with D=10%
    (pos-evolution.md:1307-1313).
    """
    c = cfg()
    ws_period = c.min_validator_withdrawability_delay
    N = len(get_active_validator_indices(state, get_current_epoch(state)))
    t = get_total_active_balance(state) // N // ETH_TO_GWEI
    T = c.max_effective_balance // ETH_TO_GWEI
    delta = get_validator_churn_limit(state)
    Delta = c.max_deposits * c.slots_per_epoch
    D = c.safety_decay

    if T * (200 + 3 * D) < t * (200 + 12 * D):
        epochs_for_validator_set_churn = (
            N * (t * (200 + 12 * D) - T * (200 + 3 * D)) // (600 * delta * (2 * t + T)))
        epochs_for_balance_top_ups = N * (200 + 3 * D) // (600 * Delta)
        ws_period += max(epochs_for_validator_set_churn, epochs_for_balance_top_ups)
    else:
        ws_period += 3 * N * D * t // (200 * Delta * (T - t))
    return int(ws_period)


def is_within_weak_subjectivity_period(store, ws_state: BeaconState,
                                       ws_checkpoint: Checkpoint) -> bool:
    """Client-side sync check (pos-evolution.md:1293-1302)."""
    from pos_evolution_tpu_torch.specs.forkchoice import get_current_slot
    assert bytes(ws_state.latest_block_header.state_root) == bytes(ws_checkpoint.root)
    assert compute_epoch_at_slot(int(ws_state.slot)) == int(ws_checkpoint.epoch)
    ws_period = compute_weak_subjectivity_period(ws_state)
    ws_state_epoch = compute_epoch_at_slot(int(ws_state.slot))
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    return current_epoch <= ws_state_epoch + ws_period


def checkpoint_for_state(ws_state: BeaconState):
    """(state', checkpoint) pair satisfying the sync-gate contract for a
    raw anchor state — the client-side half of checkpoint sync. A state
    fresh off a transition has an EMPTY header state-root cache (it is
    filled by the next ``process_slot``, pos-evolution.md's state-root
    deferral); mimic that here (hash first, then fill) so the gate's
    ``header.state_root == checkpoint.root`` assert (:1295) holds."""
    from pos_evolution_tpu_torch.ssz import hash_tree_root
    if bytes(ws_state.latest_block_header.state_root) == b"\x00" * 32:
        root = hash_tree_root(ws_state)
        ws_state = ws_state.copy()
        ws_state.latest_block_header.state_root = root
    return ws_state, Checkpoint(
        epoch=compute_epoch_at_slot(int(ws_state.slot)),
        root=bytes(ws_state.latest_block_header.state_root))
