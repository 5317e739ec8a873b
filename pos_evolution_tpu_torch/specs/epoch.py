"""Epoch processing (L2): the full-registry sweeps of SURVEY.md §2.2.

``process_epoch`` umbrella implied by the BeaconState fields
(pos-evolution.md:338-374; SURVEY.md §2.6): justification/finalization
(:793-852), inactivity scores (:369), rewards/penalties (participation
flags :361-362), registry updates (churn :1270), slashings vector (:359),
hysteresis effective-balance updates (:122-133), RANDAO rotation (:357),
participation rotation, sync-committee rotation (:542).

Every sweep is a vectorized pass over the dense registry columns — the
NumPy form of the pmapped/shard_map epoch pass (north-star config #4).
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    cfg,
)
from pos_evolution_tpu_torch.specs.containers import BeaconState, Checkpoint
from pos_evolution_tpu_torch.specs.helpers import (
    active_validator_mask,
    compute_activation_exit_epoch,
    get_block_root,
    get_current_epoch,
    get_base_reward_per_increment,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_next_sync_committee,
    initiate_validator_exit,
    is_in_inactivity_leak,
)
from pos_evolution_tpu_torch.ssz.merkle import merkleize_chunks


def process_epoch(state: BeaconState) -> None:
    from pos_evolution_tpu_torch.backend import get_backend
    if getattr(get_backend(), "accelerated_epoch", False):
        _process_epoch_accelerated(state)
        return
    process_justification_and_finalization(state)
    process_inactivity_updates(state)
    process_rewards_and_penalties(state)
    process_registry_updates(state)
    process_slashings(state)
    process_eth1_data_reset(state)
    process_effective_balance_updates(state)
    process_slashings_reset(state)
    process_randao_mixes_reset(state)
    process_historical_roots_update(state)
    process_participation_flag_updates(state)
    process_sync_committee_updates(state)


def _process_epoch_accelerated(state: BeaconState) -> None:
    """Epoch boundary via the fused device sweep (ops/epoch.py), with exact
    host write-back — bit-identical to the NumPy pipeline above.

    The device kernel covers the O(n) sweeps (justification tallies,
    inactivity, rewards, slashings penalties, hysteresis, flag rotation);
    the host keeps the O(changes) bookkeeping: checkpoint roots, registry
    churn (run against pre-hysteresis effective balances, preserving the
    reference ordering), and the per-epoch resets/rotations.
    """
    from pos_evolution_tpu_torch.backend import get_backend
    import numpy as np

    current_epoch = get_current_epoch(state)
    old_prev_justified = state.previous_justified_checkpoint
    old_cur_justified = state.current_justified_checkpoint

    # Stage the registry on device once; both the sweep and the churn
    # kernel read it (epoch columns and pre-hysteresis effective balances
    # are unchanged between the two).
    from pos_evolution_tpu_torch.ops.epoch import densify
    dense_pre = densify(state)
    out = get_backend().epoch_sweep(state, cfg(), dense=dense_pre)

    # --- justification / finalization bookkeeping (roots live host-side) ---
    if current_epoch > GENESIS_EPOCH + 1:
        state.previous_justified_checkpoint = state.current_justified_checkpoint
        if bool(out.justify_prev):
            state.current_justified_checkpoint = Checkpoint(
                epoch=get_previous_epoch(state),
                root=get_block_root(state, get_previous_epoch(state)))
        if bool(out.justify_cur):
            state.current_justified_checkpoint = Checkpoint(
                epoch=current_epoch, root=get_block_root(state, current_epoch))
        state.justification_bits = np.array(out.new_justification_bits)
        fin = int(out.finalize_epoch)
        if fin >= 0:
            # later finalization cases (which win in the spec) use the old
            # *current* justified checkpoint — check it first
            if fin == int(old_cur_justified.epoch):
                state.finalized_checkpoint = old_cur_justified
            elif fin == int(old_prev_justified.epoch):
                state.finalized_checkpoint = old_prev_justified

    # --- write back sweeps; effective balances AFTER churn (spec order) ---
    reg = out.registry
    state.balances = np.array(reg.balance).astype(np.uint64)
    state.inactivity_scores = np.array(reg.inactivity_scores).astype(np.uint64)
    new_eff = np.array(reg.effective_balance).astype(np.uint64)

    # Registry churn on device too (reads pre-hysteresis effective balances
    # and the *post-sweep* finalized checkpoint, matching the spec order).
    from pos_evolution_tpu_torch.ops.epoch import (
        densify_eligibility, i64_to_epochs, registry_churn_dense,
    )
    churn = registry_churn_dense(
        dense_pre, densify_eligibility(state), current_epoch,
        int(state.finalized_checkpoint.epoch), cfg())

    v = state.validators
    v.activation_eligibility_epoch = i64_to_epochs(churn.activation_eligibility_epoch)
    v.activation_epoch = i64_to_epochs(churn.activation_epoch)
    v.exit_epoch = i64_to_epochs(churn.exit_epoch)
    v.withdrawable_epoch = i64_to_epochs(churn.withdrawable_epoch)
    process_eth1_data_reset(state)
    state.validators.effective_balance = new_eff
    state.previous_epoch_participation = np.array(reg.prev_flags)
    state.current_epoch_participation = np.array(reg.cur_flags)

    process_slashings_reset(state)
    process_randao_mixes_reset(state)
    process_historical_roots_update(state)
    process_sync_committee_updates(state)


# --- justification & finalization (pos-evolution.md:793-852) ------------------

def _unslashed_target_balance(state: BeaconState, epoch: int) -> int:
    """Total effective balance of unslashed TIMELY_TARGET participants."""
    participation = (state.current_epoch_participation
                     if epoch == get_current_epoch(state)
                     else state.previous_epoch_participation)
    mask = (active_validator_mask(state, epoch)
            & (((participation >> np.uint8(TIMELY_TARGET_FLAG_INDEX)) & np.uint8(1)).astype(bool))
            & ~state.validators.slashed)
    total = int(state.validators.effective_balance[mask].sum())
    return max(cfg().effective_balance_increment, total)


def process_justification_and_finalization(state: BeaconState) -> None:
    """pos-evolution.md:793-803 — skip the first two epochs, then weigh."""
    if get_current_epoch(state) <= GENESIS_EPOCH + 1:
        return
    previous_target_balance = _unslashed_target_balance(state, get_previous_epoch(state))
    current_target_balance = _unslashed_target_balance(state, get_current_epoch(state))
    weigh_justification_and_finalization(
        state, get_total_active_balance(state),
        previous_target_balance, current_target_balance)


def weigh_justification_and_finalization(state: BeaconState,
                                         total_active_balance: int,
                                         previous_epoch_target_balance: int,
                                         current_epoch_target_balance: int) -> None:
    """The Casper FFG core (pos-evolution.md:817-852).

    Shift the justification bits, justify prev/current epoch on the
    2/3-stake rule (:830-837), then apply the 4-case 2-finalization rule
    (:842-851).
    """
    previous_epoch = get_previous_epoch(state)
    current_epoch = get_current_epoch(state)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    # Shift bits: bit[0] is the current epoch.
    bits = state.justification_bits
    bits[1:] = bits[:-1].copy()
    bits[0] = False
    state.previous_justified_checkpoint = state.current_justified_checkpoint

    if previous_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=previous_epoch, root=get_block_root(state, previous_epoch))
        bits[1] = True
    if current_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=current_epoch, root=get_block_root(state, current_epoch))
        bits[0] = True

    # 2-finalization, 4 cases (pos-evolution.md:842-851).
    if bits[1:4].all() and int(old_previous_justified.epoch) + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if bits[1:3].all() and int(old_previous_justified.epoch) + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if bits[0:3].all() and int(old_current_justified.epoch) + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if bits[0:2].all() and int(old_current_justified.epoch) + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# --- inactivity scores (pos-evolution.md:369) ---------------------------------

def _eligible_mask(state: BeaconState) -> np.ndarray:
    """Active in previous epoch, or slashed and not yet withdrawable."""
    reg = state.validators
    prev = get_previous_epoch(state)
    return active_validator_mask(state, prev) | (
        reg.slashed & (np.uint64(prev + 1) < reg.withdrawable_epoch))


def _target_participating_prev(state: BeaconState) -> np.ndarray:
    prev = get_previous_epoch(state)
    flags = state.previous_epoch_participation
    return (active_validator_mask(state, prev)
            & (((flags >> np.uint8(TIMELY_TARGET_FLAG_INDEX)) & np.uint8(1)).astype(bool))
            & ~state.validators.slashed)


def process_inactivity_updates(state: BeaconState) -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    c = cfg()
    eligible = _eligible_mask(state)
    participating = _target_participating_prev(state)
    scores = state.inactivity_scores.astype(np.int64)
    scores = np.where(eligible & participating, np.maximum(scores - 1, 0), scores)
    scores = np.where(eligible & ~participating, scores + c.inactivity_score_bias, scores)
    if not is_in_inactivity_leak(state):
        scores = np.where(eligible,
                          scores - np.minimum(scores, c.inactivity_score_recovery_rate),
                          scores)
    state.inactivity_scores = scores.astype(np.uint64)


# --- rewards & penalties (Altair flag deltas, vectorized) ---------------------

def process_rewards_and_penalties(state: BeaconState) -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    c = cfg()
    reg = state.validators
    n = len(reg)
    eligible = _eligible_mask(state)
    prev = get_previous_epoch(state)
    eff = reg.effective_balance.astype(np.int64)
    base_reward = (eff // c.effective_balance_increment) * get_base_reward_per_increment(state)

    total_active = get_total_active_balance(state)
    active_increments = total_active // c.effective_balance_increment
    in_leak = is_in_inactivity_leak(state)

    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    from pos_evolution_tpu_torch.config import WEIGHT_DENOMINATOR
    flags = state.previous_epoch_participation
    active_prev = active_validator_mask(state, prev)

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = (active_prev
                         & (((flags >> np.uint8(flag_index)) & np.uint8(1)).astype(bool))
                         & ~reg.slashed)
        participating_increments = int(
            reg.effective_balance[participating].sum()) // c.effective_balance_increment
        gets_reward = eligible & participating
        if not in_leak:
            numer = base_reward * weight * participating_increments
            denom = active_increments * WEIGHT_DENOMINATOR
            rewards += np.where(gets_reward, numer // denom, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties += np.where(eligible & ~participating,
                                  base_reward * weight // WEIGHT_DENOMINATOR, 0)

    # Inactivity penalties (quadratic leak) for non-target-participants.
    target_participating = _target_participating_prev(state)
    scores = state.inactivity_scores.astype(np.int64)
    inactivity_penalty = (eff * scores
                          // (c.inactivity_score_bias * c.inactivity_penalty_quotient))
    penalties += np.where(eligible & ~target_participating, inactivity_penalty, 0)

    balances = state.balances.astype(np.int64)
    balances = np.maximum(balances + rewards - penalties, 0)
    state.balances = balances.astype(np.uint64)


# --- registry updates ---------------------------------------------------------

def process_registry_updates(state: BeaconState) -> None:
    c = cfg()
    reg = state.validators
    current_epoch = get_current_epoch(state)

    # Eligibility: fresh validators at max effective balance join the queue.
    newly_eligible = ((reg.activation_eligibility_epoch == np.uint64(FAR_FUTURE_EPOCH))
                      & (reg.effective_balance == np.uint64(c.max_effective_balance)))
    reg.activation_eligibility_epoch[newly_eligible] = current_epoch + 1

    # Ejections: active validators that fell to the ejection balance.
    ejectable = (active_validator_mask(state, current_epoch)
                 & (reg.effective_balance <= np.uint64(c.ejection_balance)))
    for idx in np.nonzero(ejectable)[0]:
        initiate_validator_exit(state, int(idx))

    # Dequeue up to churn limit, ordered by (eligibility epoch, index).
    finalized = int(state.finalized_checkpoint.epoch)
    queued = np.nonzero(
        (reg.activation_eligibility_epoch <= np.uint64(finalized))
        & (reg.activation_epoch == np.uint64(FAR_FUTURE_EPOCH)))[0]
    if queued.size:
        order = np.lexsort((queued, reg.activation_eligibility_epoch[queued]))
        from pos_evolution_tpu_torch.specs.helpers import get_validator_churn_limit
        dequeued = queued[order][: get_validator_churn_limit(state)]
        reg.activation_epoch[dequeued] = compute_activation_exit_epoch(current_epoch)


# --- slashings sweep ----------------------------------------------------------

def process_slashings(state: BeaconState) -> None:
    c = cfg()
    reg = state.validators
    epoch = get_current_epoch(state)
    total_balance = get_total_active_balance(state)
    adjusted_total = min(int(state.slashings.sum()) * c.proportional_slashing_multiplier,
                         total_balance)
    vector_len = state.slashings.shape[0]
    hit = reg.slashed & (np.uint64(epoch + vector_len // 2) == reg.withdrawable_epoch)
    if not hit.any():
        return
    increment = c.effective_balance_increment
    eff = reg.effective_balance.astype(np.int64)
    penalty = (eff // increment * adjusted_total) // total_balance * increment
    balances = state.balances.astype(np.int64)
    state.balances = np.maximum(balances - np.where(hit, penalty, 0), 0).astype(np.uint64)


# --- resets / rotations -------------------------------------------------------

def process_eth1_data_reset(state: BeaconState) -> None:
    c = cfg()
    next_epoch = get_current_epoch(state) + 1
    if next_epoch % c.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state: BeaconState) -> None:
    """Hysteresis sweep (pos-evolution.md:122-133), fully vectorized."""
    c = cfg()
    reg = state.validators
    hysteresis_increment = c.effective_balance_increment // c.hysteresis_quotient
    downward = hysteresis_increment * c.hysteresis_downward_multiplier
    upward = hysteresis_increment * c.hysteresis_upward_multiplier
    balance = state.balances.astype(np.int64)
    eff = reg.effective_balance.astype(np.int64)
    needs_update = ((balance + downward < eff) | (eff + upward < balance))
    new_eff = np.minimum(balance - balance % c.effective_balance_increment,
                         c.max_effective_balance)
    reg.effective_balance = np.where(needs_update, new_eff, eff).astype(np.uint64)


def process_slashings_reset(state: BeaconState) -> None:
    next_epoch = get_current_epoch(state) + 1
    state.slashings[next_epoch % state.slashings.shape[0]] = 0


def process_randao_mixes_reset(state: BeaconState) -> None:
    vector_len = state.randao_mixes.shape[0]
    current_epoch = get_current_epoch(state)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % vector_len] = np.frombuffer(
        get_randao_mix(state, current_epoch), dtype=np.uint8)


def process_historical_roots_update(state: BeaconState) -> None:
    c = cfg()
    next_epoch = get_current_epoch(state) + 1
    if next_epoch % (c.slots_per_historical_root // c.slots_per_epoch) == 0:
        block_root = merkleize_chunks(state.block_roots, state.block_roots.shape[0])
        state_root = merkleize_chunks(state.state_roots, state.state_roots.shape[0])
        batch_root = merkleize_chunks(
            np.frombuffer(block_root + state_root, dtype=np.uint8).reshape(2, 32))
        state.historical_roots = np.vstack(
            [state.historical_roots,
             np.frombuffer(batch_root, dtype=np.uint8).reshape(1, 32)])


def process_participation_flag_updates(state: BeaconState) -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = np.zeros(len(state.validators), dtype=np.uint8)


def process_sync_committee_updates(state: BeaconState) -> None:
    c = cfg()
    next_epoch = get_current_epoch(state) + 1
    if next_epoch % c.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state)
