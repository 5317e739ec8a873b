"""Dense epoch processing (port of ``pos_evolution_tpu/ops/epoch.py``).

Justification and finalization tallies, inactivity scores, Altair flag
rewards and penalties, the slashings sweep, the hysteresis
effective-balance update and the participation-flag rotation, as one
pass of int64 tensor ops over a struct-of-arrays registry. All division
is floor division on int64 (exact Gwei semantics).

The spec-facing half serves ``specs/epoch.py``'s accelerated boundary:
``densify`` stages a spec ``BeaconState``'s columns on a device,
``registry_churn_dense`` runs ``process_registry_updates`` there, and
``i64_to_epochs`` hands each column back as the spec's uint64 epochs.
What reaches the spec is host numpy: one device-to-host copy a column.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.config import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Config,
)

# FAR_FUTURE_EPOCH (2**64-1) does not fit int64; the dense registry maps
# it to this sentinel. All epoch comparisons behave identically.
FAR_FUTURE_I64 = 2**62


def i64_to_epoch_bits(col: torch.Tensor) -> torch.Tensor:
    """The sentinel back to FAR_FUTURE_EPOCH = 2^64 - 1, carried as the
    int64 bit pattern -1 (every little-endian byte 0xFF), the form an SSZ
    leaf packs; a tensor on the column's device (``i64_to_epochs`` is the
    host uint64 form)."""
    return torch.where(col == FAR_FUTURE_I64, -1, col)


def _host(col) -> np.ndarray:
    """A column as host numpy: one device-to-host copy for a tensor."""
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def _epochs_to_i64_np(a: np.ndarray) -> np.ndarray:
    """uint64 epoch column -> int64 with FAR_FUTURE mapped to the sentinel."""
    a = np.asarray(a).astype(np.uint64)
    return np.where(a == np.uint64(2**64 - 1), np.uint64(FAR_FUTURE_I64), a).astype(np.int64)


def i64_to_epochs(col) -> np.ndarray:
    """Inverse of ``_epochs_to_i64_np``: the sentinel back to FAR_FUTURE,
    as host uint64 (a tensor column is copied to the host once)."""
    a = np.array(_host(col)).astype(np.uint64)
    return np.where(a == np.uint64(FAR_FUTURE_I64), np.uint64(2**64 - 1), a)


class DenseRegistry(NamedTuple):
    """Struct-of-arrays registry plus per-epoch participation."""

    effective_balance: torch.Tensor     # int64[N] Gwei
    balance: torch.Tensor               # int64[N] Gwei
    activation_epoch: torch.Tensor      # int64[N]
    exit_epoch: torch.Tensor            # int64[N]
    withdrawable_epoch: torch.Tensor    # int64[N]
    slashed: torch.Tensor               # bool[N]
    prev_flags: torch.Tensor            # uint8[N]
    cur_flags: torch.Tensor             # uint8[N]
    inactivity_scores: torch.Tensor     # int64[N]


class EpochResult(NamedTuple):
    registry: DenseRegistry
    total_active_balance: torch.Tensor      # int64 scalar
    prev_target_balance: torch.Tensor       # int64 scalar
    cur_target_balance: torch.Tensor        # int64 scalar
    justify_prev: torch.Tensor              # bool scalar
    justify_cur: torch.Tensor               # bool scalar
    new_justification_bits: torch.Tensor    # bool[4]
    finalize_epoch: torch.Tensor            # int64 scalar (-1 = no finalization)


def masked_stake_host(mask: np.ndarray, weight: np.ndarray) -> int:
    """Summed int64 stake where ``mask``, in numpy: the dense monitors'
    evidence pricing on a single device."""
    return int(np.sum(np.where(np.asarray(mask), np.asarray(weight), 0), dtype=np.int64))


def isqrt_i64(x):
    """Exact integer sqrt of non-negative int64: float64 estimate + fixup."""
    s = torch.floor(torch.sqrt(x.to(torch.float64))).to(torch.int64)
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    return torch.where(s * s > x, s - 1, s)


def _active(reg: DenseRegistry, epoch):
    return (reg.activation_epoch <= epoch) & (epoch < reg.exit_epoch)


def _has_flag(flags, idx: int):
    return ((flags >> idx) & 1).bool()


def _masked_sum(values, mask):
    return torch.where(mask, values, 0).sum()


def epoch_core(reg: DenseRegistry, current_epoch, finalized_epoch,
               justification_bits, prev_justified_epoch, cur_justified_epoch,
               slashings_sum, cfg: Config) -> EpochResult:
    """One epoch boundary over the dense registry, in the spec's order:
    justification tallies -> inactivity updates -> rewards/penalties
    (with the new inactivity scores) -> slashings -> hysteresis -> flag
    rotation. Scalar arguments are 0-dim int64 tensors (bits: bool[4])
    on the registry's device."""
    prev_epoch = torch.clamp(current_epoch - 1, min=0)
    incr = cfg.effective_balance_increment

    active_cur = _active(reg, current_epoch)
    active_prev = _active(reg, prev_epoch)
    eff = reg.effective_balance

    total_active = torch.clamp(_masked_sum(eff, active_cur), min=incr)

    # --- justification tallies ---
    prev_target_mask = (active_prev
                        & _has_flag(reg.prev_flags, TIMELY_TARGET_FLAG_INDEX)
                        & ~reg.slashed)
    cur_target_mask = (active_cur
                       & _has_flag(reg.cur_flags, TIMELY_TARGET_FLAG_INDEX)
                       & ~reg.slashed)
    prev_target = torch.clamp(_masked_sum(eff, prev_target_mask), min=incr)
    cur_target = torch.clamp(_masked_sum(eff, cur_target_mask), min=incr)

    past_genesis = current_epoch > 1
    justify_prev = past_genesis & (prev_target * 3 >= total_active * 2)
    justify_cur = past_genesis & (cur_target * 3 >= total_active * 2)

    bits = justification_bits
    new_bits = torch.where(
        past_genesis,
        torch.stack([justify_cur, justify_prev | bits[0], bits[1], bits[2]]),
        bits)

    # 4-case 2-finalization on epoch numbers; the caller maps the winning
    # epoch back to its checkpoint root.
    old_prev, old_cur = prev_justified_epoch, cur_justified_epoch
    fin = torch.full_like(current_epoch, -1)
    fin = torch.where(new_bits[1] & new_bits[2] & new_bits[3]
                      & (old_prev + 3 == current_epoch), old_prev, fin)
    fin = torch.where(new_bits[1] & new_bits[2]
                      & (old_prev + 2 == current_epoch), old_prev, fin)
    fin = torch.where(new_bits[0] & new_bits[1] & new_bits[2]
                      & (old_cur + 2 == current_epoch), old_cur, fin)
    fin = torch.where(new_bits[0] & new_bits[1]
                      & (old_cur + 1 == current_epoch), old_cur, fin)
    fin = torch.where(past_genesis, fin, -1)

    # --- inactivity scores ---
    eligible = active_prev | (reg.slashed & (prev_epoch + 1 < reg.withdrawable_epoch))
    target_participating = prev_target_mask
    in_leak = (prev_epoch - finalized_epoch) > 4
    scores = reg.inactivity_scores
    scores = torch.where(eligible & target_participating,
                         torch.clamp(scores - 1, min=0), scores)
    scores = torch.where(eligible & ~target_participating,
                         scores + cfg.inactivity_score_bias, scores)
    scores = torch.where(~in_leak & eligible,
                         scores - torch.clamp(scores, max=cfg.inactivity_score_recovery_rate),
                         scores)
    new_scores = torch.where(current_epoch > 0, scores, reg.inactivity_scores)

    # --- rewards & penalties (Altair flag deltas) ---
    base_reward = (eff // incr) * (incr * cfg.base_reward_factor // isqrt_i64(total_active))
    active_increments = total_active // incr

    rewards = torch.zeros_like(eff)
    penalties = torch.zeros_like(eff)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = (active_prev & _has_flag(reg.prev_flags, flag_index)
                         & ~reg.slashed)
        participating_increments = _masked_sum(eff, participating) // incr
        numer = base_reward * weight * participating_increments
        denom = active_increments * WEIGHT_DENOMINATOR
        rewards = rewards + torch.where(~in_leak & eligible & participating,
                                        numer // denom, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = penalties + torch.where(
                eligible & ~participating,
                base_reward * weight // WEIGHT_DENOMINATOR, 0)

    inactivity_penalty = (eff * new_scores
                          // (cfg.inactivity_score_bias * cfg.inactivity_penalty_quotient))
    penalties = penalties + torch.where(eligible & ~target_participating,
                                        inactivity_penalty, 0)
    new_balance = torch.where(current_epoch > 0,
                              torch.clamp(reg.balance + rewards - penalties, min=0),
                              reg.balance)

    # --- slashings sweep (proportional penalties) ---
    vector_half = cfg.epochs_per_slashings_vector // 2
    adjusted_total = torch.minimum(
        slashings_sum * cfg.proportional_slashing_multiplier, total_active)
    hit = reg.slashed & (current_epoch + vector_half == reg.withdrawable_epoch)
    slash_penalty = (eff // incr * adjusted_total) // total_active * incr
    new_balance = torch.clamp(new_balance - torch.where(hit, slash_penalty, 0), min=0)

    # --- hysteresis effective-balance update ---
    h_incr = cfg.effective_balance_increment // cfg.hysteresis_quotient
    downward = h_incr * cfg.hysteresis_downward_multiplier
    upward = h_incr * cfg.hysteresis_upward_multiplier
    needs = (new_balance + downward < eff) | (eff + upward < new_balance)
    new_eff = torch.where(
        needs,
        torch.clamp(new_balance - new_balance % incr, max=cfg.max_effective_balance),
        eff)

    new_reg = reg._replace(
        effective_balance=new_eff,
        balance=new_balance,
        inactivity_scores=new_scores,
        prev_flags=reg.cur_flags,
        cur_flags=torch.zeros_like(reg.cur_flags),
    )
    return EpochResult(
        registry=new_reg,
        total_active_balance=total_active,
        prev_target_balance=prev_target,
        cur_target_balance=cur_target,
        justify_prev=justify_prev,
        justify_cur=justify_cur,
        new_justification_bits=new_bits,
        finalize_epoch=fin,
    )


def process_epoch_dense(reg: DenseRegistry, current_epoch, finalized_epoch,
                        justification_bits, prev_justified_epoch,
                        cur_justified_epoch, slashings_sum,
                        cfg: Config) -> EpochResult:
    """Single-device epoch boundary: the scalar arguments (ints or
    tensors) go to the registry's device as int64, the bits as bool[4]."""
    dev = reg.balance.device

    def i64(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    return epoch_core(reg, i64(current_epoch), i64(finalized_epoch),
                      torch.as_tensor(justification_bits, dtype=torch.bool, device=dev),
                      i64(prev_justified_epoch), i64(cur_justified_epoch),
                      i64(slashings_sum), cfg)


# --- the spec-facing half: staging a BeaconState and the registry churn ----------

class ChurnResult(NamedTuple):
    """``registry_churn_dense``'s epoch columns, host int64 (the sentinel for
    FAR_FUTURE)."""

    activation_eligibility_epoch: np.ndarray
    activation_epoch: np.ndarray
    exit_epoch: np.ndarray
    withdrawable_epoch: np.ndarray


def densify_np(state) -> DenseRegistry:
    """A spec ``BeaconState``'s sweep columns as host numpy (int64 Gwei and
    epochs, bool slashed, uint8 flags)."""
    reg = state.validators
    return DenseRegistry(
        effective_balance=reg.effective_balance.astype(np.int64),
        balance=state.balances.astype(np.int64),
        activation_epoch=_epochs_to_i64_np(reg.activation_epoch),
        exit_epoch=_epochs_to_i64_np(reg.exit_epoch),
        withdrawable_epoch=_epochs_to_i64_np(reg.withdrawable_epoch),
        slashed=np.asarray(reg.slashed, dtype=bool),
        prev_flags=np.asarray(state.previous_epoch_participation, dtype=np.uint8),
        cur_flags=np.asarray(state.current_epoch_participation, dtype=np.uint8),
        inactivity_scores=state.inactivity_scores.astype(np.int64),
    )


def _spec_device(device):
    if device is None:
        from pos_evolution_tpu_torch.backend import get_backend
        return get_backend().device
    from pos_evolution_tpu_torch.device import resolve_device
    return resolve_device(device)


def densify(state, device=None) -> DenseRegistry:
    """A spec ``BeaconState``'s sweep columns on ``device`` (the active
    backend's by default): one host-to-device copy a column."""
    dev = _spec_device(device)
    return DenseRegistry(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in densify_np(state)))


def densify_eligibility(state, device=None) -> torch.Tensor:
    """The activation-eligibility column (read only by the churn), int64
    with the sentinel, on ``device`` (the active backend's by default)."""
    return torch.from_numpy(_epochs_to_i64_np(
        state.validators.activation_eligibility_epoch)).to(_spec_device(device))


_PAD_FILLS = {
    "effective_balance": 0, "balance": 0, "activation_epoch": FAR_FUTURE_I64,
    "exit_epoch": FAR_FUTURE_I64, "withdrawable_epoch": FAR_FUTURE_I64,
    "slashed": False, "prev_flags": 0, "cur_flags": 0, "inactivity_scores": 0,
}


def pad_registry(reg: DenseRegistry, n_to: int) -> DenseRegistry:
    """Pad every column to ``n_to`` rows with inert validators (never
    active, zero balances, unslashed, no flags): every mask of
    ``epoch_core`` and ``registry_churn_dense`` is False on them and every
    sum they reach gains zero, so a padded sweep equals the unpadded one
    on the first rows. Tensors stay on their device."""
    cols = {}
    for f in DenseRegistry._fields:
        a = getattr(reg, f)
        if a.shape[0] < n_to:
            pad = torch.full((n_to - a.shape[0],) + tuple(a.shape[1:]), _PAD_FILLS[f],
                             dtype=a.dtype, device=a.device)
            a = torch.cat([a, pad])
        cols[f] = a
    return DenseRegistry(**cols)


def registry_churn_dense(reg: DenseRegistry, activation_eligibility_epoch, current_epoch: int,
                         finalized_epoch: int, cfg: Config) -> ChurnResult:
    """``process_registry_updates`` over the dense registry on its device:
    eligibility marking, balance ejections through the churn-limited exit
    queue, and the activation dequeue, equal to the spec loop.

    The spec assigns exit epochs one ejection at a time (each re-reads
    the queue tail); the closed form reproduces it: the k-th ejection in
    index order lands at
      base + (existing + k) // limit          if existing < limit
      base + 1 + k // limit                   otherwise
    where base = max(max existing exit epoch, activation_exit_epoch(cur)).
    The k are a cumsum rank; the dequeue is an argsort of the int64 key
    eligibility * n + index (non-queued rows share the key 2^63 - 1, so
    the sort need not be stable) and takes the rows of rank < limit.
    Returns host int64 columns."""
    dev = reg.activation_epoch.device
    cur = torch.as_tensor(current_epoch, dtype=torch.int64, device=dev)
    fin = torch.as_tensor(finalized_epoch, dtype=torch.int64, device=dev)
    far = FAR_FUTURE_I64
    eligibility_in = torch.as_tensor(activation_eligibility_epoch, dtype=torch.int64, device=dev)

    active = _active(reg, cur)
    limit = torch.clamp(active.sum() // cfg.churn_limit_quotient,
                        min=cfg.min_per_epoch_churn_limit)

    # 1) eligibility marking
    newly_eligible = (eligibility_in == far) & (reg.effective_balance == cfg.max_effective_balance)
    eligibility = torch.where(newly_eligible, cur + 1, eligibility_in)

    # 2) ejections through the exit queue
    ejectable = (active & (reg.effective_balance <= cfg.ejection_balance)
                 & (reg.exit_epoch == far))
    exiting = reg.exit_epoch != far
    max_exit = torch.where(exiting, reg.exit_epoch, 0).max() if exiting.numel() \
        else torch.zeros((), dtype=torch.int64, device=dev)
    act_exit = cur + 1 + cfg.max_seed_lookahead
    base = torch.maximum(max_exit, act_exit)
    existing = (exiting & (reg.exit_epoch == base)).sum()
    k = torch.cumsum(ejectable, 0) - 1          # rank among the ejectable, index order
    assigned = torch.where(existing < limit, base + (existing + k) // limit,
                           base + 1 + k // limit)
    exit_epoch = torch.where(ejectable, assigned, reg.exit_epoch)
    withdrawable = torch.where(ejectable, assigned + cfg.min_validator_withdrawability_delay,
                               reg.withdrawable_epoch)

    # 3) activation dequeue: (eligibility, index) order, up to the limit
    queued = (eligibility <= fin) & (reg.activation_epoch == far)
    n = reg.activation_epoch.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.where(queued, eligibility * n + idx, 2**63 - 1)
    rank = torch.empty_like(idx).scatter_(0, torch.argsort(key), idx)
    activation = torch.where(queued & (rank < limit), act_exit, reg.activation_epoch)

    return ChurnResult(*(_host(c) for c in (eligibility, activation, exit_epoch, withdrawable)))
