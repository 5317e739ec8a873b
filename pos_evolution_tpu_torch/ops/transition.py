"""One block's attestations applied as one sweep over the participation
and balance columns (port of ``pos_evolution_tpu/ops/transition.py``).

- ``apply_attestation_rows_host``: the numpy oracle. The block's
  invariants (total active balance, the base reward per increment, the
  proposer) are hoisted; then each attestation in block order: a later
  attestation sees the flags earlier ones set, and the proposer's reward
  counts only the flags that were unset at that moment.
- ``apply_attestation_rows_device``: the same sweep in torch on the
  active backend's device, a loop over the block's attestations with
  gathers and an ``index_put_`` per attestation on int64 balances and
  uint8 flags. Rows are padded to one lane count; a padding lane repeats
  its row's first lane, so it writes the value that lane writes, and the
  reward sums mask it out. Equal to the host path bit for bit.

Residency: a module session keeps the three swept columns (and the
effective balances in increments) on the device across consecutive
blocks, with host mirrors of its last write-back. The next sweep compares
the incoming columns with the mirrors: equal, it reuses the carry; a few
rows moved (sync-aggregate rewards between blocks), it patches them; else
it uploads afresh. A device change resets it. Correctness never depends on
lineage: the carry is used only where it equals the host columns. The
write-back of the three columns to the host state (the spec layer and the
merkleizer read host arrays) is one device-to-host copy a column a block.

``specs/transition.process_operations`` reaches the device path through
the backend's ``block_sweep``; ``apply_block_chain`` is the backend's
``multi_block_apply`` (checkpoint sync and backfill).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pos_evolution_tpu_torch.config import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    WEIGHT_DENOMINATOR,
)

__all__ = [
    "apply_attestation_rows_host",
    "apply_attestation_rows_device",
    "apply_block_chain",
    "prewarm_block_sweep",
    "reset_session",
    "session_stats",
]

_PROPOSER_REWARD_DENOM = ((WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
                          * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT)


def _block_constants(state):
    """Per-block invariants of the sweep: attestations move flags and raw
    balances only, so the active set and effective balances hold still
    and the spec's per-attester ``get_base_reward`` is one reduction."""
    from pos_evolution_tpu_torch.config import cfg
    from pos_evolution_tpu_torch.specs.helpers import (
        get_base_reward_per_increment,
        get_beacon_proposer_index,
    )
    return (cfg().effective_balance_increment,
            get_base_reward_per_increment(state),
            get_beacon_proposer_index(state))


# --- many blocks -------------------------------------------------------------------

def apply_block_chain(state, signed_blocks, validate_result: bool = True,
                      pre_block=None, on_applied=None) -> None:
    """Apply a parent-linked run of signed blocks to ``state`` in place.
    One state is carried through the run, so the sweep's resident columns
    are reused or patched from block to block, and the merkleizer diffs
    each block against the one before. Each block is the whole spec
    ``state_transition``; ``pre_block(sb, state)`` runs before it and
    ``on_applied(sb, state)`` after. A failing block raises with every
    earlier block applied."""
    from pos_evolution_tpu_torch.specs.transition import state_transition
    for sb in signed_blocks:
        if pre_block is not None:
            pre_block(sb, state)
        state_transition(state, sb, validate_result)
        if on_applied is not None:
            on_applied(sb, state)


# --- host (numpy oracle) -------------------------------------------------------------

def apply_attestation_rows_host(state, rows) -> None:
    """Apply validated rows ``(attesting int64[k], flag_indices, is_current)``
    (``specs.transition._validate_attestation``'s output, block order) to
    ``state``."""
    if not rows:
        return
    incr, per_incr, proposer = _block_constants(state)
    eff_units = (state.validators.effective_balance // np.uint64(incr)).astype(np.int64)
    for attesting, flag_indices, is_current in rows:
        participation = (state.current_epoch_participation if is_current
                         else state.previous_epoch_participation)
        base_rewards = eff_units[attesting] * int(per_incr)
        new_flags = participation[attesting]
        numerator = 0
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index not in flag_indices:
                continue
            unset = ((new_flags >> np.uint8(flag_index)) & np.uint8(1)) == 0
            numerator += int(base_rewards[unset].sum()) * weight
            new_flags = new_flags | np.uint8(1 << flag_index)
        participation[attesting] = new_flags
        state.balances[proposer] += np.uint64(numerator // _PROPOSER_REWARD_DENOM)


# --- device (torch) --------------------------------------------------------------

def _pad_rows(rows):
    """(idx int64[A, C], valid bool[A, C], is_cur, flag masks): lane j >= k
    of a row of k attesters repeats lane 0 and is invalid."""
    c = max(r[0].shape[0] for r in rows)
    idx = np.empty((len(rows), c), dtype=np.int64)
    valid = np.zeros((len(rows), c), dtype=bool)
    for i, (attesting, _flags, _cur) in enumerate(rows):
        k = attesting.shape[0]
        idx[i, :k] = attesting
        idx[i, k:] = attesting[0]
        valid[i, :k] = True
    masks = [sum(1 << f for f in set(flags)) for _a, flags, _c in rows]
    return idx, valid, [bool(r[2]) for r in rows], masks


def _block_sweep(bal, prev, cur, eff_units, per_incr: int, proposer: int,
                 idx, valid, is_cur, masks) -> None:
    """One block's sweep on the carry ``(bal int64, prev uint8, cur uint8)``
    in place, an attestation at a time. ``idx``/``valid`` [A, C] are on
    the carry's device; ``is_cur``/``masks`` are host lists, so each step
    picks its column and flags without a device read."""
    for a in range(idx.shape[0]):
        lanes, ok = idx[a], valid[a]
        col = cur if is_cur[a] else prev
        new_flags = col[lanes]
        base = torch.where(ok, eff_units[lanes] * per_incr, 0)
        numerator = torch.zeros((), dtype=torch.int64, device=bal.device)
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if not (masks[a] >> flag_index) & 1:
                continue
            unset = ((new_flags >> flag_index) & 1) == 0
            numerator = numerator + torch.where(unset, base, 0).sum() * weight
            new_flags = new_flags | (1 << flag_index)
        # a padding lane writes what lane 0 writes: same index, same value
        col.index_put_((lanes,), new_flags)
        bal[proposer:proposer + 1] += numerator // _PROPOSER_REWARD_DENOM


class _Session:
    """Device residency across consecutive blocks (one a process):
    ``device_cols`` (balances, prev, cur, eff_units) on ``device``, and
    ``mirror``, host copies of the last write-back. ``sweeps`` and
    ``seconds`` count the device sweeps and their wall time, staging and
    write-back included."""

    __slots__ = ("device", "device_cols", "mirror", "uploads", "patches", "reuses",
                 "sweeps", "seconds")

    def __init__(self):
        self.device = None
        self.device_cols = None
        self.mirror = None
        self.uploads = 0
        self.patches = 0
        self.reuses = 0
        self.sweeps = 0
        self.seconds = 0.0


_SESSION = _Session()

# patch at most 1 / _PATCH_FRACTION of the rows before a full upload wins
_PATCH_FRACTION = 8


def reset_session() -> None:
    """Drop the resident carry (tests; a config or device switch)."""
    _SESSION.device = None
    _SESSION.device_cols = None
    _SESSION.mirror = None


def session_stats() -> dict:
    return {"uploads": _SESSION.uploads, "patches": _SESSION.patches,
            "reuses": _SESSION.reuses, "sweeps": _SESSION.sweeps,
            "seconds": _SESSION.seconds}


def _to(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _session_cols(state, eff_units: np.ndarray, dev):
    """The resident (balances, prev, cur, eff_units) for ``state`` on
    ``dev``: the last sweep's carry where the host columns still equal
    its mirrors, patched where a few rows moved since, else uploaded."""
    s = _SESSION
    bal = state.balances
    prev = state.previous_epoch_participation
    cur = state.current_epoch_participation
    if s.device != dev:
        reset_session()
    if s.device_cols is not None:
        m_bal, m_prev, m_cur, m_eff = s.mirror
        if (bal.shape == m_bal.shape and prev.shape == m_prev.shape
                and cur.shape == m_cur.shape and np.array_equal(eff_units, m_eff)):
            d_bal = np.nonzero(bal != m_bal)[0]
            d_prev = np.nonzero(prev != m_prev)[0]
            d_cur = np.nonzero(cur != m_cur)[0]
            dirty = d_bal.size + d_prev.size + d_cur.size
            if dirty == 0:
                s.reuses += 1
                return s.device_cols
            if dirty <= max(1, bal.shape[0] // _PATCH_FRACTION):
                bal_d, prev_d, cur_d, _eff_d = s.device_cols
                for col_d, host, rows in ((bal_d, bal.view(np.int64), d_bal),
                                          (prev_d, prev, d_prev), (cur_d, cur, d_cur)):
                    if rows.size:
                        col_d[_to(rows, dev)] = _to(host[rows], dev)
                s.patches += 1
                return s.device_cols
    s.uploads += 1
    s.device = dev
    s.device_cols = (_to(bal.astype(np.int64), dev), _to(prev, dev), _to(cur, dev),
                     _to(eff_units, dev))
    return s.device_cols


def _backend_device():
    from pos_evolution_tpu_torch.backend import get_backend
    return get_backend().device


def apply_attestation_rows_device(state, rows, device=None) -> None:
    """Device twin of ``apply_attestation_rows_host`` on ``device`` (the
    active backend's by default): sweep the resident columns, write the
    three columns back to the host state, keep them as the next block's
    carry."""
    if not rows:
        return
    t0 = time.perf_counter()
    dev = _backend_device() if device is None else torch.device(device)
    incr, per_incr, proposer = _block_constants(state)
    eff_units = (state.validators.effective_balance // np.uint64(incr)).astype(np.int64)
    idx, valid, is_cur, masks = _pad_rows(rows)
    bal_d, prev_d, cur_d, eff_d = _session_cols(state, eff_units, dev)
    _block_sweep(bal_d, prev_d, cur_d, eff_d, int(per_incr), int(proposer),
                 _to(idx, dev), _to(valid, dev), is_cur, masks)
    new_bal = bal_d.cpu().numpy().astype(np.uint64)
    new_prev = prev_d.cpu().numpy().copy()
    new_cur = cur_d.cpu().numpy().copy()
    state.balances = new_bal
    state.previous_epoch_participation = new_prev
    state.current_epoch_participation = new_cur
    _SESSION.mirror = (new_bal.copy(), new_prev.copy(), new_cur.copy(), eff_units)
    _SESSION.sweeps += 1
    _SESSION.seconds += time.perf_counter() - t0


def prewarm_block_sweep(state, max_attestations: int | None = None) -> int:
    """Run the sweep once on a scratch carry of ``state``'s registry size
    (one attestation of a full committee's lanes) on the active backend's
    device, so that the first block's time holds no first-launch set-up
    (the CUDA context, the allocator's pools). torch compiles nothing per
    shape, so one run covers every shape; returns 1 (0 for an empty
    registry). ``max_attestations``
    is accepted for the JAX package's signature and changes nothing."""
    from pos_evolution_tpu_torch.config import cfg
    dev = _backend_device()
    n = len(state.validators)
    if n == 0:
        return 0
    lanes = min(max(n // cfg().slots_per_epoch, 1), cfg().max_validators_per_committee)
    zeros = [torch.zeros(n, dtype=dt, device=dev)
             for dt in (torch.int64, torch.uint8, torch.uint8, torch.int64)]
    idx = torch.zeros((1, lanes), dtype=torch.int64, device=dev)
    _block_sweep(*zeros, 0, 0, idx, torch.ones_like(idx, dtype=torch.bool), [False], [7])
    return 1
