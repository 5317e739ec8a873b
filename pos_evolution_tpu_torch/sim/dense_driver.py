"""Mainnet-scale dense simulation on one device (port of
``pos_evolution_tpu/sim/dense_driver.py`` with ``mesh=None``).

The registry, the latest-message table and the participation flags live
as tensors on the run's device from genesis, and every slot runs the
protocol at the array level:

- **fork choice**: the per-block vote buckets are rebuilt from the whole
  message table (``ops/forkchoice.rebuild_buckets``), then the head
  descends the O(B) block tree (``head_from_buckets``); every
  ``check_walk_every`` slots a numpy walk over the table read back
  (``head_host``) must find the same head;
- **votes**: committee assignment by the swap-or-not shuffle, and each
  vote batch lands as masked in-place updates of the message and flag
  columns;
- **aggregation**: each slot's committee aggregates are signed and
  verified through kernel K1's wrapper
  (``ops/aggregation.aggregate_signatures_batch`` /
  ``aggregate_verify_batch``);
- **epoch processing**: ``ops/epoch.process_epoch_dense``;
  justification bits and the 4-case finalization rule drive finality.

A ``DenseFaultPlan`` (``sim/faults.py``) turns message loss, delay,
crash windows and view partitions into host masks ANDed before the
vote landing (an all-pass plan is bit-identical to none); the
strategies of ``sim/dense_adversary.py`` act through three hooks per
slot; the monitors of ``sim/dense_monitors.py`` read the origination
masks; ``n_groups=2`` splits the network into per-view tables over one
shared block tree. The policies of ``sim/dense_variants.py`` (Goldfish,
RLMD-GHOST, SSF) change the duty, the head window and the per-slot
gadgets. Workload riders (``das/dense_rider.py``, the DAS sidecar plane;
``lightclient/population.py``, light-client followers) act on each slot's
proposals and at each slot's end, charged to the ``workload`` phase.

Everything is integer math, so a run equals the JAX package's
single-device run bit for bit, on the CPU and on the card, and
``checkpoint`` writes the JAX package's byte format (version 3: JSON
meta and an npz), so that a checkpoint of either package resumes in the
other. ``plain=True`` sends K1 and the digest's K2 to their plain
PyTorch versions on any device: the reference the kernels are held
against.

``telemetry=`` (a ``telemetry.Telemetry``) gets the JAX driver's events
(``run_start``, ``slot``, ``dense_fault``, ``monitor``, ...) and feeds the
phase profiler's registry histogram and bus; ``flight_recorder=`` (a
``telemetry.FlightRecorder``) is armed at the first ``run_slot`` and
samples device memory at slot, epoch and checkpoint boundaries;
``autocheckpoint=`` (``resilience.AutoCheckpoint``, or ``(every_n_slots,
dir)``) arms run supervision: every N slots the columns are gathered to
the host on the loop and compressed and digested on the checkpoint
manager's writer thread (the digest through K2 on the card).
``resume_latest`` resumes from the newest valid step of such a store. A
device mesh is not ported (it raises ``ValueError``, ROADMAP Queue 1
item 3).

Run: ``python -m pos_evolution_tpu_torch.sim.dense_driver --n 1048576
--epochs 4 [--device cuda]``; with the PeerDAS geometry and both riders:
``--das-cells 64 --das-cell-bytes 2048 --das-max-blobs 9 --riders
'[{"kind": "das", "n_blobs": 9, "n_clients": 100000, "samples_per_client":
8}, {"kind": "lightclient", "n_clients": 100000}]'``
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import time
import zipfile

import numpy as np
import torch

from pos_evolution_tpu_torch.config import Config, mainnet_config
from pos_evolution_tpu_torch.convert import to_numpy
from pos_evolution_tpu_torch.device import card_line, resolve_device, words_to_torch
from pos_evolution_tpu_torch.ops.aggregation import (
    aggregate_signatures_batch,
    aggregate_verify_batch,
    messages_to_words,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops.epoch import (
    FAR_FUTURE_I64,
    DenseRegistry,
    masked_stake_host,
    process_epoch_dense,
)
from pos_evolution_tpu_torch.ops.forkchoice import head_from_buckets, head_host, rebuild_buckets
from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation
from pos_evolution_tpu_torch.ops.variant_tally import next_pow2 as _next_pow2
from pos_evolution_tpu_torch.profiling.phases import NULL_TIMER, PhaseTimer
from pos_evolution_tpu_torch.sim.dense_adversary import VoteBatch, dense_adversary_from_config
from pos_evolution_tpu_torch.sim.dense_monitors import dense_monitor_from_config
from pos_evolution_tpu_torch.sim.dense_variants import (
    dense_rider_from_config,
    dense_variant_from_config,
    expiry_kernel,
)
from pos_evolution_tpu_torch.sim.faults import DenseFaultPlan
from pos_evolution_tpu_torch.utils.metrics import trace_region

__all__ = ["DenseSimulation"]

GWEI = 10**9
_GENESIS_EFF = 32 * GWEI

# genesis fill of each registry column: (value, dtype)
_COL_FILLS = {
    "effective_balance": (_GENESIS_EFF, torch.int64),
    "balance": (_GENESIS_EFF, torch.int64),
    "activation_epoch": (0, torch.int64),
    "exit_epoch": (FAR_FUTURE_I64, torch.int64),
    "withdrawable_epoch": (FAR_FUTURE_I64, torch.int64),
    "slashed": (False, torch.bool),
    "prev_flags": (0, torch.uint8),
    "cur_flags": (0, torch.uint8),
    "inactivity_scores": (0, torch.int64),
}


def _hash(*parts) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
    return h.digest()


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"DenseSimulation: {what} is not ported yet (ROADMAP Queue 1 {item})")


def _write_npz(out, cols: dict) -> None:
    """``np.savez_compressed``'s format, a zip of deflated ``.npy`` members
    that ``np.load`` reads as any npz, written at deflate level 1 with
    fixed member times: the same columns give the same bytes, and 2^20
    validators' 83 MB compress ~4x faster than at the default level 6
    (the checkpoint writer's time, which bounds how much a kill can lose)."""
    with zipfile.ZipFile(out, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as z:
        for name, arr in cols.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)
            z.writestr(zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0)),
                       member.getvalue(), compress_type=zipfile.ZIP_DEFLATED, compresslevel=1)


def _nbytes(cols: dict) -> int:
    return sum(int(a.nbytes) for a in cols.values() if hasattr(a, "nbytes"))


class _View:
    """One view group's mutable state: its message table, flag columns
    (inside the registry), FFG scalars and block visibility."""

    __slots__ = ("bits", "cur_just", "epoch_start_idx", "finalized", "msg_block",
                 "msg_epoch", "msg_slot", "pending", "prev_just", "registry",
                 "vis_d", "vis_host")

    def __init__(self):
        self.bits = np.zeros(4, dtype=bool)
        self.prev_just = (0, 0)   # (epoch, block index)
        self.cur_just = (0, 0)
        self.finalized = (0, 0)
        self.epoch_start_idx: dict[int, int] = {0: 0}
        self.pending: list = []   # delayed VoteBatches for the next slot


class DenseSimulation:
    """Multi-epoch run at the array level on one device: honest and
    synchronous by default; adversarial, faulted and partitioned when
    given a chaos composition. ``device`` is CUDA unless the caller asks
    for another (raising without it)."""

    def __init__(self, n_validators: int, cfg: Config | None = None, *,
                 device="cuda", plain: bool = False, seed: int = 0,
                 shuffle_rounds: int = 10, verify_aggregates: bool = True,
                 capacity: int = 256, check_walk_every: int = 16, n_groups: int = 1,
                 fault_plan=None, adversaries=(), monitors=(), phase_profile=None,
                 variant=None, mesh=None, telemetry=None, flight_recorder=None,
                 autocheckpoint=None, riders=()):
        if mesh is not None:
            raise _not_ported("a device mesh", "item 3, the multi-GPU mode")
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.cfg = cfg or mainnet_config()
        self.n = int(n_validators)
        self.seed = int(seed)
        self.shuffle_rounds = int(shuffle_rounds)
        self.verify_aggregates = bool(verify_aggregates)
        self.check_walk_every = int(check_walk_every)
        self.S = int(self.cfg.slots_per_epoch)

        # --- chaos composition ---------------------------------------------
        self.n_groups = int(n_groups)
        if self.n_groups not in (1, 2):
            raise ValueError(f"1 or 2 view groups, got {self.n_groups}")
        self.fault_plan = fault_plan
        if self.n_groups > 1 and (fault_plan is None or not fault_plan.partition):
            raise ValueError("multi-view runs need a partitioned DenseFaultPlan")
        self.adversaries = list(adversaries)
        self.monitors = list(monitors)
        self.telemetry = telemetry
        self.variant = dense_variant_from_config(variant)
        self.riders = [r for r in riders if r is not None]
        # per-view proposer-boost candidate: the newest timely (visible)
        # proposal; None while withheld or before the first slot
        self._boost: list[int | None] = [None] * self.n_groups
        # ``phase_profile=N`` fences every N-th slot; None/0 threads the
        # disabled twin so the loop body stays branch-free either way
        self.phases = (PhaseTimer(sample_every=int(phase_profile),
                                  registry=telemetry.registry if telemetry else None,
                                  bus=telemetry.bus if telemetry else None)
                       if phase_profile else NULL_TIMER)
        # the flight recorder is armed at the first ``run_slot``, not here,
        # so construction's work is charged to no phase
        self.flight = flight_recorder
        self._flight_probe = False  # True during a probed slot's phases
        self.last_capture: dict = {}  # the newest checkpoint capture's record
        self.monitor_violations: list[dict] = []
        # honest duty split: view group per validator
        self.group_of = (np.arange(self.n, dtype=np.int64) % self.n_groups).astype(np.int8)
        self.controlled_any = np.zeros(self.n, dtype=bool)
        for adv in self.adversaries:
            self.controlled_any[adv.controlled[adv.controlled < self.n]] = True
        self._eff_genesis = np.full(self.n, _GENESIS_EFF, dtype=np.int64)
        self.total_stake = self.n * _GENESIS_EFF
        self._originated: list = []      # this slot's (view, batch) taps
        self._pending_vis: list = []     # (block_idx, view, at_slot)

        # --- registry and message tables on the device ---------------------
        dev = self.device
        self.views = [_View() for _ in range(self.n_groups)]
        for view in self.views:
            view.registry = DenseRegistry(**{
                f: torch.full((self.n,), v, dtype=dt, device=dev)
                for f, (v, dt) in _COL_FILLS.items()})
            view.msg_block = torch.full((self.n,), -1, dtype=torch.int32, device=dev)
            view.msg_epoch = torch.zeros(self.n, dtype=torch.int64, device=dev)
            view.msg_slot = torch.zeros(self.n, dtype=torch.int64, device=dev)

        # --- the O(B) block tree -------------------------------------------
        self.capacity = _next_pow2(capacity)
        self.roots: list[bytes] = []
        self.parents: list[int] = []
        self.block_slots: list[int] = []
        self._set_tree_columns()
        for view in self.views:
            view.vis_host = np.zeros(self.capacity, dtype=bool)
            view.vis_d = self._col(view.vis_host)

        # --- run scalars ----------------------------------------------------
        self.slot = 0
        self.metrics: list[dict] = []
        self.aggregates_verified = 0
        self.walk_checks: list[bool] = []
        self.view_heads: list[bytes] = [b""] * self.n_groups
        self._epoch_ready = -1
        self._perm_host: np.ndarray | None = None
        self._assigned_host: np.ndarray | None = None

        # synthetic per-validator pubkeys -> signature midstates (the
        # same host draw as the JAX package)
        rng = np.random.default_rng(self.seed)
        self.pk_states = precompute_pk_states(
            rng.integers(0, 256, (self.n, 48)).astype(np.uint8), dev, plain=self.plain)

        self._append_block(_hash(b"genesis", self.seed), -1, 0)

        self.variant.bind(self)
        for r in self.riders:
            r.bind(self)
        for adv in self.adversaries:
            adv.bind(self)
        for mon in self.monitors:
            mon.bind(self)
        self._emit("run_start", n_validators=self.n, n_groups=self.n_groups, dense=True,
                   mesh=None, variant=self.variant.name)
        if self.variant.name != "gasper" or self.riders:
            self._emit("variant_attach", variant=self.variant.describe(),
                       riders=[r.describe() for r in self.riders])
        if self.adversaries or self.monitors:
            self._emit("monitor_attach",
                       monitors=[m.describe() for m in self.monitors],
                       adversaries=[a.describe() for a in self.adversaries],
                       faults=self.fault_plan.describe() if self.fault_plan else None)
        # run supervision: gather to host on the loop, compress and digest
        # on the checkpoint manager's writer thread
        self.supervision = None
        if autocheckpoint is not None:
            self.attach_autocheckpoint(autocheckpoint)

    # -- view 0 is the run when n_groups == 1 ---------------------------------

    registry = property(lambda s: s.views[0].registry,
                        lambda s, v: setattr(s.views[0], "registry", v))
    msg_block = property(lambda s: s.views[0].msg_block,
                         lambda s, v: setattr(s.views[0], "msg_block", v))
    msg_epoch = property(lambda s: s.views[0].msg_epoch,
                         lambda s, v: setattr(s.views[0], "msg_epoch", v))
    msg_slot = property(lambda s: s.views[0].msg_slot,
                        lambda s, v: setattr(s.views[0], "msg_slot", v))
    bits = property(lambda s: s.views[0].bits,
                    lambda s, v: setattr(s.views[0], "bits", v))
    prev_just = property(lambda s: s.views[0].prev_just,
                         lambda s, v: setattr(s.views[0], "prev_just", v))
    cur_just = property(lambda s: s.views[0].cur_just,
                        lambda s, v: setattr(s.views[0], "cur_just", v))
    finalized = property(lambda s: s.views[0].finalized,
                         lambda s, v: setattr(s.views[0], "finalized", v))
    epoch_start_idx = property(lambda s: s.views[0].epoch_start_idx,
                               lambda s, v: setattr(s.views[0], "epoch_start_idx", v))

    def _emit(self, type_: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.bus.emit(type_, **fields)

    def _col(self, a: np.ndarray) -> torch.Tensor:
        """A host array to the run's device, always as a copy: a tensor
        never shares memory with a numpy array the loop keeps mutating."""
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    # -- block tree ------------------------------------------------------------

    def _set_tree_columns(self) -> None:
        """Upload the whole block tree at ``self.capacity`` (construction,
        growth, resume)."""
        b = len(self.roots)
        parent = np.full(self.capacity, -1, np.int32)
        parent[:b] = self.parents
        slot = np.zeros(self.capacity, np.int32)
        slot[:b] = self.block_slots
        real = np.zeros(self.capacity, bool)
        real[:b] = True
        self._parent_d = self._col(parent)
        self._slot_d = self._col(slot)
        self._real_d = self._col(real)
        self._viable_d = torch.ones(self.capacity, dtype=torch.bool, device=self.device)
        self._set_rank()

    def _set_rank(self) -> None:
        """Lexicographic rank of every root, the descent's tie-break."""
        order = np.argsort(np.argsort(np.array(self.roots, dtype=object)))
        rank = np.zeros(self.capacity, np.int32)
        rank[: len(self.roots)] = order
        self._rank_d = self._col(rank)

    def _append_block(self, root: bytes, parent: int, slot: int, visible_to=None) -> int:
        """``visible_to``: None = every view, () = private (withheld),
        or an iterable of view ids (partitioned proposals)."""
        i = len(self.roots)
        if i >= self.capacity:
            self._grow(self.capacity * 2)
        self.roots.append(root)
        self.parents.append(parent)
        self.block_slots.append(slot)
        self._parent_d[i] = parent
        self._slot_d[i] = slot
        self._real_d[i] = True
        vis = range(self.n_groups) if visible_to is None else tuple(visible_to)
        for g, view in enumerate(self.views):
            see = g in vis
            view.vis_host[i] = see
            if see:
                view.vis_d[i] = True
        self._set_rank()
        return i

    def _grow(self, new_capacity: int) -> None:
        old_capacity = self.capacity
        self.capacity = _next_pow2(new_capacity)
        self._set_tree_columns()
        for view in self.views:
            vis = np.zeros(self.capacity, dtype=bool)
            vis[:old_capacity] = view.vis_host
            view.vis_host = vis
            view.vis_d = self._col(vis)

    def adversary_block(self, parent: int, slot: int, tag=(), visible: bool = True) -> int:
        """Adversary-built block (equivocating sibling / private-chain
        extension): deterministic root from the identity, appended with
        full or zero visibility."""
        root = _hash(b"ablock", self.seed, slot, self.roots[parent], *tag)
        return self._append_block(root, parent, slot, visible_to=None if visible else ())

    def reveal_blocks(self, indices) -> None:
        """Flip withheld blocks visible in every view (the release)."""
        for view in self.views:
            for i in indices:
                view.vis_host[i] = True
                view.vis_d[i] = True

    def withhold_proposal(self, g: int, idx: int) -> None:
        """An adversary proposer withholds this slot's proposal: the block
        goes private in every view, honest duty falls back to voting its
        parent, and it earns no proposer boost; ``reveal_blocks`` undoes
        it."""
        for view in self.views:
            view.vis_host[idx] = False
            view.vis_d[idx] = False

    # -- variant seam ----------------------------------------------------------

    def duty_mask(self, slot: int) -> np.ndarray:
        """bool[N]: who votes this slot: the slot committee under Gasper,
        everyone under the full-participation variants."""
        if self.variant.full_participation:
            return np.ones(self.n, dtype=bool)
        return self.committee_mask(slot)

    def _vote_target(self, g: int, idx: int) -> int:
        """What view ``g`` votes for when told to vote ``idx``: the block
        if it is visible, else its parent."""
        return idx if self.views[g].vis_host[idx] else self.parents[idx]

    def _variant_head_inputs(self, g: int):
        """(window, start_idx, boost_idx, boost_amount) for one view's head
        query: the single source of both the device descent and the host
        walk. The window is as of ``self.slot + 1``."""
        v = self.variant
        win = v.window(self.slot + 1)
        anchor = v.anchor(g)
        start = self.views[g].cur_just[1] if anchor is None else anchor
        bidx, bamt = -1, 0
        if v.boost_percent and self._boost[g] is not None:
            bidx = self._boost[g]
            bamt = self.total_stake // self.S * v.boost_percent // 100
        return win, start, bidx, bamt

    # -- committees ------------------------------------------------------------

    def _start_epoch(self, epoch: int) -> None:
        """Shuffle the registry into this epoch's slot assignment."""
        seed = _hash(b"shuffle", self.seed, epoch)[:32]
        perm = shuffle_permutation(seed, self.n, self.shuffle_rounds, self.device)
        self._perm_host = to_numpy(perm).astype(np.int64)
        self._inv_perm = np.argsort(self._perm_host).astype(np.int64)
        self._assigned_host = self._perm_host * self.S // self.n
        self._epoch_ready = epoch

    def committee_mask(self, slot: int) -> np.ndarray:
        """bool[N]: this slot's committee members (host side)."""
        return self._assigned_host == (slot % self.S)

    def _slot_attesters(self, slot_in_epoch: int) -> np.ndarray:
        t = int(slot_in_epoch)
        lo = (t * self.n + self.S - 1) // self.S
        hi = ((t + 1) * self.n + self.S - 1) // self.S
        return self._inv_perm[lo:hi]

    # -- fork choice -----------------------------------------------------------

    def _head(self, g: int = 0) -> int:
        view = self.views[g]
        win, start, bidx, bamt = self._variant_head_inputs(g)
        with self.phases.phase("vote_pass"):
            msg = view.msg_block
            if win is not None:
                msg = expiry_kernel(msg, view.msg_slot, win[0], win[1])
            buckets = rebuild_buckets(msg, view.registry.effective_balance, self.capacity)
            if self._flight_probe:
                self.flight.probe_skew("vote_pass", buckets, slot=self.slot + 1)
            self.phases.fence(buckets)
        # the int() read waits for the device, so this phase is fenced on
        # every slot, sampled or not
        with self.phases.phase("head_descent"):
            head_idx, _ = head_from_buckets(
                self._parent_d, self._real_d & view.vis_d, self._rank_d, self._viable_d,
                start, buckets, bidx, bamt, self.capacity)
            return int(head_idx)

    def head_host_walk(self, g: int = 0) -> bytes:
        """The host oracle: read the view's message table back, sum vote
        weights and subtree weights in numpy, descend greedily, withheld
        blocks masked out."""
        view = self.views[g]
        win, start, bidx, bamt = self._variant_head_inputs(g)
        msg = to_numpy(view.msg_block)[: self.n]
        if win is not None:
            ms = to_numpy(view.msg_slot)[: self.n]
            msg = np.where((ms >= win[0]) & (ms <= win[1]), msg, -1)
        eff = to_numpy(view.registry.effective_balance)[: self.n]
        valid = msg >= 0
        vw = np.zeros(self.capacity + 1, np.int64)
        np.add.at(vw, np.where(valid, msg, self.capacity), np.where(valid, eff, 0))
        b = len(self.roots)
        parent = np.full(self.capacity, -1, np.int32)
        parent[:b] = self.parents
        real = np.zeros(self.capacity, bool)
        real[:b] = True
        idx = head_host(parent, real & view.vis_host, to_numpy(self._rank_d),
                        np.ones(self.capacity, bool), start, vw[: self.capacity], bidx, bamt)
        return self.roots[idx]

    # -- monitors' tally helpers -----------------------------------------------

    def stake_of(self, mask: np.ndarray) -> int:
        """Genesis-stake tally of a validator mask: the monitors' evidence
        pricing (int64, exact)."""
        return masked_stake_host(mask, self._eff_genesis)

    def _descends(self, idx: int, ancestor: int) -> bool:
        cur = idx
        while cur >= 0:
            if cur == ancestor:
                return True
            cur = self.parents[cur]
        return False

    def _target_matches(self, g: int, block_idx: int, epoch: int) -> bool:
        """A vote earns the view's timely-target flag only when its chain
        carries the view's checkpoint for that epoch."""
        boundary = self.views[g].epoch_start_idx.get(epoch)
        if boundary is None:
            return False
        return self._descends(block_idx, boundary)

    # -- votes -----------------------------------------------------------------

    def _apply_batch(self, g: int, mask_np: np.ndarray, block_idx: int, epoch: int,
                     vote_slot: int, flag_on: bool) -> None:
        """One masked vote landing on view ``g``'s columns, in place.
        ``vote_slot`` stamps the landed rows with the vote's origination
        slot."""
        view = self.views[g]
        mask = self._col(mask_np.astype(bool, copy=False))
        view.msg_block.masked_fill_(mask, block_idx)
        view.msg_epoch.masked_fill_(mask, epoch)
        view.msg_slot.masked_fill_(mask, vote_slot)
        if flag_on:
            view.registry.cur_flags.bitwise_or_(mask.to(torch.uint8) * 7)

    def _fault_masks(self, slot: int, g: int):
        """(dropped, delayed, crashed) bool[N] for one (slot, view)."""
        if self.fault_plan is None:
            z = np.zeros(self.n, dtype=bool)
            return z, z, z
        dropped, delayed = self.fault_plan.delivery_masks(slot, g, self.n)
        crashed = self.fault_plan.crashed_mask(slot, self.n)
        return dropped, delayed, crashed

    def _deliver_batch(self, g: int, batch, slot: int, epoch_now: int) -> np.ndarray:
        """Route one VoteBatch into view ``g`` through the fault masks;
        the delayed slice re-queues for the next slot. Returns the mask
        that landed."""
        mask = batch.mask
        # a delayed or banked vote keeps its origination slot
        vslot = slot if batch.slot is None else int(batch.slot)
        if not self.variant.admit(vslot, slot):
            # too old to merge into the view at all (RLMD)
            self._emit("dense_fault", slot=slot, view=g, expired=int(mask.sum()))
            return np.zeros(self.n, dtype=bool)
        if batch.faultable:
            dropped, delayed, crashed = self._fault_masks(slot, g)
            land = mask & ~crashed & ~dropped & ~delayed
            late = mask & ~crashed & delayed
            if late.any():
                self.views[g].pending.append(
                    VoteBatch(late, batch.block, batch.epoch, views=(g,), flag=batch.flag,
                              faultable=False, slot=vslot))
            n_d, n_l = int((mask & dropped).sum()), int(late.sum())
            if n_d or n_l:
                self._emit("dense_fault", slot=slot, view=g, dropped=n_d, delayed=n_l)
        else:
            land = mask
        if not land.any():
            return land
        if batch.flag is not None:
            flag_on = bool(batch.flag)
        else:
            # a vote delayed across an epoch boundary still updates the
            # LMD table but no longer earns the current-epoch flag
            flag_on = (batch.epoch == epoch_now
                       and self._target_matches(g, batch.block, batch.epoch))
        self._apply_batch(g, land, batch.block, batch.epoch, vslot, flag_on)
        return land

    def apply_votes_now(self, batches, slot: int) -> None:
        """Immediate application for release hooks (before_propose),
        through the same fault masks and origination tap."""
        epoch_now = slot // self.S
        for batch in batches:
            for g in range(self.n_groups):
                if batch.for_view(g):
                    self._originated.append((g, batch))
                    self._deliver_batch(g, batch, slot, epoch_now)

    # -- aggregation -----------------------------------------------------------

    def _verify_slot(self, slot_in_epoch: int, block_root: bytes, landed: np.ndarray) -> None:
        """Sign and verify the slot's committee aggregates over the
        validators whose vote for this block landed, through K1's
        wrapper (its plain version with ``plain=True``)."""
        attesters = self._slot_attesters(slot_in_epoch)
        if attesters.size == 0:
            return
        a_real = int(self.cfg.max_committees_per_slot)
        lanes = _next_pow2(-(-attesters.size // a_real))
        committees = np.zeros((a_real, lanes), np.int32)
        bits = np.zeros((a_real, lanes), bool)
        for c in range(a_real):
            member = attesters[c::a_real]
            committees[c, : member.size] = member
            bits[c, : member.size] = landed[member]
        msg = messages_to_words(
            np.frombuffer(block_root, dtype=np.uint8)[None, :].repeat(a_real, axis=0))
        comm_t, bits_t = self._col(committees), self._col(bits)
        msg_t = words_to_torch(msg, self.device)
        sigs = aggregate_signatures_batch(self.pk_states, comm_t, bits_t, msg_t,
                                          plain=self.plain)
        ok = to_numpy(aggregate_verify_batch(self.pk_states, comm_t, bits_t, msg_t, sigs,
                                             plain=self.plain))
        nonempty = bits.any(axis=1)
        if not ok[nonempty].all():
            raise AssertionError(f"aggregate verification failed at slot {self.slot + 1}")
        self.aggregates_verified += int(nonempty.sum())

    # -- epoch boundary --------------------------------------------------------

    def _epoch_boundary(self, view: _View, entering_epoch: int) -> None:
        """Epoch processing for one view when entering ``entering_epoch``
        (``current_epoch`` = the epoch just completed)."""
        cur_e = entering_epoch - 1
        if self.flight is not None:
            # the registry bytes a JAX run would donate to its epoch step
            from pos_evolution_tpu_torch.telemetry import torchrt
            torchrt.record_donation(sum(int(a.nbytes) for a in view.registry),
                                    site="epoch_step")
        out = process_epoch_dense(view.registry, cur_e, view.finalized[0], view.bits,
                                  view.prev_just[0], view.cur_just[0], 0, self.cfg)
        view.registry = out.registry
        if cur_e > 1:
            old_prev, old_cur = view.prev_just, view.cur_just
            view.prev_just = view.cur_just
            if bool(out.justify_prev):
                view.cur_just = (cur_e - 1, view.epoch_start_idx[cur_e - 1])
            if bool(out.justify_cur):
                view.cur_just = (cur_e, view.epoch_start_idx[cur_e])
            view.bits = to_numpy(out.new_justification_bits).copy()
            fin = int(out.finalize_epoch)
            if fin >= 0:
                # the later finalization cases use the old current
                # justified checkpoint and win in the spec: check it first
                if fin == old_cur[0]:
                    view.finalized = old_cur
                elif fin == old_prev[0]:
                    view.finalized = old_prev

    # -- main loop -------------------------------------------------------------

    def _cross_views(self, g: int):
        """Where and when view ``g``'s traffic reaches other views: nowhere
        under a full partition, one slot late under the delay partition,
        immediately otherwise."""
        if self.n_groups == 1:
            return []
        mode = self.fault_plan.partition if self.fault_plan else None
        if mode == "full":
            return []
        delay = 1 if mode == "delay" else 0
        return [(h, delay) for h in range(self.n_groups) if h != g]

    def _merge_active(self) -> bool:
        """View-merge (Goldfish/RLMD/SSF) across views, unless a full
        partition severs the proposer's broadcast."""
        if not self.variant.view_merge or self.n_groups <= 1:
            return False
        mode = self.fault_plan.partition if self.fault_plan else None
        return mode != "full"

    def run_slot(self) -> None:
        # a named host range while torch.profiler records: the outer
        # segment of every kernel's launch path below the run's own
        with trace_region("slot"):
            self._run_slot()

    def _run_slot(self) -> None:
        pt = self.phases
        s = self.slot + 1
        epoch = s // self.S
        fr = self.flight
        if fr is not None and not fr.installed:
            fr.install()   # armed at the first slot: see __init__
        self._flight_probe = fr is not None and fr.should_probe(s)
        pt.begin_slot(s)
        if s % self.S == 0 and s > 0:
            with pt.phase("epoch_sweep"):
                for view in self.views:
                    self._epoch_boundary(view, epoch)
                if self._flight_probe:
                    fr.probe_skew("epoch_sweep", self.views[0].registry.balance, slot=s)
                pt.fence(*(v.registry.balance for v in self.views))
            if fr is not None:
                fr.on_epoch(slot=s)
        if self._epoch_ready < epoch:
            # ends on a host read of the permutation: self-fencing
            with pt.phase("shuffle"):
                self._start_epoch(epoch)
        self._originated = []
        with pt.phase("record"):
            # delayed cross-view block visibility lands at slot start
            still = []
            for idx, g, at_slot in self._pending_vis:
                if at_slot <= s:
                    view = self.views[g]
                    view.vis_host[idx] = True
                    view.vis_d[idx] = True
                else:
                    still.append((idx, g, at_slot))
            self._pending_vis = still
            for adv in self.adversaries:
                adv.before_propose(self, s)

        # --- per-view proposals --------------------------------------------
        merge = self._merge_active()
        new_idx: list[int] = []
        for g in range(self.n_groups):
            head = self._head(g)
            with pt.phase("record"):
                if self.n_groups == 1:
                    root = _hash(b"block", self.seed, s, self.roots[head])
                else:
                    root = _hash(b"block", self.seed, s, self.roots[head], g)
                visible_to = None
                cross = self._cross_views(g)
                if self.n_groups > 1 and not merge:
                    visible_to = [g] + [h for h, d in cross if d == 0]
                idx = self._append_block(root, head, s, visible_to=visible_to)
                if not merge:
                    # without view-merge, delayed cross visibility lands
                    # next slot
                    for h, d in cross:
                        if d > 0:
                            self._pending_vis.append((idx, h, s + d))
                if s % self.S == 0:
                    self.views[g].epoch_start_idx[epoch] = idx
                new_idx.append(idx)

        with pt.phase("record"):
            for adv in self.adversaries:
                adv.on_proposals(self, s, new_idx)
            # proposer-boost candidates until the next proposal: this
            # slot's proposal, unless withheld
            for g in range(self.n_groups):
                self._boost[g] = new_idx[g] if self.views[g].vis_host[new_idx[g]] else None
        if self.riders:
            with pt.phase("workload"):
                for r in self.riders:
                    if hasattr(r, "on_proposals"):
                        r.on_proposals(self, s, new_idx)

        # --- votes: pending (delayed) first, then honest, then adversarial
        with pt.phase("vote_apply"):
            landed_own = [np.zeros(self.n, dtype=bool) for _ in range(self.n_groups)]
            for g, view in enumerate(self.views):
                pending, view.pending = view.pending, []
                for batch in pending:
                    self._originated.append((g, batch))
                    land = self._deliver_batch(g, batch, s, epoch)
                    if batch.block == new_idx[g]:
                        landed_own[g] |= land
            # view-merge variants vote one merged target per slot (the
            # proposer group's proposal); a withheld target falls back to
            # its parent
            vote_targets = [new_idx[s % self.n_groups] if merge else new_idx[g]
                            for g in range(self.n_groups)]
            duty_all = self.duty_mask(s)
            for g in range(self.n_groups):
                duty = duty_all & (self.group_of == g) & ~self.controlled_any
                tgt = self._vote_target(g, vote_targets[g])
                batch = VoteBatch(duty, tgt, epoch, views=(g,))
                self._originated.append((g, batch))
                land = self._deliver_batch(g, batch, s, epoch)
                if tgt == new_idx[g]:
                    landed_own[g] |= land
                for h, delay in self._cross_views(g):
                    # stamped at origination: a delayed copy carries slot s
                    cross = VoteBatch(duty.copy(), tgt, epoch, views=(h,), slot=s)
                    if delay == 0:
                        self._originated.append((h, cross))
                        self._deliver_batch(h, cross, s, epoch)
                    else:
                        self.views[h].pending.append(cross)
            for adv in self.adversaries:
                for batch in adv.vote_batches(self, s, new_idx):
                    for g in range(self.n_groups):
                        if batch.for_view(g):
                            self._originated.append((g, batch))
                            land = self._deliver_batch(g, batch, s, epoch)
                            if batch.block == new_idx[g]:
                                landed_own[g] |= land
            pt.fence(*(v.msg_block for v in self.views))

        if self.verify_aggregates and not self.variant.full_participation:
            # ends on a host read of the verdicts: self-fencing. The
            # full-participation variants have no committee aggregate.
            with pt.phase("aggregate_verify"):
                for g in range(self.n_groups):
                    if landed_own[g].any():
                        self._verify_slot(s % self.S, self.roots[new_idx[g]], landed_own[g])

        self.slot = s
        self.view_heads = [self.roots[new_idx[g]] for g in range(self.n_groups)]

        with pt.phase("variant_tally"):
            self.variant.on_slot_end(self, s, vote_targets)
        if self.riders:
            with pt.phase("workload"):
                for r in self.riders:
                    if hasattr(r, "on_slot_end"):
                        r.on_slot_end(self, s)

        with pt.phase("monitors"):
            for mon in self.monitors:
                mon.on_votes(self, s, self._originated)
            for mon in self.monitors:
                for v in mon.on_slot_end(self, s):
                    v.setdefault("slot", s)
                    self.monitor_violations.append(v)
                    self._emit("monitor", **v)

        if self.check_walk_every and s % self.check_walk_every == 0:
            # device head vs the independent host walk (not the proposed
            # block: an adversary can legitimately move the head)
            dev_head = self.roots[self._head(0)]
            with pt.phase("host_audit"):
                self.walk_checks.append(self.head_host_walk(0) == dev_head)
        with pt.phase("record"):
            m = {
                "slot": s, "head_root": self.view_heads[0].hex()[:16],
                "justified_epoch": self.views[0].cur_just[0],
                "finalized_epoch": self.views[0].finalized[0],
                "n_blocks": len(self.roots),
            }
            if self.n_groups > 1:
                m["views"] = [
                    {"head_root": self.view_heads[g].hex()[:16],
                     "justified_epoch": self.views[g].cur_just[0],
                     "finalized_epoch": self.views[g].finalized[0]}
                    for g in range(self.n_groups)]
            self.metrics.append(m)
            self._emit("slot", slot=s, head_slot=s,
                       justified_epoch=self.views[0].cur_just[0],
                       finalized_epoch=self.views[0].finalized[0])
        if self.supervision is not None:
            with pt.phase("checkpoint_capture"):
                self.supervision.tick(self, s, self._checkpoint_async_capture)
        if fr is not None and self._flight_probe:
            with pt.phase("record"):
                fr.on_slot(s)  # memory watermark at the slot boundary
        self._flight_probe = False
        pt.end_slot(s)

    def run_epochs(self, n_epochs: int) -> None:
        """Run through the first slot of epoch ``n_epochs`` (inclusive), so
        the boundary entering it, which can finalize epoch
        ``n_epochs - 2``, has been processed."""
        while self.slot < n_epochs * self.S:
            self.run_slot()

    # -- results ---------------------------------------------------------------

    def summary(self) -> dict:
        # final parity pin: the host walk against a fresh device head query
        head = self.roots[self._head(0)]
        self.walk_checks.append(self.head_host_walk(0) == head)
        out = {
            "n_validators": self.n,
            "slots": self.slot,
            "epochs": self.slot // self.S,
            "n_blocks": len(self.roots),
            "justified_epoch": self.views[0].cur_just[0],
            "finalized_epoch": self.views[0].finalized[0],
            "finality_reached": self.views[0].finalized[0] > 0,
            "aggregates_verified": self.aggregates_verified,
            "resident_head_equals_spec_walk": all(self.walk_checks),
            "walk_checks": len(self.walk_checks),
            "head_root": head.hex()[:16],
        }
        if self.n_groups > 1:
            out["n_groups"] = self.n_groups
            out["views"] = [{"justified_epoch": v.cur_just[0],
                             "finalized_epoch": v.finalized[0],
                             "head_root": self.view_heads[g].hex()[:16]}
                            for g, v in enumerate(self.views)]
        out["variant"] = self.variant.name
        if self.variant.name != "gasper":
            out["variant_decisions"] = len(self.variant.decisions)
            vs = self.variant.summary_fields(self)
            if vs:
                out["variant_state"] = vs
        if self.riders:
            out["workload"] = {r.kind: r.stats() for r in self.riders}
        if self.monitors or self.adversaries:
            out["monitor_violations"] = len(self.monitor_violations)
            out["violation_kinds"] = sorted({v["kind"] for v in self.monitor_violations})
        if self.phases.enabled:
            out["dense_phases"] = self.phases.summary()
        if self.flight is not None:
            out["device"] = self.flight.summary()
        return out

    # -- checkpoint / resume ---------------------------------------------------

    def checkpoint(self, path: str | None = None) -> bytes:
        """Every column read back to the host and serialized in the JAX
        package's dense checkpoint format (version 3): an 8-byte length,
        the JSON meta, then an npz of the columns. The chaos composition
        and every adversary's and monitor's mutable state ride along, so a
        resume mid-attack replays the same episode. ``path`` also writes
        the bytes to a file."""
        data = self._checkpoint_serialize(*self._checkpoint_capture())
        if path is not None:
            from pos_evolution_tpu_torch.utils.snapshot import atomic_write_bytes
            atomic_write_bytes(path, data)
        return data

    def _checkpoint_capture(self):
        """JSON-able meta plus host copies of every column. Everything is
        copied, never referenced: a CPU tensor's numpy view would change
        with the loop."""
        views_meta = []
        cols: dict[str, np.ndarray] = {}
        for g, view in enumerate(self.views):
            prefix = "" if g == 0 else f"g{g}_"
            for f in DenseRegistry._fields:
                cols[prefix + f] = to_numpy(getattr(view.registry, f))[: self.n].copy()
            for f in ("msg_block", "msg_epoch", "msg_slot"):
                cols[prefix + f] = to_numpy(getattr(view, f))[: self.n].copy()
            pend_meta = []
            for j, b in enumerate(view.pending):
                cols[f"v{g}_pend{j}_idx"] = np.flatnonzero(b.mask).astype(np.int64)
                pend_meta.append({"block": int(b.block), "epoch": int(b.epoch),
                                  "flag": b.flag, "faultable": bool(b.faultable),
                                  "slot": None if b.slot is None else int(b.slot)})
            views_meta.append({
                "bits": [bool(x) for x in view.bits],
                "prev_just": list(view.prev_just),
                "cur_just": list(view.cur_just),
                "finalized": list(view.finalized),
                "epoch_start_idx": {str(k): v for k, v in view.epoch_start_idx.items()},
                "vis": [bool(x) for x in view.vis_host[: len(self.roots)]],
                "pending": pend_meta,
            })
        chaos = None
        if self.fault_plan or self.adversaries or self.monitors:
            for i, adv in enumerate(self.adversaries):
                for name, arr in adv.state_arrays().items():
                    cols[f"adv{i}_{name}"] = np.array(arr, copy=True)
            for i, mon in enumerate(self.monitors):
                for name, arr in mon.state_arrays().items():
                    cols[f"mon{i}_{name}"] = np.array(arr, copy=True)
            chaos = {
                "faults": self.fault_plan.describe() if self.fault_plan else None,
                "adversaries": [{"config": a.describe(), "state": a.state_meta()}
                                for a in self.adversaries],
                "monitors": [{"config": m.describe(), "state": m.state_meta()}
                             for m in self.monitors],
            }
        for i, r in enumerate(self.riders):
            for name, arr in r.state_arrays().items():
                cols[f"rider{i}_{name}"] = np.array(arr, copy=True)
        meta = {
            "version": 3, "n": self.n, "seed": self.seed,
            "variant": self.variant.describe(),
            "variant_state": self.variant.state_meta(),
            "riders": [{"config": r.describe(), "state": r.state_meta()} for r in self.riders],
            "boost": [None if b is None else int(b) for b in self._boost],
            "shuffle_rounds": self.shuffle_rounds,
            "verify_aggregates": self.verify_aggregates,
            "capacity": self.capacity,
            "check_walk_every": self.check_walk_every,
            "n_groups": self.n_groups,
            "cfg": {k: (["__bytes__", v.hex()] if isinstance(v, bytes) else v)
                    for k, v in dataclasses.asdict(self.cfg).items()},
            "slot": self.slot,
            "views": views_meta,
            "pending_vis": [list(t) for t in self._pending_vis],
            "roots": [r.hex() for r in self.roots],
            "parents": list(self.parents),
            "block_slots": list(self.block_slots),
            "aggregates_verified": self.aggregates_verified,
            "walk_checks": [bool(b) for b in self.walk_checks],
            "view_heads": [h.hex() for h in self.view_heads],
            "metrics": [dict(m) for m in self.metrics],
            "epoch_ready": self._epoch_ready,
            "chaos": chaos,
            "monitor_violations": [dict(v) for v in self.monitor_violations],
        }
        if self._perm_host is not None:
            cols["perm"] = self._perm_host.copy()
        # the whole capture is one read-back, charged to its own site; the
        # memory watermark is taken while the device state and its host
        # copy are both live, the run's high-water point
        from pos_evolution_tpu_torch.telemetry import torchrt
        torchrt.record_transfer(_nbytes(cols), direction="d2h", site="checkpoint_capture")
        if self.flight is not None:
            self.flight.sample_memory(site="checkpoint", slot=self.slot)
        return meta, cols

    @staticmethod
    def _checkpoint_serialize(meta: dict, cols: dict) -> bytes:
        """The expensive half (json and npz compression): a pure function
        of the captured host copies, safe on a background thread."""
        out = io.BytesIO()
        head = json.dumps(meta).encode()
        out.write(np.uint64(len(head)).tobytes())
        out.write(head)
        _write_npz(out, cols)
        return out.getvalue()

    def _checkpoint_async_capture(self):
        """``RunSupervision``'s capture: gather now, on the loop (the host
        copies are frozen: every column is copied), and hand the writer
        thread a job that serializes them. ``last_capture`` records the
        raw column bytes and the gather's ms."""
        t0 = time.perf_counter()
        meta, cols = self._checkpoint_capture()
        self.last_capture = {"raw_bytes": _nbytes(cols),
                             "capture_ms": round((time.perf_counter() - t0) * 1e3, 3)}

        def job():
            t1 = time.perf_counter()
            data = self._checkpoint_serialize(meta, cols)
            self.phases.charge_async("checkpoint_serialize", time.perf_counter() - t1)
            return data
        return job

    @classmethod
    def resume(cls, data: bytes, *, device="cuda", plain: bool = False,
               expect_variant: str | None = None, phase_profile=None, telemetry=None,
               flight_recorder=None) -> DenseSimulation:
        """Rebuild a run from ``checkpoint`` bytes (written by this package
        or by the JAX package, format versions 1-3) on ``device``."""
        buf = io.BytesIO(data)
        (n_head,) = np.frombuffer(buf.read(8), dtype=np.uint64)
        meta = json.loads(buf.read(int(n_head)).decode())
        if meta["version"] not in (1, 2, 3):
            raise ValueError(f"unknown dense checkpoint version {meta['version']!r}")
        v1 = meta["version"] == 1
        ckpt_variant = (meta.get("variant") or {"kind": "gasper"})["kind"]
        if expect_variant is not None and ckpt_variant != expect_variant:
            raise ValueError(
                f"checkpoint was written under variant {ckpt_variant!r}, refusing to "
                f"resume it as {expect_variant!r}: the message-table semantics (expiry "
                f"stamps, per-slot gadget state) are not interchangeable across variants")
        cfg = Config(**{
            k: (bytes.fromhex(v[1])
                if isinstance(v, list) and len(v) == 2 and v[0] == "__bytes__" else v)
            for k, v in meta["cfg"].items()})
        chaos = None if v1 else meta.get("chaos")
        fault_plan, adversaries, monitors = None, [], []
        if chaos is not None:
            fault_plan = DenseFaultPlan.from_config(chaos.get("faults"))
            adversaries = [dense_adversary_from_config(a["config"])
                           for a in chaos.get("adversaries", [])]
            monitors = [dense_monitor_from_config(m["config"])
                        for m in chaos.get("monitors", [])]
        riders = [dense_rider_from_config(r["config"]) for r in meta.get("riders", [])]
        sim = cls(meta["n"], cfg=cfg, device=device, plain=plain, seed=meta["seed"],
                  shuffle_rounds=meta["shuffle_rounds"],
                  verify_aggregates=meta["verify_aggregates"], capacity=meta["capacity"],
                  check_walk_every=meta["check_walk_every"],
                  n_groups=meta.get("n_groups", 1), fault_plan=fault_plan,
                  adversaries=adversaries, monitors=monitors, phase_profile=phase_profile,
                  telemetry=telemetry, flight_recorder=flight_recorder,
                  variant=dense_variant_from_config(meta.get("variant")), riders=riders)
        views_meta = ([{
            "bits": meta["bits"], "prev_just": meta["prev_just"],
            "cur_just": meta["cur_just"], "finalized": meta["finalized"],
            "epoch_start_idx": meta["epoch_start_idx"], "vis": None, "pending": [],
        }] if v1 else meta["views"])
        with np.load(buf) as z:
            arrays = {k: z[k] for k in z.files}
        sim.roots = [bytes.fromhex(r) for r in meta["roots"]]
        sim.parents = list(meta["parents"])
        sim.block_slots = list(meta["block_slots"])
        b = len(sim.roots)
        sim._set_tree_columns()
        for g, (view, vm) in enumerate(zip(sim.views, views_meta)):
            prefix = "" if g == 0 else f"g{g}_"
            view.registry = DenseRegistry(**{f: sim._col(arrays[prefix + f])
                                             for f in DenseRegistry._fields})
            view.msg_block = sim._col(arrays[prefix + "msg_block"])
            view.msg_epoch = sim._col(arrays[prefix + "msg_epoch"])
            ms_key = prefix + "msg_slot"
            view.msg_slot = sim._col(arrays[ms_key] if ms_key in arrays
                                     else np.zeros(sim.n, np.int64))  # pre-v3: no stamps
            view.bits = np.asarray(vm["bits"], dtype=bool)
            view.prev_just = tuple(vm["prev_just"])
            view.cur_just = tuple(vm["cur_just"])
            view.finalized = tuple(vm["finalized"])
            view.epoch_start_idx = {int(k): v for k, v in vm["epoch_start_idx"].items()}
            vis = np.zeros(sim.capacity, dtype=bool)
            vis[:b] = True if vm["vis"] is None else np.asarray(vm["vis"], dtype=bool)
            view.vis_host = vis
            view.vis_d = sim._col(vis)
            view.pending = []
            for j, pm in enumerate(vm.get("pending", [])):
                mask = np.zeros(sim.n, dtype=bool)
                mask[arrays[f"v{g}_pend{j}_idx"]] = True
                pslot = pm.get("slot")
                view.pending.append(VoteBatch(
                    mask, int(pm["block"]), int(pm["epoch"]), views=(g,),
                    flag=pm.get("flag"), faultable=bool(pm.get("faultable", False)),
                    slot=None if pslot is None else int(pslot)))
        sim._pending_vis = [tuple(t) for t in meta.get("pending_vis", [])]
        sim.slot = meta["slot"]
        sim.aggregates_verified = meta["aggregates_verified"]
        sim.walk_checks = list(meta["walk_checks"])
        sim.view_heads = [bytes.fromhex(h) for h in meta.get("view_heads",
                                                             [""] * sim.n_groups)]
        sim.metrics = list(meta["metrics"])
        sim._epoch_ready = meta["epoch_ready"]
        sim.monitor_violations = list(meta.get("monitor_violations", []))
        if chaos is not None:
            for i, (adv, am) in enumerate(zip(sim.adversaries, chaos.get("adversaries", []))):
                adv.restore_state(am.get("state", {}), {
                    k[len(f"adv{i}_"):]: v for k, v in arrays.items()
                    if k.startswith(f"adv{i}_")})
            for i, (mon, mm) in enumerate(zip(sim.monitors, chaos.get("monitors", []))):
                mon.restore_state(mm.get("state", {}), {
                    k[len(f"mon{i}_"):]: v for k, v in arrays.items()
                    if k.startswith(f"mon{i}_")})
        sim.variant.restore_state(meta.get("variant_state", {}))
        for i, (r, rm) in enumerate(zip(sim.riders, meta.get("riders", []))):
            r.restore_state(rm.get("state", {}), {
                k[len(f"rider{i}_"):]: v for k, v in arrays.items()
                if k.startswith(f"rider{i}_")})
        boost = meta.get("boost")
        if boost is not None:
            sim._boost = [None if b is None else int(b) for b in boost]
        perm = arrays.get("perm")
        if perm is not None and sim._epoch_ready >= 0:
            sim._perm_host = perm.astype(np.int64)
            sim._inv_perm = np.argsort(sim._perm_host).astype(np.int64)
            sim._assigned_host = sim._perm_host * sim.S // sim.n
        return sim

    # -- run supervision ----------------------------------------------------------

    def attach_autocheckpoint(self, spec) -> None:
        """Arm (or re-arm, after a resume) run supervision; its merkle
        digests hash on this run's device."""
        from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend
        from pos_evolution_tpu_torch.resilience import RunSupervision
        self.supervision = RunSupervision(spec, kind="dense", cfg_obj=self.cfg,
                                          backend=TorchBackend(self.device))

    def finish_autocheckpoint(self) -> dict | None:
        """Final checkpoint at the current slot and a writer drain; returns
        the manager's overhead stats (None when unsupervised)."""
        if self.supervision is None:
            return None
        return self.supervision.finish(self.slot, self._checkpoint_async_capture)

    @classmethod
    def resume_latest(cls, dir, *, device="cuda", autocheckpoint=None,
                      expect_variant: str | None = None) -> DenseSimulation:
        """Resume from the newest valid checkpoint under ``dir`` on
        ``device``, quarantining and rolling past corrupt steps (a merkle
        step is re-checked through K2 on the card). Raises
        ``FileNotFoundError`` when nothing valid exists."""
        import os

        from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend
        from pos_evolution_tpu_torch.resilience import CheckpointManager
        from pos_evolution_tpu_torch.telemetry import emit_global
        dev = resolve_device(device)
        # no fingerprint pin: the dense checkpoint carries its own Config
        manager = CheckpointManager(dir, backend=TorchBackend(dev))
        found = manager.latest_valid()
        if found is None:
            raise FileNotFoundError(f"no valid checkpoint under {dir!r} to resume from")
        step, payloads = found
        sim = cls.resume(payloads["payload.bin"], device=dev, expect_variant=expect_variant)
        # the step resumed and its validation's digest records
        sim.resumed_from = {"step": step, "verify": list(manager.verify_log)}
        if autocheckpoint is not None:
            sim.attach_autocheckpoint(autocheckpoint)
        emit_global("run_resumed", step=step, slot=sim.slot, dir=os.fspath(dir))
        return sim


def main(argv=None) -> None:
    from pos_evolution_tpu_torch.resilience import state_digest
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20, help="validators")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shuffle-rounds", type=int, default=None,
                    help="default: the config's shuffle_round_count (90)")
    ap.add_argument("--phase-profile", type=int, default=8,
                    help="fence every N-th slot's phases (0: no phase budget)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plain", action="store_true",
                    help="the kernels' plain PyTorch versions")
    ap.add_argument("--riders", default="[]",
                    help="JSON list of rider configs, e.g. '[{\"kind\": \"das\", \"n_blobs\": 9}, "
                         "{\"kind\": \"lightclient\", \"n_clients\": 100000}]'")
    ap.add_argument("--das-cells", type=int, default=None,
                    help="data cells per blob, k (config das_cells_per_blob; PeerDAS: 64)")
    ap.add_argument("--das-cell-bytes", type=int, default=None,
                    help="bytes per cell (config das_cell_bytes; PeerDAS: 2048)")
    ap.add_argument("--das-max-blobs", type=int, default=None,
                    help="blobs per block (config das_max_blobs_per_block; EIP-7691: 9)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    geometry = {"das_cells_per_blob": args.das_cells, "das_cell_bytes": args.das_cell_bytes,
                "das_max_blobs_per_block": args.das_max_blobs}
    cfg = mainnet_config().replace(**{k: v for k, v in geometry.items() if v is not None})
    riders = [dense_rider_from_config(d) for d in json.loads(args.riders)]
    rounds = cfg.shuffle_round_count if args.shuffle_rounds is None else args.shuffle_rounds
    t0 = time.perf_counter()
    sim = DenseSimulation(args.n, cfg, device=dev, plain=args.plain, seed=args.seed,
                          shuffle_rounds=rounds, phase_profile=args.phase_profile or None,
                          riders=riders)
    t1 = time.perf_counter()
    sim.run_epochs(args.epochs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    out = sim.summary()
    out.update(state_digest=state_digest(sim), setup_seconds=t1 - t0,
               run_seconds=t2 - t1, seconds_per_epoch=(t2 - t1) * sim.S / sim.slot,
               device=card_line(dev))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
