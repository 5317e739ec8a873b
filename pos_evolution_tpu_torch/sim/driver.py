"""Round-based simulation driver (port of ``pos_evolution_tpu/sim/driver.py``):
the validator duty loop over per-view-group fork-choice stores, on the
port's backend.

Each slot (3 rounds):
  round 0 (propose):   the slot's proposer runs get_head on its view and
                       broadcasts a block
  round 1 (attest):    committee members attest to their view's head
                       (head vote + FFG vote)
  round 2 (aggregate): aggregation is implicit in the per-committee
                       aggregates

Validators whose messages arrive identically share one ``Store`` (a "view
group"): the ``Schedule`` induces the partition, so honest runs cost one
store and attack runs a handful.

A ``Simulation`` runs on one ``TorchBackend``: ``device=`` names its
device, and None takes the thread's backend (CUDA unless the caller set
another, raising without it). Every public entry (``run_slot``,
``run_until_slot``, ``run_epochs``, ``checkpoint``, ``resume``) runs
under it, so the spec layer's device calls (the epoch and block sweeps,
every state root through kernel K2 on a CUDA device) and the resident
fork-choice store (``ops/resident.py``) run there. The knobs of the JAX
package's driver that are not ported raise ``ValueError`` naming their
ROADMAP item: ``telemetry=``, ``profile=``, ``compile_cache=``,
``autocheckpoint=`` and ``resume_latest`` (item 7, the tooling);
``das=``, ``serve=``, ``attach_das_clients`` and ``attach_light_client``
(item 4c); a ``sharded=`` other than None or False goes to the backend,
which raises (item 3).

Run: ``python -m pos_evolution_tpu_torch.sim.driver [n] [--epochs E]
[--device cuda|cpu]``: 65,536 validators under ``mainnet_config()`` for 4
epochs with the resident fork choice by default; one JSON object, or an
exit with a message and no timings when a resident store degraded.
"""

from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass, field

import numpy as np

from pos_evolution_tpu_torch.backend import get_backend, use_backend
from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.sim.schedule import Schedule, honest_schedule
from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.specs.genesis import make_genesis
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
)
from pos_evolution_tpu_torch.specs.validator import (
    advance_state_to_slot,
    build_block,
    make_committee_attestation,
    make_sync_aggregate,
)
from pos_evolution_tpu_torch.ssz import cached_root, hash_tree_root

_ITEMS = {"3": "the multi-GPU mode", "4c": "the DAS, light-client and serving riders "
          "of the spec driver", "7": "the tooling"}


def _not_ported(what: str, item) -> ValueError:
    item = str(item)
    return ValueError(f"Simulation: {what} is not ported yet "
                      f"(ROADMAP Queue 1 item {item}, {_ITEMS[item]})")


def _backend_for(device):
    """The backend a ``Simulation`` runs on: the thread's for None, else
    a ``TorchBackend`` on ``device`` (raising where CUDA is asked for and
    absent)."""
    if device is None:
        return get_backend()
    from pos_evolution_tpu_torch.backend.torch_backend import TorchBackend
    return device if isinstance(device, TorchBackend) else TorchBackend(device)


@dataclass(order=True)
class _QueuedMessage:
    time: float
    seq: int
    kind: str = field(compare=False)     # "block" | "attestation" | "slashing"
    payload: object = field(compare=False)


class ViewGroup:
    """One equivalence class of validator views: a Store + a message queue
    + an attestation pool for proposals made from this view."""

    def __init__(self, group_id: int, store: fc.Store, members: np.ndarray,
                 resident=None):
        self.id = group_id
        self.store = store
        self.members = members
        # Crash-fault state (sim/faults.py CrashWindow): a crashed group
        # processes nothing and receives nothing until it rejoins via
        # weak-subjectivity checkpoint sync. Always recomputable from the
        # FaultPlan and the current slot (never serialized).
        self.crashed = False
        self.queue: list[_QueuedMessage] = []
        self.pool: dict[bytes, object] = {}  # attestation root -> Attestation
        # Attestation roots carried by each processed block (block root ->
        # [attestation roots]): proposers dedup against inclusion on the
        # CANONICAL chain only (a walk from their head), so fresh votes are
        # not starved by re-packed on-chain ones, and votes included only on
        # a losing fork stay packable on the winning one.
        self.block_atts: dict[bytes, list] = {}
        self._seq = 0
        # Device-resident dense mirror (ops/resident.py) when the sim runs
        # accelerated fork choice; handlers below forward their deltas.
        self.resident = resident
        # Protocol-variant overlay (variants/base.VariantVoteLog) when a
        # successor variant drives the run; mirrored on
        # ``store.variant_view`` so the handlers feed it.
        self.variant_view = None

    def enqueue(self, time: float, kind: str, payload) -> None:
        heapq.heappush(self.queue, _QueuedMessage(time, self._seq, kind, payload))
        self._seq += 1

    def _mirror_attestation(self, att, indices) -> None:
        if self.resident is not None and indices is not None:
            self.resident.note_attestation(
                indices, int(att.data.target.epoch),
                bytes(att.data.beacon_block_root))

    def _process_block(self, signed_block) -> None:
        """One ``on_block`` plus its carried attestations and the resident
        mirror — the gossip-delivery entry (backfilled ancestor runs go
        through ``_process_block_chain``)."""
        block_root = cached_root(signed_block.message)
        if block_root in self.store.blocks:
            # redelivery (FaultPlan duplicate_p, or a backfilled block
            # arriving again via gossip): reprocessing would re-run the
            # state transition AND append a duplicate row to the resident
            # mirror, splitting its vote weights
            return
        fc.on_block(self.store, signed_block)
        self._absorb_block(signed_block, block_root)

    def _process_block_chain(self, signed_blocks) -> None:
        """A parent-linked backfill run through ``fc.on_block_batch`` —
        one carried pre-state, one finalized-descent walk — then absorb
        each committed block's carried ops. A mid-run reject commits the
        prefix exactly like the sequential loop, so absorption walks the
        run until the first uncommitted block even when the batch raises."""
        pending = [sb for sb in signed_blocks
                   if cached_root(sb.message) not in self.store.blocks]
        if not pending:
            return
        try:
            fc.on_block_batch(self.store, pending)
        finally:
            for sb in pending:
                block_root = cached_root(sb.message)
                if block_root not in self.store.blocks:
                    break
                self._absorb_block(sb, block_root)

    def _absorb_block(self, signed_block, block_root: bytes) -> None:
        """Post-``on_block`` bookkeeping: resident-mirror row, block-carried
        attestations, and the carried-root index for op-pool dedup."""
        if self.resident is not None:
            self.resident.note_block(self.store, block_root)
        carried = []
        for att in signed_block.message.body.attestations:
            carried.append(cached_root(att))
            try:
                idx = fc.on_attestation(self.store, att, is_from_block=True)
                self._mirror_attestation(att, idx)
            except AssertionError:
                pass  # a carried attestation's reject drops that vote only
        self.block_atts[block_root] = carried

    def deliver_due(self, now: float, timer, resolver=None) -> None:
        track = timer.track
        while self.queue and self.queue[0].time <= now:
            msg = heapq.heappop(self.queue)
            try:
                if msg.kind == "block":
                    # block-carried attestations are part of on_block cost
                    with track("on_block"):
                        if resolver is not None:
                            resolver(self, msg.payload)
                        self._process_block(msg.payload)
                elif msg.kind == "attestation":
                    with track("on_attestation"):
                        idx = fc.on_attestation(self.store, msg.payload)
                        self._mirror_attestation(msg.payload, idx)
                    self.pool[cached_root(msg.payload)] = msg.payload
                elif msg.kind == "slashing":
                    with track("on_attester_slashing"):
                        evil = fc.on_attester_slashing(self.store, msg.payload)
                        if self.resident is not None:
                            self.resident.note_slashing(evil)
            except AssertionError:
                # Invalid-at-this-time messages are dropped (the reference
                # permits re-queueing; the driver keeps the simple policy).
                # Pre-anchor walks in a checkpoint-synced view land here too
                # via the handlers' own asserts.
                pass


class Simulation:
    """Round-based multi-validator simulation over a Schedule, on one
    backend (``device``: see the module docstring)."""

    def __init__(self, n_validators: int, schedule: Schedule | None = None,
                 genesis_time: int = 0, accelerated_forkchoice: bool = False,
                 telemetry=None, profile=None, adversaries=(), monitors=(),
                 das=None, prewarm: bool = False, compile_cache=None,
                 variant=None, sharded=None, autocheckpoint=None,
                 serve=None, device=None):
        for knob, value, item in (("telemetry=", telemetry, 7), ("profile=", profile, 7),
                                  ("compile_cache=", compile_cache, 7),
                                  ("autocheckpoint=", autocheckpoint, 7),
                                  ("das=", das, "4c"), ("serve=", serve, "4c")):
            if value is not None and value is not False:
                raise _not_ported(knob, item)
        self.backend = _backend_for(device)
        with use_backend(self.backend):
            self._init(n_validators, schedule, genesis_time, accelerated_forkchoice,
                       adversaries, monitors, prewarm, variant, sharded)

    def _init(self, n_validators, schedule, genesis_time, accelerated_forkchoice,
              adversaries, monitors, prewarm, variant, sharded) -> None:
        self.cfg = cfg()
        self.schedule = schedule or honest_schedule(n_validators)
        self.n_validators = n_validators
        self.genesis_time = genesis_time
        # Sharded execution is item 3: None and False change nothing; any
        # other value goes to the backend, which raises.
        self.sharded = None
        if sharded is not None and sharded is not False:
            self.backend.enable_sharded(sharded)
        # Not simulation state here: the JAX package's event bus (item 7).
        self.telemetry = None
        if self.schedule.faults is not None:
            self.schedule.faults.sink = None
        state, anchor = make_genesis(n_validators, genesis_time)
        self.genesis_state = state
        self.anchor_root = hash_tree_root(anchor)
        # Protocol variant (variants/): the fork-choice + finality rules the
        # driver dispatches through. GasperVariant is the plain driver;
        # Goldfish / RLMD-GHOST / SSF attach per-view vote overlays to every
        # store. Like the schedule, the variant is passed again to
        # ``resume`` (or rebuilt from the checkpoint's describe()).
        if variant is None:
            from pos_evolution_tpu_torch.variants import GasperVariant
            variant = GasperVariant()
        self.variant = variant
        self.variant.bind(self)
        if prewarm and self.backend.device.type == "cuda":
            # the block sweep's first launch (CUDA context, allocator
            # pools) before the first block, on the card only
            from pos_evolution_tpu_torch.ops.transition import prewarm_block_sweep
            prewarm_block_sweep(state)
        # One PoW-chain view per Simulation (shared by its groups — the PoW
        # chain is objective): merge-transition state never leaks between
        # Simulation instances in the same process.
        from pos_evolution_tpu_torch.specs.merge import PowChainView
        self.pow_chain = PowChainView()

        def _make_group(g):
            store = fc.get_forkchoice_store(state, anchor,
                                            pow_chain=self.pow_chain)
            resident = None
            if accelerated_forkchoice:
                from pos_evolution_tpu_torch.ops.resident import ResidentForkChoice
                resident = ResidentForkChoice(store)
            group = ViewGroup(g, store, self.schedule.members(g), resident)
            if self.variant.needs_view:
                view = self.variant.make_view(g)
                group.variant_view = view
                store.variant_view = view
            return group

        self.groups = [_make_group(g) for g in range(self.schedule.n_groups)]
        self.slot = 0
        self.metrics: list[dict] = []
        # Every block ever broadcast, by root — the "some peer has it"
        # pool backing block-by-root req/resp sync (``_sync_ancestors``).
        # Without a catch-up path one dropped block would fork a view
        # permanently; real clients re-fetch missing parents.
        self.block_archive: dict[bytes, object] = {}
        # Device fork choice: every head query runs on the persistent
        # device store (ops/resident.py) — incremental bucket updates as
        # messages arrive, one head_from_buckets per fresh query.
        self.accelerated_forkchoice = accelerated_forkchoice
        # Per-handler tracing: wall-clock p50/p95 for get_head / on_block /
        # on_attestation via utils.metrics.
        from pos_evolution_tpu_torch.utils.metrics import HandlerTimer
        self.timer = HandlerTimer()
        # In-loop adversary engine + online property monitors
        # (sim/adversary.py, sim/monitors.py). Neither is simulation
        # state: like the schedule, pass them again to ``resume``.
        self.adversaries = list(adversaries)
        self.monitors = list(monitors)
        self.monitor_violations: list[dict] = []
        self._bind_adversaries_and_monitors()

    def _get_head(self, group: ViewGroup) -> bytes:
        with self.timer.track("get_head"):
            # GasperVariant answers from the resident mirror / spec walk;
            # successor variants run their expiry-windowed rules
            return self.variant.head(self, group)

    def trace_summary(self) -> dict:
        """Per-handler timing percentiles for this run."""
        return self.timer.summary()

    # -- adversary engine + monitors (sim/adversary.py, sim/monitors.py) -------

    def _bind_adversaries_and_monitors(self) -> None:
        """Fold controlled validators into the schedule's corrupted set
        (the honest duty loop must never act for them) and hand each
        strategy/monitor its simulation handle."""
        for strat in self.adversaries:
            self.schedule.corrupted.update(strat.controlled)
            strat.bind(self)
        for mon in self.monitors:
            mon.bind(self)

    def _adversary_phase(self, phase: str, slot: int, now: float) -> None:
        """Run one hook round: every strategy acts, then anything it
        injected for immediate delivery is flushed — so honest duties
        that follow see the adversarial messages."""
        if not self.adversaries:
            return
        from pos_evolution_tpu_torch.sim.adversary import AdversaryContext
        ctx = AdversaryContext(self, slot, phase, now)
        for strat in self.adversaries:
            getattr(strat, phase)(ctx)
        self._tick_all(now)

    def _observe(self, kind: str, payload) -> None:
        """Show one ORIGINATED message (honest or adversarial, before any
        fault decision) to every monitor — the watchtower's wire tap."""
        for mon in self.monitors:
            mon.observe(kind, payload)

    def _run_monitors(self, slot: int) -> None:
        for mon in self.monitors:
            for violation in mon.on_slot_end(self, slot):
                self.monitor_violations.append({"slot": slot, **violation})

    # -- time helpers --
    def slot_start(self, slot: int) -> int:
        return slot * self.cfg.seconds_per_slot

    @property
    def delta(self) -> int:
        return self.cfg.seconds_per_slot // self.cfg.intervals_per_slot

    def _tick_all(self, time: float) -> None:
        for g in self.groups:
            if g.crashed:
                continue
            fc.on_tick(g.store, int(time))
            g.deliver_due(time, timer=self.timer,
                          resolver=self._sync_ancestors)

    def _sync_ancestors(self, dst: ViewGroup, signed_block) -> None:
        """Block-by-root backfill (the req/resp sync of real clients):
        when a gossiped block's ancestry is missing from ``dst``'s view,
        pull the gap from the archive and process oldest-first. A dropped
        block becomes a delayed one the moment any descendant arrives, and
        a checkpoint-synced rejoiner catches up from its anchor the same
        way. Deterministic (the archive is checkpointed state)."""
        missing = []
        parent = bytes(signed_block.message.parent_root)
        while parent not in dst.store.blocks:
            sb = self.block_archive.get(parent)
            if sb is None:
                return  # unconnectable (pre-anchor history): let on_block fail
            missing.append(sb)
            parent = bytes(sb.message.parent_root)
        dst._process_block_chain(list(reversed(missing)))

    # -- fault layer (sim/faults.py) -------------------------------------------

    def _send(self, dst: ViewGroup, base_time: float, delay: float | None,
              kind: str, payload, slot: int, src: int, msg_id: int) -> None:
        """Deliver one message copy-set to ``dst``, routed through the
        ``FaultPlan`` (drop / duplicate / reorder) when one is attached.
        Crashed groups receive nothing."""
        if delay is None or dst.crashed:
            return
        t = base_time + delay
        plan = self.schedule.faults
        if plan is None:
            dst.enqueue(t, kind, payload)
            return
        for extra in plan.delivery_offsets(kind, slot, src, msg_id, dst.id, t):
            dst.enqueue(t + extra, kind, payload)

    def _apply_fault_transitions(self, slot: int) -> None:
        """Crash / rejoin view groups at slot boundaries per the plan's
        ``CrashWindow``s. Crash state is a pure function of the slot, so a
        checkpoint taken mid-outage resumes into the same state."""
        plan = self.schedule.faults
        if plan is None or not plan.crashes:
            return
        for g in self.groups:
            down = plan.crashed(g.id, slot)
            if down and not g.crashed:
                g.crashed = True
                # the process died: in-flight messages and the op pool go
                # with it
                g.queue.clear()
                g.pool.clear()
                g.block_atts.clear()
            elif g.crashed and not down:
                self._rejoin_group(g, slot)

    def _rejoin_group(self, group: ViewGroup, slot: int) -> None:
        """Checkpoint sync: the restarted group boots from a live peer's
        JUSTIFIED checkpoint (``utils/snapshot.save_anchor`` and
        ``resume_store``) after passing the weak-subjectivity gate. History
        before the checkpoint is gone; blocks since it arrive via
        ``_sync_ancestors`` backfill. The anchor must be a checkpoint,
        never a raw head: store init marks the anchor justified at its own
        epoch, and a head would claim a justification the chain never
        reached, freezing the synced store at its anchor."""
        from pos_evolution_tpu_torch.specs.weak_subjectivity import (
            checkpoint_for_state,
            is_within_weak_subjectivity_period,
        )
        from pos_evolution_tpu_torch.utils.snapshot import (
            load_anchor,
            resume_store,
            save_anchor,
        )
        donors = [g for g in self.groups if g is not group and not g.crashed]
        if not donors:
            raise RuntimeError("crash-restart: no live peer to sync from")
        donor = donors[0].store
        jroot = bytes(donor.justified_checkpoint.root)
        snap = save_anchor(donor.block_states[jroot], donor.blocks[jroot])
        store = resume_store(snap, pow_chain=self.pow_chain)
        fc.on_tick(store, self.slot_start(slot))
        ws_state, ws_checkpoint = checkpoint_for_state(load_anchor(snap)[0])
        if not is_within_weak_subjectivity_period(store, ws_state,
                                                  ws_checkpoint):
            raise RuntimeError(
                "crash-restart: checkpoint outside the weak-subjectivity "
                "period — a rejoin would be vulnerable to long-range forks")
        group.store = store
        group.queue.clear()
        group.pool.clear()
        group.block_atts = {}
        group.crashed = False
        if group.resident is not None:
            from pos_evolution_tpu_torch.ops.resident import ResidentForkChoice
            group.resident = ResidentForkChoice(store)
        if self.variant.needs_view:
            # the process died and its variant overlay with it; the synced
            # store gets a fresh one
            self.variant.reset_view(group)

    # -- duties --
    def _head_state(self, group: ViewGroup, slot: int):
        head = self._get_head(group)
        return head, advance_state_to_slot(group.store.block_states[head], slot)

    def _propose(self, slot: int) -> None:
        t0 = self.slot_start(slot)
        proposed: set[int] = set()
        for group in self.groups:
            if group.crashed:
                continue  # its members' processes are down
            head, head_state = self._head_state(group, slot)
            proposer = get_beacon_proposer_index(head_state)
            if proposer in proposed:
                continue
            if proposer not in set(int(v) for v in group.members):
                continue
            if int(proposer) in self.schedule.corrupted:
                continue  # Byzantine proposers act via attack scripts
            round_index = slot * self.cfg.intervals_per_slot
            if not self.schedule.awake(round_index, int(proposer)):
                continue
            proposed.add(proposer)
            atts = self._pack_attestations(group, slot, head,
                                           head_state=head_state)
            sync_agg = self._make_sync_aggregate(group, slot, head,
                                                 head_state, round_index)
            graffiti = b"\x00" * 32
            try:
                sb = build_block(group.store.block_states[head], slot,
                                 attestations=atts, sync_aggregate=sync_agg,
                                 graffiti=graffiti)
            except AssertionError:
                # Rare fault-era residue: an attestation that passed the
                # cheap packing filter is still unincludable. A real
                # proposer drops the op, not the proposal.
                sb = build_block(group.store.block_states[head], slot,
                                 attestations=[], sync_aggregate=sync_agg,
                                 graffiti=graffiti)
            block_root = cached_root(sb.message)
            self.block_archive[block_root] = sb
            self._observe("block", sb)
            for dst in self.groups:
                delay = self.schedule.block_delay(int(proposer), slot, dst.id)
                self._send(dst, t0, delay, "block", sb, slot,
                           src=int(proposer), msg_id=0)

    def _make_sync_aggregate(self, group: ViewGroup, slot: int, head: bytes,
                             head_state, round_index: int):
        """Sync-committee duty at proposal time: the committee members the
        proposer's view group can reach — honest and awake this round —
        sign the head the block builds on."""
        honest = self.schedule.honest_members(group.id)
        participants = set(int(v) for v in honest
                           if self.schedule.awake(round_index, int(v)))
        if not participants:
            return None
        return make_sync_aggregate(head_state, head, participants=participants)

    def _includable(self, state, att) -> bool:
        """Cheap op-pool validity filter mirroring process_attestation's
        asserts that can fail for a STALE pool entry under faults: target
        epoch outside the state's window, an FFG source that no longer
        matches the proposal state's justified checkpoint, a committee
        index out of range, or a committee size mismatch."""
        from pos_evolution_tpu_torch.specs.helpers import (
            get_beacon_committee,
            get_current_epoch,
            get_previous_epoch,
        )
        data = att.data
        target_epoch = int(data.target.epoch)
        if target_epoch not in (get_previous_epoch(state),
                                get_current_epoch(state)):
            return False
        if int(data.index) >= get_committee_count_per_slot(state,
                                                           target_epoch):
            return False
        expected = (state.current_justified_checkpoint
                    if target_epoch == get_current_epoch(state)
                    else state.previous_justified_checkpoint)
        if (int(data.source.epoch) != int(expected.epoch)
                or bytes(data.source.root) != bytes(expected.root)):
            return False
        try:
            committee = get_beacon_committee(state, int(data.slot),
                                             int(data.index))
        except (AssertionError, IndexError):
            return False
        return np.asarray(att.aggregation_bits).shape[0] == committee.shape[0]

    def _pack_attestations(self, group: ViewGroup, slot: int,
                           head: bytes, head_state=None) -> list:
        c = self.cfg
        # inclusion set of the proposer's CANONICAL chain, within the
        # attestation window
        onchain: set[bytes] = set()
        b = head
        while b in group.store.blocks:
            blk = group.store.blocks[b]
            if int(blk.slot) + c.slots_per_epoch < slot:
                break
            onchain.update(group.block_atts.get(b, ()))
            b = bytes(blk.parent_root)
        out = []
        expired = []
        for root, att in group.pool.items():
            a_slot = int(att.data.slot)
            if slot > a_slot + c.slots_per_epoch:
                expired.append(root)           # prune: bounds the pool
                continue
            if a_slot + c.min_attestation_inclusion_delay > slot:
                continue
            if root in onchain:
                continue                       # already on this chain
            if len(out) < c.max_attestations:
                # validity filter LAST, only for entries actually packed
                if head_state is None or self._includable(head_state, att):
                    out.append(att)
        for root in expired:
            del group.pool[root]
        return out

    def _attest(self, slot: int) -> None:
        t_next = self.slot_start(slot + 1)
        for group in self.groups:
            if group.crashed:
                continue
            head, head_state = self._head_state(group, slot)
            honest = set(int(v) for v in self.schedule.honest_members(group.id))
            if not honest:
                continue
            round_index = slot * self.cfg.intervals_per_slot + 1
            awake = set(v for v in honest if self.schedule.awake(round_index, v))
            if not awake:
                continue
            count = get_committee_count_per_slot(head_state, compute_epoch_at_slot(slot))
            for index in range(count):
                try:
                    att = make_committee_attestation(
                        head_state, slot, index, head,
                        participants=np.array(sorted(awake), dtype=np.int64))
                except ValueError:
                    continue  # no awake member in this committee
                self._observe("attestation", att)
                for dst in self.groups:
                    delay = self.schedule.attestation_delay(group.id, slot, dst.id)
                    self._send(dst, t_next, delay, "attestation", att, slot,
                               src=group.id, msg_id=index)

    # -- main loop --
    def run_slot(self) -> None:
        with use_backend(self.backend):
            self._run_slot()

    def _run_slot(self) -> None:
        slot = self.slot
        t0 = self.slot_start(slot)
        self._apply_fault_transitions(slot)
        self._tick_all(t0)
        # Variant merge phase: the previous slot's votes just crossed the
        # boundary tick — fold view buffers and process the completed vote
        # round (fast confirmation, per-slot FFG) before any of this slot's
        # head queries.
        self.variant.on_slot_start(self, slot)
        if slot > 0:
            self._adversary_phase("before_propose", slot, t0)
            self._propose(slot)
            self._tick_all(t0 + 1)  # timely blocks land within the boost window
            self._tick_all(t0 + self.delta)
            self._adversary_phase("before_attest", slot, t0 + self.delta)
            self._attest(slot)
            self._tick_all(t0 + 2 * self.delta)
            self._adversary_phase("after_attest", slot, t0 + 2 * self.delta)
        self.variant.on_slot_end(self, slot)
        self._record_metrics(slot)
        self._run_monitors(slot)
        self.slot += 1

    def run_until_slot(self, slot: int) -> None:
        with use_backend(self.backend):
            while self.slot <= slot:
                self._run_slot()

    def run_epochs(self, n_epochs: int) -> None:
        self.run_until_slot(n_epochs * self.cfg.slots_per_epoch)

    # -- observability (structured per-slot log) --
    def _record_metrics(self, slot: int) -> None:
        """One ``utils.metrics.slot_record`` per slot from group 0's head,
        plus the legacy ``head`` key (8-hex prefix); JSON-round-trippable
        for ``checkpoint()``/``resume()``."""
        from pos_evolution_tpu_torch.utils.metrics import slot_record
        group = self.groups[0]
        head = self._get_head(group)
        rec = slot_record(group.store, slot, head=head)
        rec["head"] = rec["head_root"][:8]
        self.metrics.append(rec)

    # -- riders not ported (item 4c) --------------------------------------------

    def attach_light_client(self, group: int = 0):
        raise _not_ported("attach_light_client", "4c")

    def attach_das_clients(self, *args, **kwargs):
        raise _not_ported("attach_das_clients", "4c")

    # -- whole-simulation checkpoint / resume ----------------------------------
    def checkpoint(self) -> bytes:
        """Serialize the ENTIRE simulation — every view group's store,
        message queue, attestation pool and inclusion index, plus the slot
        cursor and per-slot metrics — such that ``Simulation.resume``
        continues the run bit-identically. The bytes are the JAX
        package's format: either package resumes the other's."""
        from pos_evolution_tpu_torch.utils.snapshot import save_simulation
        with use_backend(self.backend):
            return save_simulation(self)

    @classmethod
    def resume(cls, data: bytes, schedule: Schedule | None = None,
               telemetry=None, adversaries=(), monitors=(),
               das=None, variant=None, sharded=None, device=None) -> "Simulation":
        """Rebuild a checkpointed simulation mid-run on ``device`` (the
        thread backend's when None). ``schedule`` must be the same
        delivery/fault policy the original run used (schedules hold
        callables, which do not serialize); None resumes an honest
        synchronous run. ``adversaries``/``monitors`` re-attach strategy
        and monitor instances; ``variant`` re-attaches a ProtocolVariant
        (None rebuilds one from the checkpoint's fingerprint).
        ``telemetry`` and ``das`` raise (items 7 and 4c)."""
        from pos_evolution_tpu_torch.utils.snapshot import load_simulation
        backend = _backend_for(device)
        with use_backend(backend):
            return load_simulation(data, schedule=schedule, telemetry=telemetry,
                                   adversaries=adversaries, monitors=monitors,
                                   das=das, variant=variant, sharded=sharded,
                                   device=backend)

    # -- run supervision (item 7) ----------------------------------------------

    def attach_autocheckpoint(self, spec) -> None:
        raise _not_ported("autocheckpoint", 7)

    @classmethod
    def resume_latest(cls, dir, *args, **kwargs) -> "Simulation":
        raise _not_ported("resume_latest", 7)

    # -- accessors --
    def store(self, group: int = 0) -> fc.Store:
        return self.groups[group].store

    def finalized_epoch(self, group: int = 0) -> int:
        return int(self.groups[group].store.finalized_checkpoint.epoch)

    def justified_epoch(self, group: int = 0) -> int:
        return int(self.groups[group].store.justified_checkpoint.epoch)


# --- the entry point ----------------------------------------------------------


def run_scale(n: int = 65_536, epochs: int = 4, device="cuda", on_epoch=None) -> dict:
    """``Simulation(n, accelerated_forkchoice=True)`` under the active
    config for ``epochs`` epochs on ``device`` -> the summary the entry
    point prints: set-up and per-epoch seconds, justified and finalized
    epochs, the resident head against the spec walk, the resident stores'
    degradation, the handler percentiles after the first epoch (its
    samples hold the first launches and capacity growth), K2 launches a
    state root, the run's head queries and each resident store's counts
    of fresh device queries, memo answers, flushes and rebuilds.
    ``on_epoch(e, sim)`` runs after each epoch."""
    import torch

    from pos_evolution_tpu_torch.ops import forkchoice as ofc
    from pos_evolution_tpu_torch.ops import kernels
    from pos_evolution_tpu_torch.ssz import incremental

    backend = _backend_for(device)
    sync = (torch.cuda.synchronize if backend.device.type == "cuda" else (lambda: None))
    roots0 = incremental.stats()["htr_calls"]
    k2_0 = kernels.launches.get("merkle_level", 0)
    t0 = _time.perf_counter()
    sim = Simulation(n, accelerated_forkchoice=True, device=backend)
    sync()
    init_s = _time.perf_counter() - t0
    per_epoch = []
    head_queries = 0
    for e in range(1, epochs + 1):
        te = _time.perf_counter()
        sim.run_epochs(e)
        sync()
        per_epoch.append(_time.perf_counter() - te)
        if e == 1:
            head_queries += len(sim.timer.samples.get("get_head", ()))
            sim.timer.reset()
        if on_epoch is not None:
            on_epoch(e, sim)
    group = sim.groups[0]
    with use_backend(sim.backend):
        spec_head = fc.get_head(group.store)
        host_head = ofc.get_head_host(group.store)
        resident_head = sim._get_head(group)
    summary_after_first = sim.trace_summary()
    head_queries += summary_after_first.get("get_head", {}).get("count", 0)
    roots = incremental.stats()["htr_calls"] - roots0
    k2 = kernels.launches.get("merkle_level", 0) - k2_0
    return {
        "n_validators": n, "epochs": epochs, "device": str(backend.device),
        "init_s": init_s, "per_epoch_s": per_epoch,
        "justified_epoch": sim.justified_epoch(), "finalized_epoch": sim.finalized_epoch(),
        "resident_head_equals_spec_walk": resident_head == spec_head,
        "resident_head_equals_host_walk": resident_head == host_head,
        "degraded": [g.resident.degraded for g in sim.groups],
        "incidents": [list(g.resident.incidents) for g in sim.groups],
        "resident_stats": [dict(g.resident.stats) for g in sim.groups],
        "head_queries": head_queries,
        "handler_timers_after_first_epoch": summary_after_first,
        "state_roots": roots, "k2_launches": k2,
        "k2_launches_per_state_root": (k2 / roots) if roots else 0.0,
        "head_root": sim.metrics[-1]["head_root"], "n_blocks": sim.metrics[-1]["n_blocks"],
        "sim": sim,
    }


def main(argv=None) -> None:
    import argparse
    import json
    import sys

    from pos_evolution_tpu_torch.config import mainnet_config, use_config
    from pos_evolution_tpu_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=65_536)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def progress(e, sim):
        m = sim.metrics[-1]
        print(f"# epoch {e}: justified={m['justified_epoch']} "
              f"finalized={m['finalized_epoch']} blocks={m['n_blocks']}", file=sys.stderr)

    with use_config(mainnet_config()):
        out = run_scale(args.n, args.epochs, device=dev, on_epoch=progress)
    out.pop("sim")
    if any(out["degraded"]) or any(out["incidents"]):
        # the store answered from the host spec walk: the times are not the device path's
        raise SystemExit(f"resident fork choice degraded {out['degraded']}: {out['incidents']}")
    out["card"] = card_line(dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
