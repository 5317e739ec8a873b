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
fork-choice store (``ops/resident.py``) run there.

``telemetry=`` (a ``telemetry.Telemetry``) gets the JAX driver's events:
the message lifecycle spans (``propose``, ``attest``, ``gossip``,
``deliver``), ``handler``, ``slot``, ``crash`` and ``rejoin``,
``monitor``, ``variant``, ``merkleization`` (this package's own counters),
and the riders' ``das_attach``, ``das_serve`` and ``light_client_lag``;
its registry gets the handler, DAS-server and ``BlobStore`` counters;
its ``debug`` flag arms ``StoreInvariantChecker`` around every handler
call. ``autocheckpoint=`` (or ``attach_autocheckpoint``) arms run
supervision (``resilience.RunSupervision``: heartbeats, integrity
audits, checkpoints every N slots, serialized on the loop, digested and
written on the manager's writer thread, through K2 on the card);
``resume_latest`` resumes from the newest valid step. The knobs of the
JAX package's driver that are not ported raise ``ValueError`` naming
their ROADMAP item: ``profile=`` and ``compile_cache=`` (item 7b, the
profiling tooling); ``serve=`` (item 4d, the serving tier); a
``sharded=`` other than None or False goes to the backend, which raises
(item 3).

The riders are the JAX package's. ``das=`` (True, a scheme name, or a
``das/engine.BlobEngine``; ``blob_engine_for``) makes proposals carry
blob sidecars, sent before their block, and gives every view a
``BlobStore`` on ``store.blob_store`` that gates ``on_block`` on verified
sidecars; a missing sidecar is pulled from the archive at import
(``_resolve_blobs``). ``attach_das_clients`` serves a sampling population
from a group's head through the copied ``das/server.DasServer`` at the end
of every slot; ``attach_light_client`` bootstraps a copied
``lightclient/node.LightClientNode`` served one update a slot, and
``flush_light_clients`` serves the off-chain finality update of the head.
The engine, the population and the server run under the config the
``Simulation`` was built under (``cfg``): the copied server reads the
thread's config, so the caller runs the simulation under it. ``meter``
(``RiderMeter``) keeps the riders' seconds and kernel launches by phase.

Run: ``python -m pos_evolution_tpu_torch.sim.driver [n] [--epochs E]
[--device cuda|cpu] [--das merkle|kzg] [--das-clients N]
[--light-clients L]``: 65,536 validators under ``mainnet_config()`` for 4
epochs with the resident fork choice by default (``--das`` also applies
the PeerDAS geometry, ``PEERDAS``); one JSON object, or an exit with a
message and no timings when a resident store degraded.
"""

from __future__ import annotations

import heapq
import time as _time
from contextlib import contextmanager, nullcontext
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

_ITEMS = {"3": "the multi-GPU mode", "4d": "the serving tier of the spec driver",
          "7b": "the profiling tooling"}

#: The PeerDAS blob geometry, applied over ``mainnet_config()`` (whose 8
#: samples a client it keeps): EIP-7594's 128 extended cells of 2,048 bytes
#: (64 data cells a blob) and EIP-7691's 9 blobs a block.
PEERDAS = {"das_cells_per_blob": 64, "das_cell_bytes": 2048, "das_max_blobs_per_block": 9}


def _not_ported(what: str, item) -> ValueError:
    item = str(item)
    return ValueError(f"Simulation: {what} is not ported yet "
                      f"(ROADMAP Queue 1 item {item}, {_ITEMS[item]})")


def blob_engine_for(das, cfg, device):
    """The ``BlobEngine`` a ``Simulation(das=...)`` runs: ``das`` itself
    when it is one (its geometry must be ``cfg``'s), else the default
    engine (seed 0) under ``cfg`` on ``device`` with the scheme ``das``
    names (True: merkle)."""
    from pos_evolution_tpu_torch.das import BlobEngine
    if isinstance(das, BlobEngine):
        keys = ("das_cells_per_blob", "das_cell_bytes", "das_max_blobs_per_block")
        if any(getattr(das.cfg, k) != getattr(cfg, k) for k in keys):
            raise ValueError("Simulation(das=engine): the engine's DAS geometry "
                             f"{[getattr(das.cfg, k) for k in keys]} is not the run's "
                             f"{[getattr(cfg, k) for k in keys]}")
        return das
    return BlobEngine(cfg, scheme="merkle" if das is True else das, device=device)


class RiderMeter:
    """Seconds, calls and kernel launches (``ops/kernels.launches``
    deltas) of the riders' work, by phase: ``blob_build`` (a proposal's
    grids, commitments and sidecars), ``sidecar_ingest`` (a view's
    verification of one sidecar, delivered or backfilled),
    ``das_serve`` (one served block), ``lc_bootstrap`` (one light client's
    bootstrap), ``lc_best_update`` (the serving group's update, built or
    from the cache, and the flush's head update) and ``lc_update`` (one
    light client's update). Each phase's work reads its results to the host, so
    the host clock covers its device work. ``rejected_sidecars`` counts the
    sidecars a view's store refused."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.launches: dict[str, dict[str, int]] = {}
        self.rejected_sidecars = 0

    @contextmanager
    def phase(self, name: str):
        from pos_evolution_tpu_torch.ops import kernels
        k0 = dict(kernels.launches)
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + _time.perf_counter() - t0
            self.calls[name] = self.calls.get(name, 0) + 1
            acc = self.launches.setdefault(name, {})
            for k, v in kernels.launches.items():
                if v != k0.get(k, 0):
                    acc[k] = acc.get(k, 0) + v - k0.get(k, 0)

    def per_call(self, name: str) -> dict[str, float]:
        """Launches of each kernel per call of phase ``name``."""
        n = self.calls.get(name, 0)
        return {k: v / n for k, v in self.launches.get(name, {}).items()} if n else {}


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
    kind: str = field(compare=False)     # "block" | "attestation" | "slashing" | "blob"
    payload: object = field(compare=False)
    # telemetry lineage: the gossip-edge span this copy belongs to (None
    # when telemetry is off or after resume: spans are not sim state)
    span: str | None = field(compare=False, default=None)


def _span_id(kind: str, slot: int, src: int, msg_id: int) -> str:
    """Deterministic message-span identity: the same run always names the
    same spans. Honest proposals use msg_id 0; an adversarial double
    proposal needs the msg_id suffix to keep the two blocks' spans apart."""
    if kind == "block":
        return f"blk-{slot}-{src}" if msg_id == 0 else f"blk-{slot}-{src}-{msg_id}"
    if kind == "attestation":
        return f"att-{slot}-g{src}-c{msg_id}"
    return f"{kind}-{slot}-{src}-{msg_id}"


_HANDLER_OF = {"block": "on_block", "attestation": "on_attestation",
               "slashing": "on_attester_slashing", "blob": "on_blob_sidecar"}


class ViewGroup:
    """One equivalence class of validator views: a Store + a message queue
    + an attestation pool for proposals made from this view."""

    def __init__(self, group_id: int, store: fc.Store, members: np.ndarray,
                 resident=None, telemetry=None):
        self.id = group_id
        self.store = store
        self.members = members
        # Telemetry: every delivery emits a lifecycle event; with its debug
        # flag every handler call runs under the StoreInvariantChecker (a
        # failed handler must not mutate the store).
        self.telemetry = telemetry
        self.invariants = None
        if telemetry is not None and telemetry.debug:
            from pos_evolution_tpu_torch.utils.metrics import StoreInvariantChecker
            self.invariants = StoreInvariantChecker(store)
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
        # DAS availability view (das/engine.BlobStore) when the sim runs a
        # blob workload; also attached to ``store.blob_store`` so on_block
        # gates imports on verified sidecars.
        self.blob_store = None
        # the simulation's RiderMeter when it runs a blob workload
        self.meter = None
        # Protocol-variant overlay (variants/base.VariantVoteLog) when a
        # successor variant drives the run; mirrored on
        # ``store.variant_view`` so the handlers feed it.
        self.variant_view = None

    def enqueue(self, time: float, kind: str, payload, span: str | None = None) -> None:
        heapq.heappush(self.queue, _QueuedMessage(time, self._seq, kind, payload, span))
        self._seq += 1

    def _call_handler(self, handler, *args, **kwargs):
        """One fork-choice handler call, through the debug-gated
        ``StoreInvariantChecker``; a violation (a failed handler that
        mutated the store) is emitted before the assertion reaches the
        caller's drop policy."""
        if self.invariants is None:
            return handler(self.store, *args, **kwargs)
        n0 = len(self.invariants.violations)
        try:
            return self.invariants.call(handler, *args, **kwargs)
        except AssertionError:
            if len(self.invariants.violations) > n0:
                self.telemetry.bus.emit(
                    "invariant_violation", group=self.id,
                    handler=getattr(handler, "__name__", str(handler)),
                    detail=self.invariants.violations[-1])
            raise

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
        self._call_handler(fc.on_block, signed_block)
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
            self._call_handler(fc.on_block_batch, pending)
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
                idx = self._call_handler(fc.on_attestation, att, is_from_block=True)
                self._mirror_attestation(att, idx)
            except AssertionError:
                # a carried attestation's reject drops that vote only; it
                # is counted, not an event each
                if self.telemetry is not None:
                    self.telemetry.registry.counter(
                        "carried_attestation_rejects_total",
                        "on_attestation(is_from_block=True) asserts",
                    ).inc(group=self.id)
        self.block_atts[block_root] = carried

    def deliver_due(self, now: float, timer, resolver=None) -> None:
        track = timer.track
        bus = self.telemetry.bus if self.telemetry is not None else None
        while self.queue and self.queue[0].time <= now:
            msg = heapq.heappop(self.queue)
            t0 = _time.perf_counter()
            status, reason = "accept", None
            try:
                if msg.kind == "block":
                    # block-carried attestations are part of on_block cost
                    with track("on_block"):
                        if resolver is not None:
                            resolver(self, msg.payload)
                        self._process_block(msg.payload)
                elif msg.kind == "attestation":
                    with track("on_attestation"):
                        idx = self._call_handler(fc.on_attestation, msg.payload)
                        self._mirror_attestation(msg.payload, idx)
                    self.pool[cached_root(msg.payload)] = msg.payload
                elif msg.kind == "slashing":
                    with track("on_attester_slashing"):
                        evil = self._call_handler(fc.on_attester_slashing, msg.payload)
                        if self.resident is not None:
                            self.resident.note_slashing(evil)
                elif msg.kind == "blob":
                    # sidecar gossip: verification (commitment recompute +
                    # erasure consistency) happens inside the blob store;
                    # a failed sidecar is a reject, not an exception
                    with track("on_blob_sidecar"), _metered(self.meter, "sidecar_ingest"):
                        accepted = (self.blob_store is not None
                                    and self.blob_store.on_sidecar(msg.payload))
                    if not accepted:
                        status, reason = "reject", "sidecar failed verification"
                        if self.meter is not None:
                            self.meter.rejected_sidecars += 1
            except AssertionError as e:
                # Invalid-at-this-time messages are dropped (the reference
                # permits re-queueing; the driver keeps the simple policy).
                # Pre-anchor walks in a checkpoint-synced view land here too
                # via the handlers' own asserts.
                status, reason = "reject", (str(e) or "assertion failed")[:200]
            if bus is not None:
                handler = _HANDLER_OF[msg.kind]
                extra = {"reason": reason} if reason is not None else {}
                bus.emit(
                    "deliver", span=(f"{msg.span}/d{self.id}" if msg.span else None),
                    parent=msg.span, group=self.id, kind=msg.kind, handler=handler,
                    t=msg.time, status=status,
                    duration_ms=round((_time.perf_counter() - t0) * 1e3, 4), **extra)
                self.telemetry.registry.counter(
                    "handler_calls_total", "fork-choice handler invocations from delivery",
                ).inc(handler=handler, status=status)


def _metered(meter, phase: str):
    return nullcontext() if meter is None else meter.phase(phase)


class Simulation:
    """Round-based multi-validator simulation over a Schedule, on one
    backend (``device``: see the module docstring)."""

    def __init__(self, n_validators: int, schedule: Schedule | None = None,
                 genesis_time: int = 0, accelerated_forkchoice: bool = False,
                 telemetry=None, profile=None, adversaries=(), monitors=(),
                 das=None, prewarm: bool = False, compile_cache=None,
                 variant=None, sharded=None, autocheckpoint=None,
                 serve=None, device=None):
        for knob, value, item in (("profile=", profile, "7b"),
                                  ("compile_cache=", compile_cache, "7b"),
                                  ("serve=", serve, "4d")):
            if value is not None and value is not False:
                raise _not_ported(knob, item)
        self.backend = _backend_for(device)
        with use_backend(self.backend):
            self._init(n_validators, schedule, genesis_time, accelerated_forkchoice,
                       adversaries, monitors, prewarm, variant, sharded, das, telemetry)
        # Run supervision: ``autocheckpoint=(every_n_slots, dir)`` (or an
        # AutoCheckpoint) arms per-slot heartbeats, integrity audits and
        # atomic checksummed checkpoints. Like telemetry, not simulation
        # state: a restarted process re-arms via ``resume_latest``.
        self.supervision = None
        if autocheckpoint is not None:
            self.attach_autocheckpoint(autocheckpoint)

    def _init(self, n_validators, schedule, genesis_time, accelerated_forkchoice,
              adversaries, monitors, prewarm, variant, sharded, das, telemetry) -> None:
        self.cfg = cfg()
        self.schedule = schedule or honest_schedule(n_validators)
        self.n_validators = n_validators
        self.genesis_time = genesis_time
        # Sharded execution is item 3: None and False change nothing; any
        # other value goes to the backend, which raises.
        self.sharded = None
        if sharded is not None and sharded is not False:
            self.backend.enable_sharded(sharded)
        # Telemetry: opt-in event bus and metrics registry, not simulation
        # state (a checkpoint excludes it; pass it again to ``resume``).
        # The Simulation owns the sink of the fault plan it runs: this
        # run's bus, or none, so a reused schedule never leaks fault
        # events onto an earlier run's bus.
        self.telemetry = telemetry
        if self.schedule.faults is not None:
            self.schedule.faults.sink = telemetry.bus if telemetry is not None else None
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
        # DAS blob workload (das/): ``das`` is a das.engine.BlobEngine, or
        # True / a scheme name for the default one (``blob_engine_for``).
        # Proposals then carry blob sidecars, every view group runs an
        # availability store gating on_block imports, and
        # ``attach_das_clients`` hangs a sampling population off the
        # serving group. Like the schedule, the engine is passed again to
        # ``resume`` (sidecar payloads are seeded pure functions of the
        # chain, so a resumed run regenerates them bit-identically).
        if das is not None and das is not False:
            das = blob_engine_for(das, self.cfg, self.backend.device)
        else:
            das = None
        self.das = das
        self.blob_archive: dict[bytes, list] = {}
        self.das_server = None
        self.das_population = None
        self._das_group = 0
        self._das_window = 2
        # every served block's ``serve_samples`` summary, in order (the
        # JAX package emits each as a ``das_serve`` event; not simulation
        # state)
        self.das_serves: list[dict] = []
        self.meter = RiderMeter()
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
            group = ViewGroup(g, store, self.schedule.members(g), resident,
                              telemetry=telemetry)
            if self.variant.needs_view:
                view = self.variant.make_view(g)
                group.variant_view = view
                store.variant_view = view
            if self.das is not None:
                from pos_evolution_tpu_torch.das import BlobStore
                group.blob_store = BlobStore(
                    self.das, registry=telemetry.registry if telemetry is not None else None,
                    group=g)
                store.blob_store = group.blob_store
                group.meter = self.meter
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
        # Light clients following this simulation via sync-protocol updates
        # (lightclient/): attached with ``attach_light_client``, served one
        # update per slot from the serving group's head, subject to the
        # run's FaultPlan. Not simulation state: a resumed run re-attaches.
        self.light_clients: list = []
        self._lc_group = 0
        # In-loop adversary engine + online property monitors
        # (sim/adversary.py, sim/monitors.py). Neither is simulation
        # state: like the schedule, pass them again to ``resume``.
        self.adversaries = list(adversaries)
        self.monitors = list(monitors)
        self.monitor_violations: list[dict] = []
        if telemetry is not None:
            telemetry.bus.emit(
                "run_start", n_validators=n_validators, n_groups=self.schedule.n_groups,
                genesis_time=genesis_time, accelerated_forkchoice=accelerated_forkchoice,
                sharded=self.sharded, debug=telemetry.debug)
        self._bind_adversaries_and_monitors()

    def _get_head(self, group: ViewGroup) -> bytes:
        t0 = _time.perf_counter()
        with self.timer.track("get_head"):
            # GasperVariant answers from the resident mirror / spec walk;
            # successor variants run their expiry-windowed rules
            head = self.variant.head(self, group)
        if self.telemetry is not None:
            self.telemetry.bus.emit(
                "handler", handler="get_head", group=group.id,
                duration_ms=round((_time.perf_counter() - t0) * 1e3, 4))
            self.telemetry.registry.counter(
                "handler_calls_total", "fork-choice handler invocations from delivery",
            ).inc(handler="get_head", status="accept")
        return head

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
        if self.monitors and self.telemetry is not None:
            self.telemetry.bus.emit(
                "monitor_attach", monitors=[m.describe() for m in self.monitors],
                adversaries=[s.describe() for s in self.adversaries])

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
                record = {"slot": slot, **violation}
                self.monitor_violations.append(record)
                if self.telemetry is not None:
                    self.telemetry.bus.emit("monitor", **record)

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
        self._resolve_blobs(dst, signed_block)
        missing = []
        parent = bytes(signed_block.message.parent_root)
        while parent not in dst.store.blocks:
            sb = self.block_archive.get(parent)
            if sb is None:
                return  # unconnectable (pre-anchor history): let on_block fail
            missing.append(sb)
            parent = bytes(sb.message.parent_root)
        chain = list(reversed(missing))
        for sb in chain:
            self._resolve_blobs(dst, sb)
        dst._process_block_chain(chain)

    def _resolve_blobs(self, group: ViewGroup, signed_block) -> None:
        """Blob-by-root backfill (the sidecar req/resp of real DAS nets):
        when a block is about to import but its committed sidecars never
        arrived (FaultPlan drops, crash outages), pull them from the
        archive and run them through the group's verifying store — a
        dropped sidecar becomes a delayed one exactly like a dropped
        block, keeping faults transient."""
        if group.blob_store is None:
            return
        block = signed_block.message
        root = cached_root(block)
        if group.blob_store.is_available(root, block):
            return
        backfilled = 0
        for sc in self.blob_archive.get(root, ()):
            with self.meter.phase("sidecar_ingest"):
                accepted = group.blob_store.on_sidecar(sc)
            self.meter.rejected_sidecars += not accepted
            backfilled += 1
        if backfilled and self.telemetry is not None:
            self.telemetry.registry.counter(
                "das_blob_backfills_total", "sidecars pulled by req/resp at import time",
            ).inc(backfilled, group=group.id)

    # -- fault layer (sim/faults.py) -------------------------------------------

    def _send(self, dst: ViewGroup, base_time: float, delay: float | None,
              kind: str, payload, slot: int, src: int, msg_id: int) -> None:
        """Deliver one message copy-set to ``dst``, routed through the
        ``FaultPlan`` (drop / duplicate / reorder) when one is attached.
        Crashed groups receive nothing."""
        if delay is None or dst.crashed:
            return
        t = base_time + delay
        span = None
        if self.telemetry is not None:
            # one gossip-edge span per (message, recipient group); a drop
            # leaves this span childless
            root_span = _span_id(kind, slot, src, msg_id)
            span = f"{root_span}/g{dst.id}"
            self.telemetry.bus.emit("gossip", span=span, parent=root_span, kind=kind,
                                    slot=slot, src=src, msg_id=msg_id, dst=dst.id, t=t)
        plan = self.schedule.faults
        if plan is None:
            dst.enqueue(t, kind, payload, span=span)
            return
        for extra in plan.delivery_offsets(kind, slot, src, msg_id, dst.id, t):
            dst.enqueue(t + extra, kind, payload, span=span)

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
                n_inflight = len(g.queue)
                g.queue.clear()
                g.pool.clear()
                g.block_atts.clear()
                if self.telemetry is not None:
                    self.telemetry.bus.emit("crash", group=g.id, slot=slot,
                                            lost_in_flight=n_inflight)
            elif g.crashed and not down:
                self._rejoin_group(g, slot)
                if self.telemetry is not None:
                    store = g.store
                    self.telemetry.bus.emit(
                        "rejoin", group=g.id, slot=slot,
                        sync_checkpoint_epoch=int(store.justified_checkpoint.epoch),
                        sync_checkpoint_root=bytes(store.justified_checkpoint.root).hex()[:16])

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
        if group.invariants is not None:
            # the checker fingerprints one store: re-anchor it on the synced one
            from pos_evolution_tpu_torch.utils.metrics import StoreInvariantChecker
            group.invariants = StoreInvariantChecker(store)
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
            # DAS: blob payloads are committed at build time through the
            # graffiti marker (state_root covers graffiti), so grids and
            # commitments exist BEFORE the block does.
            graffiti = b"\x00" * 32
            das_grids = das_commitments = None
            if self.das is not None:
                with self.meter.phase("blob_build"):
                    das_grids, das_commitments, graffiti = \
                        self.das.build_for(slot, head)
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
            if das_grids:
                self.blob_archive[block_root] = self.das.sidecars_for(
                    sb, block_root, das_grids, das_commitments)
            self._observe("block", sb)
            if self.telemetry is not None:
                # lifecycle root span: propose -> per-group gossip edges ->
                # per-group deliveries hang off this id
                self.telemetry.bus.emit(
                    "propose", span=_span_id("block", slot, int(proposer), 0), slot=slot,
                    proposer=int(proposer), group=group.id, block_root=block_root.hex()[:16],
                    n_attestations=len(atts))
            for dst in self.groups:
                delay = self.schedule.block_delay(int(proposer), slot, dst.id)
                # sidecars ride the block's gossip timing but their own
                # fault decisions (a dropped sidecar with a delivered
                # block leaves the block unimportable until the req/resp
                # backfill pulls the blobs) — enqueued BEFORE the block so
                # the in-order case verifies availability pre-import
                for sc in self.blob_archive.get(block_root, ()):
                    self._send(dst, t0, delay, "blob", sc, slot,
                               src=int(proposer),
                               msg_id=int(sc.blob_index))
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
                if self.telemetry is not None:
                    self.telemetry.bus.emit(
                        "attest", span=_span_id("attestation", slot, group.id, index),
                        slot=slot, group=group.id, committee=index, head=head.hex()[:16])
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
        variant_record = self.variant.on_slot_end(self, slot)
        if variant_record is not None and self.telemetry is not None:
            self.telemetry.bus.emit("variant", **variant_record)
        self._record_metrics(slot)
        self._run_monitors(slot)
        self._serve_light_clients(slot)
        self._serve_das(slot)
        self.slot += 1
        if self.supervision is not None:
            # heartbeat -> integrity audit -> checkpoint, in that order.
            # The capture serializes on this thread (the stores are live
            # objects); the writer thread digests and writes.
            self.supervision.tick(self, self.slot, self.checkpoint)

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
        if self.telemetry is not None:
            self.telemetry.bus.emit("slot", **rec)
            self.telemetry.registry.gauge(
                "finalized_epoch", "group-0 finalized epoch").set(rec["finalized_epoch"])
            self.telemetry.registry.gauge(
                "justified_epoch", "group-0 justified epoch").set(rec["justified_epoch"])
            self._record_merkleization(slot)

    def _record_merkleization(self, slot: int) -> None:
        """Per-slot deltas of this package's merkleization counters
        (``ssz/incremental.stats()``, ``ops/transition.session_stats()``,
        ``ops/merkle_device.stats()``): process-cumulative, so the driver
        keeps a mark and feeds this simulation's deltas to the registry,
        and one ``merkleization`` event a slot that saw activity."""
        from pos_evolution_tpu_torch.ops import merkle_device
        from pos_evolution_tpu_torch.ops.transition import session_stats
        from pos_evolution_tpu_torch.ssz import incremental
        cur = {f"ssz.{k}": v for k, v in incremental.stats().items()}
        cur.update({f"fused.{k}": v for k, v in session_stats().items()
                    if isinstance(v, (int, float))})
        cur.update({f"merkle.{k}": v for k, v in merkle_device.stats().items()})
        mark = getattr(self, "_merkle_mark", None)
        self._merkle_mark = cur
        if mark is None:
            return
        delta = {k: v - mark.get(k, 0) for k, v in cur.items() if v - mark.get(k, 0)}
        reg = self.telemetry.registry
        for k, v in delta.items():
            reg.counter(k, "incremental merkleization / block sweep "
                           "(per-sim delta of the process counters)").inc(v)
        if delta:
            self.telemetry.bus.emit("merkleization", slot=slot, **{
                k.replace(".", "_"): v for k, v in delta.items()})

    # -- light clients (lightclient/) ------------------------------------------

    def attach_light_client(self, group: int = 0):
        """Bootstrap a ``LightClientNode`` from ``group``'s finalized
        (weak-subjectivity) checkpoint and register it for per-slot update
        serving. The serving group is fixed to the first attach."""
        from pos_evolution_tpu_torch.lightclient import (
            LightClientNode,
            bootstrap_from_store,
        )
        g = self.groups[group]
        assert not g.crashed, "cannot bootstrap from a crashed group"
        assert not self.light_clients or group == self._lc_group, \
            "light clients are all served from one group; re-attach uses " \
            f"group {self._lc_group}"
        with use_backend(self.backend), self.meter.phase("lc_bootstrap"):
            trusted_root, bootstrap = bootstrap_from_store(g.store)
            state = g.store.block_states[bytes(g.store.finalized_checkpoint.root)]
            node = LightClientNode.from_bootstrap(
                trusted_root, bootstrap,
                fork_version=bytes(state.fork.current_version),
                genesis_validators_root=bytes(state.genesis_validators_root),
                node_id=len(self.light_clients))
        self._lc_group = group
        self.light_clients.append(node)
        return node

    def _serve_light_clients(self, slot: int) -> None:
        """End-of-slot update serving: derive the best update from the
        serving group's head and offer it to every attached client, routed
        through the FaultPlan (a dropped update is simply never seen — the
        client survives on the force-update path)."""
        if not self.light_clients:
            return
        group = self.groups[self._lc_group]
        # A crashed server stops SERVING, but the clients are independent
        # processes: their force-update timeout still ticks and their lag
        # is measured against the server's frozen view.
        head = self._get_head(group)
        update = None
        if not group.crashed:
            with self.meter.phase("lc_best_update"):
                if self.das_server is not None:
                    # best-update LRU (das/server.py): one proof build per
                    # distinct head, however many slots serve it
                    update = self.das_server.best_update(
                        group.store, head, archive=self.block_archive)
                else:
                    from pos_evolution_tpu_torch.lightclient import build_update
                    update = build_update(group.store, head,
                                          archive=self.block_archive)
        full_head_slot = int(group.store.blocks[head].slot)
        full_finalized_epoch = int(group.store.finalized_checkpoint.epoch)
        plan = self.schedule.faults
        t = self.slot_start(slot)
        for node in self.light_clients:
            if update is not None:
                delivered = (plan is None
                             or plan.delivery_offsets("lc_update", slot,
                                                      self._lc_group, 0,
                                                      1_000_000 + node.id, t))
                if delivered:
                    with self.meter.phase("lc_update"):
                        node.on_update(update, current_slot=slot)
            record = node.advance(slot, full_head_slot, full_finalized_epoch)
            if self.telemetry is not None:
                self.telemetry.bus.emit("light_client_lag", node=node.id, **record)

    def flush_light_clients(self) -> None:
        """Serve one off-chain finality update for the serving group's
        CURRENT head: the sync committee's signatures over the head exist
        before any block includes them (real networks gossip them as
        FinalityUpdates), so attached clients converge to the full node's
        exact finalized head instead of trailing one inclusion round."""
        if not self.light_clients:
            return
        group = self.groups[self._lc_group]
        if group.crashed:
            return
        with use_backend(self.backend):
            self._flush_light_clients(group)

    def _flush_light_clients(self, group: ViewGroup) -> None:
        from pos_evolution_tpu_torch.lightclient import build_head_update
        head = self._get_head(group)
        head_state = group.store.block_states[head]
        signature_slot = int(group.store.blocks[head].slot) + 1
        signing_state = advance_state_to_slot(head_state, signature_slot)
        round_index = signature_slot * self.cfg.intervals_per_slot
        aggregate = self._make_sync_aggregate(group, signature_slot, head,
                                              signing_state, round_index)
        if aggregate is None:
            return
        with self.meter.phase("lc_best_update"):
            update = build_head_update(group.store, head, aggregate,
                                       signature_slot, archive=self.block_archive)
        if update is None:
            return
        full_head_slot = int(group.store.blocks[head].slot)
        full_finalized_epoch = int(group.store.finalized_checkpoint.epoch)
        for node in self.light_clients:
            with self.meter.phase("lc_update"):
                node.on_update(update, current_slot=signature_slot)
            record = node.advance(signature_slot, full_head_slot, full_finalized_epoch)
            if self.telemetry is not None:
                self.telemetry.bus.emit("light_client_lag", node=node.id, offchain=True,
                                        **record)

    # -- DAS sampling clients (das/) --------------------------------------------

    def attach_das_clients(self, n_clients: int,
                           samples_per_client: int | None = None,
                           group: int = 0, seed: int = 0,
                           proof_cache: int = 4096, update_cache: int = 64,
                           window: int = 2):
        """Attach a vectorized sampling-client population (10^5-10^6
        clients as arrays, das/sampler.py) served once per slot from
        ``group``'s head through a coalescing ``DasServer``. Clients
        sample the newest ``window`` blocks of the canonical chain each
        slot (the availability-window retry behaviour of real DAS nets)
        — re-served blocks answer from the proof-path LRU, which is what
        makes the cache-hit metrics meaningful. Also swaps the
        light-client update serving onto the server's best-update LRU.
        The population hashes on the simulation's device, under its
        config. Not simulation state: a resumed run re-attaches."""
        assert self.das is not None, \
            "attach_das_clients requires Simulation(das=...)"
        from pos_evolution_tpu_torch.das import DasServer, SamplingClientPopulation
        self._das_group = group
        self._das_window = max(int(window), 1)
        registry = self.telemetry.registry if self.telemetry is not None else None
        self.das_server = DasServer(self.das.scheme, registry=registry,
                                    proof_cache=proof_cache,
                                    update_cache=update_cache)
        self.das_population = SamplingClientPopulation(
            self.cfg, n_clients, samples_per_client, seed=seed,
            device=self.backend.device)
        if registry is not None:
            registry.gauge("das_clients", "attached DAS sampling clients").set(n_clients)
        if self.telemetry is not None:
            self.telemetry.bus.emit("das_attach", **self.das_population.describe(),
                                    engine=self.das.describe())
        return self.das_population

    def _das_targets(self, group) -> list[tuple[bytes, object]]:
        """The newest ``window`` canonical blob-carrying blocks from
        ``group``'s head — the per-slot serving window."""
        from pos_evolution_tpu_torch.das.containers import parse_das_graffiti
        targets = []
        root = self._get_head(group)
        while len(targets) < self._das_window and root in group.store.blocks:
            block = group.store.blocks[root]
            if parse_das_graffiti(bytes(block.body.graffiti)) is not None:
                targets.append((root, block))
            if int(block.slot) == 0:
                break
            root = bytes(block.parent_root)
        return targets

    def _serve_das(self, slot: int) -> None:
        """End-of-slot sampling round: the serving group's head block's
        sidecars are sampled by the whole population through the
        coalescing server; each summary is appended to ``das_serves`` and
        emitted as a ``das_serve`` event."""
        if self.das_population is None:
            return
        from pos_evolution_tpu_torch.das.containers import parse_das_graffiti
        group = self.groups[self._das_group]
        if group.crashed:
            return
        # the head freshly, its recent ancestors again (their cells
        # answer from the proof-path LRU warmed by the previous slots)
        for age, (root, block) in enumerate(self._das_targets(group)):
            n_blobs = parse_das_graffiti(bytes(block.body.graffiti))[0]
            sidecars = (group.blob_store.sidecars_for_block(root)
                        if group.blob_store is not None else [])
            if len(sidecars) < n_blobs:
                sidecars = self.blob_archive.get(root, [])
            if len(sidecars) < n_blobs:
                continue  # serving node itself lacks the data
            with self.meter.phase("das_serve"):
                summary = self.das_server.serve_samples(root, sidecars, self.das_population)
            self.das_serves.append(summary)
            if self.telemetry is not None:
                self.telemetry.bus.emit("das_serve", slot=slot, age=age,
                                        block_root=root.hex()[:16], **summary)

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
        (None rebuilds one from the checkpoint's fingerprint); ``das``
        re-attaches the run's blob engine (its ``describe()`` must match
        the checkpoint's); ``telemetry`` re-attaches an event bus and
        registry (the resumed run records only post-resume events)."""
        from pos_evolution_tpu_torch.utils.snapshot import load_simulation
        backend = _backend_for(device)
        with use_backend(backend):
            return load_simulation(data, schedule=schedule, telemetry=telemetry,
                                   adversaries=adversaries, monitors=monitors,
                                   das=das, variant=variant, sharded=sharded,
                                   device=backend)

    # -- run supervision -----------------------------------------------------------

    def attach_autocheckpoint(self, spec) -> None:
        """Arm (or re-arm, after a resume) run supervision: an
        ``(every_n_slots, dir)`` tuple, a dict, or a
        ``resilience.AutoCheckpoint``. Merkle digests hash on this run's
        backend device."""
        from pos_evolution_tpu_torch.resilience import RunSupervision
        self.supervision = RunSupervision(spec, kind="sim", telemetry=self.telemetry,
                                          cfg_obj=self.cfg, backend=self.backend)

    def finish_autocheckpoint(self) -> dict | None:
        """Take a final checkpoint at the current slot and drain the async
        writer; returns the manager's overhead stats (None when
        unsupervised). Call once at the end of a supervised run."""
        if self.supervision is None:
            return None
        return self.supervision.finish(self.slot, self.checkpoint)

    @classmethod
    def resume_latest(cls, dir, schedule: Schedule | None = None, telemetry=None,
                      adversaries=(), monitors=(), das=None, variant=None, sharded=None,
                      autocheckpoint=None, device=None) -> "Simulation":
        """Resume from the newest valid checkpoint under ``dir``
        (``resilience.CheckpointManager`` layout) on ``device`` (the thread
        backend's when None): checksums (a merkle step re-checked through
        K2 on the card), the manifest and the active config's fingerprint
        are verified, corrupt steps are quarantined and rolled past, and a
        fingerprint of another config refuses. ``autocheckpoint`` re-arms
        supervision on the resumed run. Raises ``FileNotFoundError`` when
        no valid checkpoint exists."""
        import os

        from pos_evolution_tpu_torch.resilience import CheckpointManager
        from pos_evolution_tpu_torch.resilience.runner import run_fingerprint
        backend = _backend_for(device)
        manager = CheckpointManager(dir, fingerprint=run_fingerprint("sim"), backend=backend)
        found = manager.latest_valid()
        if found is None:
            raise FileNotFoundError(f"no valid checkpoint under {dir!r} to resume from")
        step, payloads = found
        sim = cls.resume(payloads["payload.bin"], schedule=schedule, telemetry=telemetry,
                         adversaries=adversaries, monitors=monitors, das=das,
                         variant=variant, sharded=sharded, device=backend)
        # the step resumed and its validation's digest records
        sim.resumed_from = {"step": step, "verify": list(manager.verify_log)}
        if autocheckpoint is not None:
            sim.attach_autocheckpoint(autocheckpoint)
        if telemetry is not None:
            telemetry.bus.emit("run_resumed", step=step, slot=sim.slot, dir=os.fspath(dir))
        return sim

    # -- accessors --
    def store(self, group: int = 0) -> fc.Store:
        return self.groups[group].store

    def finalized_epoch(self, group: int = 0) -> int:
        return int(self.groups[group].store.finalized_checkpoint.epoch)

    def justified_epoch(self, group: int = 0) -> int:
        return int(self.groups[group].store.justified_checkpoint.epoch)


# --- the entry point ----------------------------------------------------------


def run_scale(n: int = 65_536, epochs: int = 4, device="cuda", on_epoch=None, *,
              das=None, das_clients: int = 0, light_clients: int = 0) -> dict:
    """``Simulation(n, accelerated_forkchoice=True, das=das)`` under the
    active config for ``epochs`` epochs on ``device``, with ``das_clients``
    sampling clients (``attach_das_clients``) and ``light_clients`` light
    clients attached before the first slot and flushed after the last ->
    the summary the entry point prints: set-up and per-epoch seconds,
    justified and finalized epochs, the resident head against the spec
    walk, the resident stores' degradation, the handler percentiles after
    the first epoch (its samples hold the first launches and capacity
    growth), K2 launches a state root, the run's head queries and each
    resident store's counts of fresh device queries, memo answers, flushes
    and rebuilds; with riders, ``riders`` (``_rider_summary``).
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
    sim = Simulation(n, accelerated_forkchoice=True, device=backend, das=das)
    if das_clients:
        sim.attach_das_clients(das_clients)
    for _ in range(light_clients):
        sim.attach_light_client()
    sync()
    init_s = _time.perf_counter() - t0
    per_epoch = []
    rider_epochs = []
    head_queries = 0
    for e in range(1, epochs + 1):
        te = _time.perf_counter()
        s0 = dict(sim.meter.seconds)
        sim.run_epochs(e)
        sync()
        per_epoch.append(_time.perf_counter() - te)
        rider_epochs.append({k: v - s0.get(k, 0.0) for k, v in sim.meter.seconds.items()})
        if e == 1:
            head_queries += len(sim.timer.samples.get("get_head", ()))
            sim.timer.reset()
        if on_epoch is not None:
            on_epoch(e, sim)
    sim.flush_light_clients()
    group = sim.groups[0]
    with use_backend(sim.backend):
        spec_head = fc.get_head(group.store)
        host_head = ofc.get_head_host(group.store)
        resident_head = sim._get_head(group)
    summary_after_first = sim.trace_summary()
    head_queries += summary_after_first.get("get_head", {}).get("count", 0)
    roots = incremental.stats()["htr_calls"] - roots0
    # the state roots' K2 launches: the riders' own (sidecars, samples, proofs) aside
    k2 = (kernels.launches.get("merkle_level", 0) - k2_0
          - sum(d.get("merkle_level", 0) for d in sim.meter.launches.values()))
    riders = (_rider_summary(sim, per_epoch, rider_epochs)
              if sim.das is not None or sim.light_clients else None)
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
        "riders": riders,
        "sim": sim,
    }


def _rider_summary(sim: Simulation, per_epoch: list, rider_epochs: list) -> dict:
    """The riders' part of ``run_scale``'s summary: their seconds an epoch
    by phase (light-client serving is the best update plus the clients'
    updates) and their share of the epoch; each phase's calls and kernel
    launches a call (``RiderMeter``); the sidecars' verdicts; the DAS
    server's counters and last ``serve_samples`` summary; the best update's
    ms and K2 launches a fresh head; each light client's ``summary()`` and
    whether its finalized root is the serving group's finalized checkpoint
    root."""
    meter = sim.meter
    split = [{"blob_build": r.get("blob_build", 0.0),
              "sidecar_ingest": r.get("sidecar_ingest", 0.0),
              "das_serve": r.get("das_serve", 0.0),
              "lc_serve": r.get("lc_best_update", 0.0) + r.get("lc_update", 0.0)}
             for r in rider_epochs]
    out = {
        "rider_s_per_epoch": split,
        "rider_share": [sum(r.values()) / t if t else 0.0 for r, t in zip(split, per_epoch)],
        "phase_calls": dict(meter.calls), "phase_seconds": dict(meter.seconds),
        "launches_per_call": {k: meter.per_call(k) for k in meter.calls},
    }
    if sim.das is not None:
        stores = [g.blob_store for g in sim.groups]
        out["sidecars"] = {
            "proposals": meter.calls.get("blob_build", 0),
            "archived": sum(len(v) for v in sim.blob_archive.values()),
            "held": [sum(len(c) for c in st.sidecars.values()) for st in stores],
            "rejected": meter.rejected_sidecars,
        }
    server = sim.das_server
    if server is not None:
        out["das_server"] = {
            "served_blocks": server.served_blocks, "samples_served": server.samples_served,
            "scheme_builds": server.scheme_builds,
            "proof_cache_hit_rate": server.proof_cache.hit_rate,
            "update_cache_hits": server.update_cache.hits,
            "update_cache_misses": server.update_cache.misses,
            "served_all_ok": all(s["failed"] == 0 and s["clients_all_ok"] == s["clients"]
                                 for s in sim.das_serves),
            "last_serve": sim.das_serves[-1] if sim.das_serves else None,
        }
    if sim.light_clients:
        group = sim.groups[sim._lc_group]
        # every call builds an update but a cache hit
        fresh = (meter.calls.get("lc_best_update", 0)
                 - (server.update_cache.hits if server is not None else 0))
        k2 = meter.launches.get("lc_best_update", {}).get("merkle_level", 0)
        final_root = bytes(group.store.finalized_checkpoint.root)
        out["light_clients"] = {
            "fresh_heads": fresh,
            "best_update_ms_per_fresh_head":
                meter.seconds.get("lc_best_update", 0.0) * 1e3 / fresh if fresh else None,
            "best_update_k2_per_fresh_head": k2 / fresh if fresh else None,
            "summaries": [node.summary() for node in sim.light_clients],
            "on_full_node_finalized_root": [node.finalized_root() == final_root
                                            for node in sim.light_clients],
        }
    return out


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
    ap.add_argument("--das", choices=("merkle", "kzg"), default=None,
                    help="blob sidecars under this cell-commitment scheme, PeerDAS geometry")
    ap.add_argument("--das-clients", type=int, default=0, help="sampling clients (needs --das)")
    ap.add_argument("--light-clients", type=int, default=0)
    args = ap.parse_args(argv)
    if args.das_clients and args.das is None:
        ap.error("--das-clients needs --das")
    dev = resolve_device(args.device)

    def progress(e, sim):
        m = sim.metrics[-1]
        print(f"# epoch {e}: justified={m['justified_epoch']} "
              f"finalized={m['finalized_epoch']} blocks={m['n_blocks']}", file=sys.stderr)

    cfg = mainnet_config().replace(**PEERDAS) if args.das else mainnet_config()
    with use_config(cfg):
        out = run_scale(args.n, args.epochs, device=dev, on_epoch=progress, das=args.das,
                        das_clients=args.das_clients, light_clients=args.light_clients)
    out.pop("sim")
    if any(out["degraded"]) or any(out["incidents"]):
        # the store answered from the host spec walk: the times are not the device path's
        raise SystemExit(f"resident fork choice degraded {out['degraded']}: {out['incidents']}")
    out["card"] = card_line(dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
