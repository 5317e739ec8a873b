"""Supervised process workers: the serving plane's multi-process half.

``WorkerPool`` starts N request-serving processes (never a fork of the
thread-running parent — exactly the hazard the PEV007 lint exists
for). Each worker runs a full ``ServeFront`` — acceptor, readers,
admission, worker threads — bound to its assigned port with
``SO_REUSEPORT``, so the kernel spreads connections across the workers
sharing a port and a dead worker's port keeps serving from its siblings.

The data plane is the shared segment (``serve/shm.ShmViewBoard``): a
worker never receives a view over a pipe — a follower thread polls the
board's generation and republishes into the worker's local
``ServingState`` (one decode per generation), the DAS proof path runs
cross-process single-flight through the board's lease table
(``utils/singleflight.ProcessFlight``), and the worker publishes its
health (generation, brownout, depth, request count) into its board slot.

The control plane is the supervision contract, via the extracted
core (``resilience/supervision.py``): every worker heartbeats a
``utils/watchdog.Heartbeat`` file; the pool's monitor detects **crash**
(exitcode), **hang** (stale heartbeat -> SIGKILL), and **leak** (RSS past
the cap -> SIGKILL), then respawns with capped deterministic backoff —
streak reset when the slot's served-request count advances, loud refusal
(slot parked) when failures are systematic. Every interruption is
recorded and emitted as a ``worker_interruption`` telemetry event for
``run_report``'s worker table.

Honest loss accounting: a SIGKILL'd worker's in-flight connections die
with it (kernel RST -> the client's connection-lost retry path); a
SIGTERM'd worker drains its admission queue with ``shed`` + retry-after
before exiting (``ServeFront.stop``) — queued work is answered or
honestly refused, never silently swallowed.

The port's differences from the JAX package's module: a spec names the
scheme's ``device`` (``"cuda"`` unless the caller asks for the CPU; a
worker asked for CUDA on a machine without it raises at boot, and the
pool reports it never became ready). Workers start from a forkserver
that has imported torch and this module once (``forkserver`` with a
preload, not ``spawn``): a fresh interpreter spends seconds importing
torch, and a respawn that slow misses the harness's settle window. The
server process is started fresh and runs no threads, so the fork hazard
of a thread-running parent does not arise, and no worker inherits a CUDA
context. A worker beats once before its first CUDA work (the payload
marked ``booting``), so the pool's hang timeout, counted from the launch
until a first beat, restarts there and covers the CUDA context's
creation alone; the pool counts a worker ready at its first beat after
boot. Before it serves, a worker moves its heap (torch's objects) into
the collector's permanent generation (``gc.freeze``). Each worker folds
its kernel launches into
``kernel_launches_total{kernel}`` (``telemetry/torchrt``) before each
fleet snapshot, so the ``metrics`` RPC reports the launches the workers
made.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import sys
import threading
import time

from pos_evolution_tpu_torch.resilience.supervision import (
    RetryPolicy,
    heartbeat_age,
    rss_kb,
)

__all__ = ["WorkerPool", "worker_spec"]

_POLL_S = 0.1


def worker_spec(worker_id: int, port: int, board_name: str,
                lock_path: str, run_dir: str, *, host: str = "127.0.0.1",
                scheme: str = "merkle", threads: int = 2,
                front_id: int | None = None, beat_s: float = 0.25,
                proof_cache: int = 4096, max_depth: int = 512,
                max_connections: int = 512,
                default_deadline_ms: float = 1000.0,
                brownout: dict | None = None, chaos: dict | None = None,
                config: dict | None = None,
                trace_dir: str | None = None, device: str = "cuda") -> dict:
    """The picklable worker description ``_worker_main`` boots from —
    plain data only (a spawn child shares no interpreter state): the
    scheme travels by registry NAME and device, the config by field
    dict, the board by segment name."""
    if config is None:
        from pos_evolution_tpu_torch.config import cfg
        config = dataclasses.asdict(cfg())
    return {
        "worker_id": int(worker_id),
        "front_id": int(front_id if front_id is not None else worker_id),
        "port": int(port), "host": host,
        "board_name": board_name, "lock_path": lock_path,
        "heartbeat_path": os.path.join(run_dir, f"worker{worker_id}.hb"),
        "stats_path": os.path.join(run_dir, f"worker{worker_id}.stats"),
        "run_dir": run_dir, "trace_dir": trace_dir,
        "scheme": scheme, "threads": int(threads),
        "beat_s": float(beat_s), "proof_cache": int(proof_cache),
        "max_depth": int(max_depth),
        "max_connections": int(max_connections),
        "default_deadline_ms": float(default_deadline_ms),
        "brownout": brownout or {}, "chaos": chaos,
        "config": config, "device": str(device),
    }


def _atomic_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    os.replace(tmp, path)


def _worker_main(spec: dict) -> None:
    """Spawn entry: boot config/scheme from plain data, attach the
    board, serve until SIGTERM. Runs in a FRESH interpreter — nothing
    here may assume the parent's threads, locks, or registries exist."""
    from pos_evolution_tpu_torch.config import Config, set_config
    from pos_evolution_tpu_torch.das.commitment import get_scheme
    from pos_evolution_tpu_torch.das.server import DasServer
    from pos_evolution_tpu_torch.serve.admission import BrownoutController
    from pos_evolution_tpu_torch.serve.server import ServeFront
    from pos_evolution_tpu_torch.serve.shm import ShmViewBoard
    from pos_evolution_tpu_torch.serve.state import ServingState
    from pos_evolution_tpu_torch.telemetry import fleet, torchrt, tracing
    from pos_evolution_tpu_torch.telemetry.registry import MetricsRegistry
    from pos_evolution_tpu_torch.utils.singleflight import ProcessFlight
    from pos_evolution_tpu_torch.utils.watchdog import Heartbeat

    cfg_fields = dict(spec["config"])
    if isinstance(cfg_fields.get("terminal_block_hash"), str):
        cfg_fields["terminal_block_hash"] = bytes.fromhex(
            cfg_fields["terminal_block_hash"])
    config = Config(**cfg_fields)
    set_config(config)
    # seeded wedge windows (chaos satellite): inside a window the worker
    # keeps SERVING but stops heartbeating — the liveness lie the pool's
    # hang detection must catch and SIGKILL through
    wedges = []
    chaos = spec.get("chaos") or {}
    if chaos.get("wedge_windows"):
        wedges = [(float(lo), float(hi))
                  for lo, hi in chaos["wedge_windows"]]
    # one beat before the CUDA work: the hang timeout restarts here
    now = time.time()
    if not any(lo <= now < hi for lo, hi in wedges):
        Heartbeat(spec["heartbeat_path"]).beat(
            slot=0, worker=spec["worker_id"], booting=True)
    # the scheme on its device (raises when CUDA is asked for and
    # absent); on the card, the context is made before the front listens
    scheme = get_scheme(spec["scheme"], spec["device"], cfg=config)
    _warm_device(scheme)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda _s, _f: stop.set())
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    board = ShmViewBoard.attach(spec["board_name"], spec["lock_path"])
    state = ServingState()
    registry = MetricsRegistry()
    torchrt.install(registry)
    das = DasServer(scheme, registry=registry,
                    proof_cache=spec["proof_cache"],
                    flight=ProcessFlight(board))
    brownout = BrownoutController(**spec["brownout"]) \
        if spec["brownout"] else BrownoutController()
    front = ServeFront(
        state, das_server=das, registry=registry,
        workers=spec["threads"], host=spec["host"], port=spec["port"],
        max_depth=spec["max_depth"],
        max_connections=spec["max_connections"],
        default_deadline_ms=spec["default_deadline_ms"],
        brownout=brownout, reuse_port=True,
        ident=f"{os.getpid()}:{spec['worker_id']}",
        metrics_dir=spec.get("run_dir"),
        worker_id=spec["worker_id"])
    # span sink for this process's server-side trace spans; the beat
    # thread flushes it alongside the metrics snapshot
    if spec.get("trace_dir"):
        tracing.install_buffer(spec["trace_dir"],
                               proc=f"worker{spec['worker_id']}")
    # the worker's heap holds torch's and the port's objects, several
    # times the JAX package's worker's, and a full collection walks them
    # all with every thread stopped. What exists now lives as long as the
    # process, so it leaves the collector's generations.
    gc.freeze()
    front.start()

    seen = {"generation": 0}

    def _follow() -> None:
        # view follower: one decode per generation, republished into
        # the local ServingState (which fires the front's publish hooks)
        while not stop.is_set():
            try:
                gen, view = board.current()
            except Exception:
                break  # board unlinked under us: the pool is stopping
            if view is not None and gen != seen["generation"]:
                seen["generation"] = gen
                state.publish(view)
            stop.wait(0.005)

    def _requests_total() -> int:
        front._flush_fast_metrics()  # fold fast-path tallies first
        return sum(v for k, v in registry.counts().items()
                   if k.startswith("serve_requests_total;"))

    def _beat() -> None:
        hb = Heartbeat(spec["heartbeat_path"])
        while not stop.is_set():
            now = time.time()
            wedged = any(lo <= now < hi for lo, hi in wedges)
            requests = _requests_total()
            if not wedged:
                hb.beat(slot=seen["generation"], requests=requests,
                        rss_kb=rss_kb(os.getpid()),
                        worker=spec["worker_id"])
            try:
                board.write_health(
                    spec["front_id"], generation=seen["generation"],
                    brownout=front.brownout.active,
                    depth=front.queue.depth(), requests=requests,
                    shed=sum(front.queue.shed.values()))
            # not a swallow: a torn-down board just means the pool is
            # stopping — the supervisor sees the exit either way
            except Exception:  # pev: ignore[PEV005]
                pass
            # fleet metrics snapshot: atomic dump of this incarnation's
            # registry (its kernel launches folded in first), pid-named
            # so a respawn never overwrites the corpse's last-flushed
            # counts. OSError is survivable — a full disk must not kill
            # the worker.
            torchrt.collect_launches()
            try:
                fleet.write_snapshot(
                    fleet.snapshot_path(spec["run_dir"],
                                        spec["worker_id"], os.getpid()),
                    registry, spec["worker_id"], os.getpid(),
                    front=spec["front_id"],
                    generation=seen["generation"])
            except OSError:
                registry.counter(
                    "serve_fleet_snapshot_errors_total",
                    "fleet metrics snapshots lost to I/O errors").inc()
            buf = tracing.get_buffer()
            if buf is not None:
                buf.flush()
            _atomic_json(spec["stats_path"], {
                "pid": os.getpid(), "worker": spec["worker_id"],
                "generation": seen["generation"],
                "unix": round(now, 3),
                "summary": front.summary(),
                "singleflight_process": {
                    "leads": das._flight.leads,
                    "waits": das._flight.waits,
                    "takeovers": getattr(das._flight, "takeovers", 0),
                },
                "counts": registry.counts(),
            })
            stop.wait(spec["beat_s"])

    follower = threading.Thread(target=_follow, name="view-follower",
                                daemon=True)
    beater = threading.Thread(target=_beat, name="worker-beat",
                              daemon=True)
    follower.start()
    beater.start()
    stop.wait()
    front.stop()          # honest drain: queued work answers shed
    beater.join(timeout=2.0)
    front._flush_fast_metrics()  # fold the last beat-interval's tallies
    torchrt.collect_launches()
    try:
        fleet.write_snapshot(
            fleet.snapshot_path(spec["run_dir"], spec["worker_id"],
                                os.getpid()),
            registry, spec["worker_id"], os.getpid(),
            front=spec["front_id"], generation=seen["generation"])
    except OSError:
        pass
    buf = tracing.get_buffer()
    if buf is not None:
        buf.flush()
    _atomic_json(spec["stats_path"], {
        "pid": os.getpid(), "worker": spec["worker_id"],
        "generation": seen["generation"], "unix": round(time.time(), 3),
        "summary": front.summary(),
        "singleflight_process": {"leads": das._flight.leads,
                                 "waits": das._flight.waits},
        "counts": registry.counts(), "final": True,
    })
    board.close(unlink=False)
    sys.exit(0)


def _warm_device(scheme) -> None:
    """On a CUDA scheme, create the context before the front listens, so
    that the first request does not pay for it. Launches nothing (the
    kernel libraries are built by the parent before it spawns)."""
    device = scheme.device
    if device.type == "cuda":
        import torch
        torch.empty(1, device=device)


class _Slot:
    """One worker slot: current process + its incarnation history."""

    def __init__(self, spec: dict, policy: RetryPolicy):
        self.spec = spec
        self.policy = policy
        self.proc = None
        self.launched_mono = 0.0
        self.launched_unix = 0.0
        self.respawn_at: float | None = None
        self.restarts = 0
        self.parked = False     # retry budget exhausted: refuse loudly
        self.totals: dict = {}  # counters folded in from dead incarnations


class WorkerPool:
    """Spawn, watch, and honestly restart N serving processes.

    ``ports`` maps workers onto listeners: one port = a kernel-balanced
    SO_REUSEPORT group; several ports = several fronts (worker i serves
    ``ports[i % len(ports)]``), which is how the multi-front balancer
    (``serve/balancer.py``) gets its backends.
    """

    def __init__(self, specs: list[dict], board, *,
                 hang_timeout_s: float = 3.0, rss_limit_mb: float = 0.0,
                 max_failures: int = 5, backoff_s: float = 0.2,
                 backoff_cap_s: float = 5.0, jitter: float = 0.25,
                 seed: int = 0, events_bus=None, chaos=None):
        self.board = board
        self.hang_timeout_s = float(hang_timeout_s)
        self.rss_limit_kb = float(rss_limit_mb) * 1024.0
        self.events_bus = events_bus
        self.chaos = chaos
        self._ctx = None
        self.slots = [
            _Slot(spec, RetryPolicy(max_failures=max_failures,
                                    backoff_s=backoff_s,
                                    backoff_cap_s=backoff_cap_s,
                                    jitter=jitter,
                                    seed=seed ^ (i << 8)))
            for i, spec in enumerate(specs)]
        self.interruptions: list[dict] = []
        self.chaos_kills_delivered = 0
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- telemetry -------------------------------------------------------------

    def _emit(self, type_: str, **fields) -> None:
        try:
            if self.events_bus is not None:
                self.events_bus.emit(type_, **fields)
            else:
                from pos_evolution_tpu_torch.telemetry import emit_global
                emit_global(type_, **fields)
        except Exception:
            pass

    # -- lifecycle -------------------------------------------------------------

    def _spawn(self, slot: _Slot) -> None:
        if self._ctx is None:
            import multiprocessing
            # never fork the pool's thread-running, lock-holding parent
            # (the exact fork-unsafety PEV007 flags): workers fork from a
            # fresh, single-threaded server that imported torch and the
            # port once, so a respawn skips the seconds of that import
            self._ctx = multiprocessing.get_context("forkserver")
            self._ctx.set_forkserver_preload([__name__])
        # a fresh incarnation must not inherit the corpse's heartbeat
        # as its own liveness (heartbeat_age's attempt-boundary rule
        # covers the file; removing it keeps the stats dir honest too)
        slot.proc = self._ctx.Process(
            target=_worker_main, args=(slot.spec,),
            name=f"serve-worker-{slot.spec['worker_id']}", daemon=True)
        slot.proc.start()
        slot.launched_mono = time.monotonic()
        slot.launched_unix = time.time()
        slot.respawn_at = None
        self._emit("worker_spawn", worker=slot.spec["worker_id"],
                   pid=slot.proc.pid, restarts=slot.restarts)

    def start(self) -> None:
        for slot in self.slots:
            self._spawn(slot)
        self._monitor = threading.Thread(target=self._watch,
                                         name="pool-monitor", daemon=True)
        self._monitor.start()

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        """Block until every live worker has beaten its heartbeat at
        least once after its boot (its front is listening) or the
        timeout passes."""
        deadline = time.monotonic() + timeout_s
        from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat
        while time.monotonic() < deadline:
            ready = 0
            for slot in self.slots:
                hb = read_heartbeat(slot.spec["heartbeat_path"])
                if hb is not None and hb["payload"].get(
                        "unix", 0) >= slot.launched_unix \
                        and not hb["payload"].get("booting"):
                    ready += 1
            if ready == len(self.slots):
                return True
            time.sleep(0.05)
        return False

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout_s)
        for slot in self.slots:
            proc = slot.proc
            if proc is None or not proc.is_alive():
                continue
            try:
                os.kill(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                continue
        deadline = time.monotonic() + timeout_s
        for slot in self.slots:
            proc = slot.proc
            if proc is None:
                continue
            proc.join(timeout=max(deadline - time.monotonic(), 0.1))
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)

    # -- the monitor loop ------------------------------------------------------

    def kill_worker(self, worker_id: int,
                    reason: str = "chaos_sigkill") -> int | None:
        """SIGKILL one live worker (the chaos injection's entry point).
        Returns the killed pid, or None when the slot had no live
        process. The monitor then sees an ordinary crash — detection
        and respawn take the same path as a real failure."""
        for slot in self.slots:
            if slot.spec["worker_id"] != worker_id:
                continue
            proc = slot.proc
            if proc is None or not proc.is_alive():
                return None
            pid = proc.pid
            self._emit("worker_chaos_kill", worker=worker_id, pid=pid,
                       reason=reason)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                return None
            return pid
        return None

    def _hb_payload(self, slot: _Slot) -> dict:
        from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat
        hb = read_heartbeat(slot.spec["heartbeat_path"])
        return (hb or {}).get("payload") or {}

    def _fold_stats(self, slot: _Slot) -> None:
        """Fold a dead incarnation's last stats dump into the slot's
        running totals (the dump survives SIGKILL up to the last beat —
        bounded staleness, same posture as checkpoint loss)."""
        try:
            with open(slot.spec["stats_path"]) as f:
                stats = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        t = slot.totals
        summary = stats.get("summary") or {}
        for k, v in (summary.get("by_status") or {}).items():
            t.setdefault("by_status", {})
            t["by_status"][k] = t["by_status"].get(k, 0) + v
        for key in ("requests_total", "scheme_builds",
                    "slow_loris_closed", "conn_rejected"):
            t[key] = t.get(key, 0) + int(summary.get(key) or 0)
        sf = stats.get("singleflight_process") or {}
        t["sf_leads"] = t.get("sf_leads", 0) + int(sf.get("leads") or 0)
        t["sf_waits"] = t.get("sf_waits", 0) + int(sf.get("waits") or 0)

    def _interrupt(self, slot: _Slot, reason: str, exit_code) -> None:
        payload = self._hb_payload(slot)
        record = {
            "worker": slot.spec["worker_id"],
            "pid": slot.proc.pid if slot.proc else None,
            "reason": reason, "exit_code": exit_code,
            "wall_s": round(time.monotonic() - slot.launched_mono, 3),
            "last_heartbeat": payload or None,
        }
        self._fold_stats(slot)
        # tombstone the dead worker's health slot NOW: the supervisor
        # knows the process is gone (exitcode in hand) — routing must
        # not spend STALE_S believing the last heartbeat
        if self.board is not None:
            try:
                self.board.clear_health(slot.spec["front_id"])
            except (AssertionError, ValueError):
                pass
        delay = slot.policy.record_failure(
            progress=payload.get("requests"))
        with self._lock:
            self.interruptions.append(record)
        self._emit("worker_interruption", **record)
        if delay is None:
            slot.parked = True
            self._emit("worker_gaveup", worker=slot.spec["worker_id"],
                       consecutive_failures=slot.policy.failures)
            return
        slot.respawn_at = time.monotonic() + delay
        slot.restarts += 1
        self._emit("worker_backoff", worker=slot.spec["worker_id"],
                   failures=slot.policy.failures, delay_s=round(delay, 3))

    def _watch(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            if self.chaos is not None:
                for worker_id in self.chaos.worker_kills_due():
                    if self.kill_worker(worker_id) is not None:
                        # delivered to a LIVE process (a kill landing
                        # on an already-dead slot proves nothing)
                        with self._lock:
                            self.chaos_kills_delivered += 1
            for slot in self.slots:
                if slot.parked:
                    continue
                if slot.respawn_at is not None:
                    if now >= slot.respawn_at:
                        self._spawn(slot)
                    continue
                proc = slot.proc
                rc = proc.exitcode
                if rc is not None:
                    self._interrupt(slot, "crash", rc)
                    continue
                started_s = now - slot.launched_mono
                age = heartbeat_age(slot.spec["heartbeat_path"],
                                    slot.launched_unix, started_s)
                if age is not None and age > self.hang_timeout_s:
                    # no SIGTERM courtesy for a hung worker: it may be
                    # wedged past signal delivery; its connections die
                    # with it and the clients' retry path routes around
                    proc.kill()
                    proc.join(timeout=2.0)
                    self._interrupt(slot, "hang", -signal.SIGKILL)
                    continue
                if self.rss_limit_kb and rss_kb(proc.pid) > \
                        self.rss_limit_kb:
                    proc.kill()
                    proc.join(timeout=2.0)
                    self._interrupt(slot, "leak", -signal.SIGKILL)
                    continue
                # sustained liveness heals the streak: 10x the hang
                # timeout without an incident is "the environment
                # recovered", not luck
                if (slot.policy.failures
                        and started_s > 10.0 * self.hang_timeout_s):
                    slot.policy.record_success()
            self._stop.wait(_POLL_S)

    # -- reporting -------------------------------------------------------------

    def worker_rows(self) -> list[dict]:
        """Per-slot liveness rows for the run report's worker table."""
        rows = []
        for slot in self.slots:
            payload = self._hb_payload(slot)
            proc = slot.proc
            age = heartbeat_age(
                slot.spec["heartbeat_path"], slot.launched_unix,
                time.monotonic() - slot.launched_mono) \
                if proc is not None else None
            rows.append({
                "worker": slot.spec["worker_id"],
                "pid": proc.pid if proc is not None else None,
                "alive": bool(proc is not None and proc.is_alive()),
                "parked": slot.parked,
                "restarts": slot.restarts,
                "requests": payload.get("requests"),
                "generation": payload.get("slot"),
                "rss_kb": payload.get("rss_kb"),
                "hb_age_s": round(age, 3) if age is not None else None,
            })
        return rows

    def _read_stats(self, slot: _Slot) -> dict | None:
        try:
            with open(slot.spec["stats_path"]) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def summary(self) -> dict:
        """Pool-level aggregate: live worker stats + folded-in totals
        from dead incarnations + the interruption ledger."""
        agg = {"by_status": {}, "requests_total": 0, "scheme_builds": 0,
               "sf_leads": 0, "sf_waits": 0, "slow_loris_closed": 0,
               "conn_rejected": 0}
        per_worker = []
        for slot in self.slots:
            stats = self._read_stats(slot)
            summary = (stats or {}).get("summary") or {}
            sf = (stats or {}).get("singleflight_process") or {}
            for k, v in (summary.get("by_status") or {}).items():
                agg["by_status"][k] = agg["by_status"].get(k, 0) + v
            agg["requests_total"] += int(summary.get("requests_total")
                                         or 0)
            agg["scheme_builds"] += int(summary.get("scheme_builds")
                                        or 0)
            agg["slow_loris_closed"] += int(
                summary.get("slow_loris_closed") or 0)
            agg["conn_rejected"] += int(summary.get("conn_rejected")
                                        or 0)
            agg["sf_leads"] += int(sf.get("leads") or 0)
            agg["sf_waits"] += int(sf.get("waits") or 0)
            # dead incarnations' folded totals
            t = slot.totals
            for k, v in (t.get("by_status") or {}).items():
                agg["by_status"][k] = agg["by_status"].get(k, 0) + v
            agg["requests_total"] += t.get("requests_total", 0)
            agg["scheme_builds"] += t.get("scheme_builds", 0)
            agg["sf_leads"] += t.get("sf_leads", 0)
            agg["sf_waits"] += t.get("sf_waits", 0)
            agg["slow_loris_closed"] += t.get("slow_loris_closed", 0)
            agg["conn_rejected"] += t.get("conn_rejected", 0)
            per_worker.append({"worker": slot.spec["worker_id"],
                               "summary": summary})
        by_reason: dict[str, int] = {}
        with self._lock:
            interruptions = list(self.interruptions)
        for rec in interruptions:
            by_reason[rec["reason"]] = by_reason.get(rec["reason"], 0) + 1
        return {
            "workers": self.worker_rows(),
            "aggregate": agg,
            "interruptions": interruptions,
            "interruptions_by_reason": by_reason,
            "restarts": sum(s.restarts for s in self.slots),
            "chaos_kills_delivered": self.chaos_kills_delivered,
            "parked": sum(1 for s in self.slots if s.parked),
            "health": (self.board.read_health()
                       if self.board is not None else []),
        }
