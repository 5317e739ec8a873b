"""The multi-process serving scenario, runnable from one call.

``run_mp_scenario`` stands up the whole plane — shared-memory view
board, a supervised :class:`WorkerPool` of SO_REUSEPORT worker
processes, a live view publisher, a health-routed :class:`Balancer`,
and the pipelined :class:`SwarmLoadGenerator` — drives it at the
requested rate under seeded process-level chaos (worker SIGKILLs,
heartbeat wedges, an fd-exhaustion window), then tears everything down
and returns one self-judging result dict.

Its callers in the port: ``python -m pos_evolution_tpu_torch.serve_demo
--mp`` and ``chip_smoke.py``.

The verdict bar (what "the plane survives chaos" means here):

- **accounting**: every scheduled arrival resolves — answered, retried
  to resolution, or recorded ``lost``; records == schedule, always;
- **integrity**: zero bulk-proof verification failures — overload may
  shed, it may NEVER corrupt;
- **goodput**: interactive goodput and p99 stay inside the SLO while
  workers are being killed and wedged under them;
- **supervision**: every armed kill shows up in the pool's interruption
  ledger as a crash, every wedge is caught by hang detection, and every
  respawned worker serves from the CURRENT shared-memory generation
  (a respawn that serves a stale view is a silent fork);
- **observability**: the fleet metrics scraped off the admission-exempt
  ``metrics`` RPC agree with the loadgen's own ledger — per-worker
  request counts sum to the arrivals actually sent, within resends,
  shed retries, and the beat-interval a SIGKILLed incarnation loses.

With ``trace_rate > 0`` a seeded fraction of arrivals carry a trace id
end to end (``telemetry/tracing.py``); every process in the plane —
this one included — writes its spans to ``<run_dir>/trace/`` for
``scripts/trace_merge.py`` to stitch into one Chrome trace.

The port's differences from the JAX package's module: ``device`` (CUDA
unless the caller asks for the CPU) is the workers' scheme device and
the blob engine's; on CUDA the parent builds the proof path's kernels
(K6 and K2) before it spawns, so that no worker runs ``nvcc``; and the
result's ``kernel_launches`` sums ``kernel_launches_total`` by kernel
over the scraped fleet, the launches the workers made; ``ready_s`` is
the seconds from the pool's start to every worker's first beat after
boot; the load runs with the heap built before it (torch's) in the
collector's permanent generation (``gc.freeze``).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import socket
import tempfile
import threading
import time

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.serve.balancer import Balancer, SwarmLoadGenerator
from pos_evolution_tpu_torch.serve.chaos import FdExhaustSwarm, ServeChaos
from pos_evolution_tpu_torch.serve.protocol import (
    ProtocolError,
    recv_frame,
    send_frame,
)
from pos_evolution_tpu_torch.serve.shm import ShmViewBoard
from pos_evolution_tpu_torch.serve.state import ServeView
from pos_evolution_tpu_torch.serve.workers import WorkerPool, worker_spec
from pos_evolution_tpu_torch.telemetry import tracing

__all__ = ["run_mp_scenario"]

SCHEMA = 1


class _Sidecar:
    __slots__ = ("cells", "commitment")

    def __init__(self, cells, commitment):
        self.cells = cells
        self.commitment = commitment


def _scrape_metrics(addrs: list[tuple[str, int]]) -> dict | None:
    """One ``metrics`` RPC against the first front that answers: the
    fleet view is the same whichever worker serves it (every worker
    aggregates the shared snapshot directory)."""
    for addr in addrs:
        try:
            with socket.create_connection(addr, timeout=3.0) as s:
                s.settimeout(3.0)
                send_frame(s, {"id": 1, "method": "metrics",
                               "params": {}, "deadline_ms": 2500.0,
                               "tier": 0})
                resp = recv_frame(s)
        except (OSError, ProtocolError):
            continue
        if isinstance(resp, dict) and resp.get("status") == "ok":
            return resp.get("result")
    return None


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def kernel_launches(prometheus: str) -> dict[str, int]:
    """``kernel_launches_total`` summed by kernel over the workers'
    series of a fleet's Prometheus text."""
    out: dict[str, int] = {}
    for line in prometheus.splitlines():
        if not line.startswith("kernel_launches_total{"):
            continue
        labels, value = line[len("kernel_launches_total{"):].rsplit("}", 1)
        kernel = dict(p.split("=", 1) for p in labels.split(",")
                      )["kernel"].strip('"')
        out[kernel] = out.get(kernel, 0) + int(float(value))
    return out


def _make_view(engine, slot: int, n_blobs: int) -> tuple[ServeView, bytes]:
    root = bytes([slot % 251 + 1]) * 32
    grids, coms, _ = engine.build_for(n_blobs, root)
    sidecars = [_Sidecar(grids[i], bytes(coms[i])) for i in range(n_blobs)]
    view = ServeView(
        slot=slot, head_root=root, head_slot=slot,
        justified_epoch=max(slot // 8 - 1, 0), justified_root=b"\x01" * 32,
        finalized_epoch=max(slot // 8 - 2, 0), finalized_root=b"\x02" * 32,
        update_ssz=b"\x00" * 64, update_root=b"\x03" * 32,
        sidecars={root: sidecars},
        n_cells=n_blobs * cfg().das_cells_per_blob)
    return view, root


def run_mp_scenario(
        *, n_fronts: int = 2, workers_per_front: int = 2,
        arrivals: int = 60000, rate: float = 20000.0, seed: int = 0,
        bulk_fraction: float = 0.05, samples_per_request: int = 4,
        n_blobs: int = 2, publish_every_s: float = 0.5,
        kills: int = 2, wedges: int = 1, wedge_s: float = 4.0,
        fd_exhaust_n: int = 0, fd_exhaust_hold_s: float = 1.0,
        hang_timeout_s: float = 3.0, rss_limit_mb: float = 0.0,
        backoff_s: float = 0.15, backoff_cap_s: float = 1.0,
        conns_per_front: int = 4, slo_ms: float = 300.0,
        ready_grace_s: float = 8.0, worker_threads: int = 2,
        run_dir: str | None = None, events_bus=None,
        trace_rate: float = 0.0, trace_seed: int | None = None,
        trace_dir: str | None = None, device: str = "cuda") -> dict:
    """Run one seeded multi-process serving scenario end to end.

    ``kills`` / ``wedges`` are process-level injections: SIGKILLs
    delivered by the pool's watch loop on the chaos schedule, and
    heartbeat-wedge windows the worker itself honors (it keeps serving
    but stops beating — the liveness lie hang detection must catch).
    ``fd_exhaust_n`` holds that many idle connections against front 0
    for ``fd_exhaust_hold_s`` mid-run. Everything is a pure function of
    ``seed``, so a scenario replays.
    """
    own_dir = run_dir is None
    if own_dir:
        run_dir = tempfile.mkdtemp(prefix="serve_mp_")
    os.makedirs(run_dir, exist_ok=True)
    lock_path = os.path.join(run_dir, "board.lock")
    duration_s = arrivals / float(rate)
    if trace_rate <= 0.0:
        trace_dir = None
    else:
        # an explicit trace_dir lets two phases (steady + chaos, each
        # with its own run_dir so their fleet snapshots never mix) pour
        # spans into ONE directory for a single merged timeline
        if trace_dir is None:
            trace_dir = os.path.join(run_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        # the harness process records the client-side spans (dispatch,
        # balancer pick, resolution) — workers install their own sinks
        tracing.install_buffer(trace_dir, proc="loadgen")

    from pos_evolution_tpu_torch.das import BlobEngine
    engine = BlobEngine(cfg(), seed=seed + 11, device=device)
    view, root = _make_view(engine, 7, n_blobs)
    if engine.device.type == "cuda":
        from pos_evolution_tpu_torch.ops import kernels
        kernels.build_all(["sha256_blocks", "merkle_level"])

    n_workers = n_fronts * workers_per_front
    board = ShmViewBoard.create(lock_path, n_fronts=max(n_workers, 16))
    result: dict = {"schema": SCHEMA, "seed": seed, "arrivals": arrivals,
                    "rate": rate, "fronts": n_fronts,
                    "workers": n_workers}
    pool = publisher = loris = None
    stop_pub = threading.Event()
    try:
        board.publish(view)
        ports = _free_ports(n_fronts)
        chaos = ServeChaos(seed=seed)
        # wedge windows live in UNIX time (they cross the process
        # boundary into spawn specs); the load run is then ALIGNED to
        # the same origin by sleeping out the remainder of the grace
        # window after the pool reports ready
        start_unix = time.time() + ready_grace_s
        wedge_map = (chaos.wedge_windows(start_unix, duration_s, wedges,
                                         wedge_s, n_workers)
                     if wedges > 0 else {})
        cfg_dict = dataclasses.asdict(cfg())
        specs = [
            worker_spec(
                i, ports[i % n_fronts], board.name, lock_path, run_dir,
                threads=worker_threads, config=cfg_dict,
                trace_dir=trace_dir, device=device,
                chaos=({"wedge_windows": wedge_map[i]}
                       if i in wedge_map else None))
            for i in range(n_workers)]
        pool = WorkerPool(specs, board, hang_timeout_s=hang_timeout_s,
                          rss_limit_mb=rss_limit_mb,
                          backoff_s=backoff_s,
                          backoff_cap_s=backoff_cap_s, seed=seed,
                          events_bus=events_bus, chaos=chaos)
        pool.start()
        if not pool.wait_ready(max(ready_grace_s * 4, 30.0)):
            raise RuntimeError("worker pool never became ready")
        result["ready_s"] = round(time.time() - start_unix + ready_grace_s, 3)
        ready_lag = time.time() - start_unix
        if ready_lag > 0:
            # pool took longer than the grace window: wedge windows
            # skew early relative to the load run — recorded, not fatal
            result["wedge_skew_s"] = round(ready_lag, 3)
        else:
            time.sleep(-ready_lag)

        # live publisher: a fresh generation every publish_every_s for
        # the whole run, so workers (including respawned ones) must
        # FOLLOW the board, not serve their spawn-time view
        def _publish_loop() -> None:
            slot = 8
            while not stop_pub.wait(publish_every_s):
                # same root + sidecars (bulk requests stay valid across
                # the whole run); the advancing slot is what proves a
                # worker is FOLLOWING generations rather than caching
                board.publish(ServeView(
                    slot=slot, head_root=root, head_slot=slot,
                    justified_epoch=max(slot // 8 - 1, 0),
                    justified_root=b"\x01" * 32,
                    finalized_epoch=max(slot // 8 - 2, 0),
                    finalized_root=b"\x02" * 32,
                    update_ssz=b"\x00" * 64, update_root=b"\x03" * 32,
                    sidecars=view.sidecars, n_cells=view.n_cells))
                slot += 1

        publisher = threading.Thread(target=_publish_loop,
                                     name="mp-publisher", daemon=True)
        publisher.start()

        slot_map = [[i for i in range(n_workers) if i % n_fronts == j]
                    for j in range(n_fronts)]
        balancer = Balancer(n_fronts, board=board, slot_map=slot_map,
                            metrics_dir=run_dir)
        targets = {"roots": [root.hex()],
                   "n_cells": n_blobs * cfg().das_cells_per_blob,
                   "n_blobs": {root.hex(): n_blobs}}
        gen = SwarmLoadGenerator(
            [("127.0.0.1", p) for p in ports], arrivals, rate,
            balancer=balancer, conns_per_front=conns_per_front,
            seed=seed, bulk_fraction=bulk_fraction,
            samples_per_request=samples_per_request,
            targets_fn=lambda: targets,
            trace_rate=trace_rate, trace_seed=trace_seed)

        if kills > 0:
            chaos.arm_worker_kills(time.monotonic(), duration_s, kills,
                                   n_workers)
        if fd_exhaust_n > 0:
            loris = FdExhaustSwarm(("127.0.0.1", ports[0]),
                                   n=fd_exhaust_n,
                                   hold_s=fd_exhaust_hold_s)
            offset = 0.2 * duration_s
            threading.Timer(offset, loris.start).start()

        # the load runs in this process beside torch's heap: a full
        # collection walks it with the dispatcher and every reader
        # stopped, so the heap built so far sits out the run in the
        # collector's permanent generation
        gc.freeze()
        try:
            load = gen.run()
        finally:
            gc.unfreeze()

        # settle: a wedge is only DETECTABLE hang_timeout_s after its
        # window opens, and a respawn needs its backoff + spawn time —
        # the watch loop keeps running here, so wait out the chaos
        # that is still scheduled to land before judging
        stop_pub.set()
        publisher.join(timeout=3.0)
        wedge_hi = max((hi for ws in wedge_map.values()
                        for _lo, hi in ws), default=time.time())
        settle_unix = (max(wedge_hi, time.time()) + hang_timeout_s
                       + backoff_cap_s + 2.5)
        while time.time() < settle_unix:
            snap = pool.summary()
            reasons = snap["interruptions_by_reason"]
            rows = snap["workers"]
            if (reasons.get("hang", 0) >= wedges
                    and snap["chaos_kills_delivered"] >= min(
                        kills, n_workers)
                    and all(r["alive"] or r["parked"] for r in rows)):
                break
            time.sleep(0.15)
        # generation convergence: with the publisher stopped, every
        # live worker's follow loop must land on the final generation
        board_gen, _v = board.current()
        gen_deadline = time.monotonic() + 3.0
        while time.monotonic() < gen_deadline:
            rows = pool.worker_rows()
            live = [r for r in rows if r["alive"]]
            if live and all(r.get("generation") == board_gen
                            for r in live):
                break
            time.sleep(0.1)
        pool_sum = pool.summary()
        result["load"] = load
        result["pool"] = pool_sum
        result["chaos"] = chaos.summary()
        result["board_generation"] = board_gen
        if loris is not None:
            loris.stop()
            result["fd_exhaust"] = {"connected": loris.connected,
                                    "refused": loris.refused}
        # fleet scrape: after settle every surviving
        # worker has flushed ≥1 beat since the last response, so the
        # merged registry is the plane's complete request ledger (less
        # at most one beat-interval per SIGKILLed incarnation)
        time.sleep(0.4)  # one beat + slack: let the final beats land
        scraped = _scrape_metrics([("127.0.0.1", p) for p in ports])
        if scraped is not None:
            result["fleet"] = scraped.get("fleet")
            result["fleet_prometheus"] = scraped.get("prometheus")
            result["kernel_launches"] = kernel_launches(
                scraped.get("prometheus") or "")
        if trace_dir is not None:
            buf = tracing.get_buffer()
            if buf is not None:
                buf.flush()
            result["trace_dir"] = trace_dir
        result["beat_s"] = 0.25
        result["verdict"] = _judge(result, kills, wedges, slo_ms)
    finally:
        stop_pub.set()
        if publisher is not None:
            publisher.join(timeout=3.0)
        if loris is not None:
            loris.stop()
        if pool is not None:
            pool.stop()
        board.close()
    return result


def _judge(result: dict, kills: int, wedges: int, slo_ms: float) -> dict:
    load = result["load"]
    pool = result["pool"]
    inter = load["tiers"]["interactive"]
    by_reason = pool["interruptions_by_reason"]
    kills_fired = result["chaos"]["injections"].get(
        "worker_kill_fired", 0)
    kills_delivered = pool.get("chaos_kills_delivered", 0)
    # a SIGKILLed worker surfaces as a crash interruption; a wedged one
    # as a hang (the pool could not tell it was lying, only that the
    # heartbeat stopped — which is the point)
    crashes = by_reason.get("crash", 0)
    hangs = by_reason.get("hang", 0)
    # every live worker ends on the board's current generation: a
    # respawned worker serving an old view would be a silent fork
    board_gen = result["board_generation"]
    live_rows = [r for r in pool["workers"] if r["alive"]]
    current = all(r.get("generation") == board_gen for r in live_rows)
    verdict = {
        "records_match_schedule": load["arrivals"] == result["arrivals"],
        "interactive_goodput_pct": inter["goodput_pct"],
        "goodput_ok": (inter["goodput_pct"] or 0) >= 99.0,
        "interactive_p99_ms": inter["p99_ms"],
        "slo_ms": slo_ms,
        "slo_ok": (inter["p99_ms"] is not None
                   and inter["p99_ms"] <= slo_ms),
        "verified_proofs": load.get("verified_proofs"),
        "verify_failures": load.get("verify_failures", 0),
        "integrity_ok": load.get("verify_failures", 0) == 0,
        "lost": load.get("lost", 0),
        "resends": load.get("resends", 0),
        "kills_armed": kills, "kills_fired": kills_fired,
        "kills_delivered": kills_delivered,
        "crash_interruptions": crashes,
        "kills_detected": (kills_delivered >= kills
                           and crashes >= kills_delivered),
        "wedges_armed": wedges, "hang_interruptions": hangs,
        "wedges_detected": hangs >= min(wedges, 1),
        "restarts": pool["restarts"],
        "respawned_on_current_generation": current,
        "live_workers": len(live_rows),
    }
    # fleet-consistency: the per-worker request
    # counters scraped off the metrics RPC must sum to what the loadgen
    # actually sent. Over-count allowance: resends and shed retries put
    # the same arrival on a second worker; the scrape itself counts
    # once. Under-count allowance: a ``lost`` arrival may never have
    # reached a worker, and each SIGKILLed incarnation keeps only its
    # last beat-flushed counts (≤ ~2 beat-intervals of its share of
    # the arrival rate).
    fleet_view = result.get("fleet")
    if fleet_view is not None:
        by_worker = fleet_view.get("requests_by_worker") or {}
        fleet_sum = sum(float(v) for v in by_worker.values())
        arrivals = result["arrivals"]
        incarnations_killed = (kills_delivered
                               + by_reason.get("hang", 0)
                               + by_reason.get("rss", 0))
        kill_slack = (incarnations_killed * result["rate"]
                      / max(result["workers"], 1)
                      * 2.0 * result.get("beat_s", 0.25))
        lo = arrivals - load.get("lost", 0) - kill_slack - 8
        hi = (arrivals + load.get("resends", 0)
              + load.get("shed_retries", 0) + kill_slack + 8)
        verdict["fleet_requests_by_worker"] = dict(by_worker)
        verdict["fleet_requests_total"] = fleet_sum
        verdict["fleet_window"] = [round(lo, 1), round(hi, 1)]
        verdict["fleet_workers_reporting"] = len(by_worker)
        verdict["fleet_consistent"] = bool(lo <= fleet_sum <= hi)
    else:
        verdict["fleet_consistent"] = False
    verdict["ok"] = bool(
        verdict["records_match_schedule"] and verdict["goodput_ok"]
        and verdict["slo_ok"] and verdict["integrity_ok"]
        and verdict["kills_detected"] and verdict["wedges_detected"]
        and verdict["respawned_on_current_generation"]
        and verdict["fleet_consistent"])
    return verdict
