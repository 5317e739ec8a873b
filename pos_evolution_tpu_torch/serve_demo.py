"""Serving-tier demo: real socket traffic against the hardened RPC front.

A DAS-enabled spec-driver run records one ``ServeView`` a slot, then a
multi-worker ``serve.ServeFront`` serves them over sockets while a seeded
**open-loop** load generator drives head/finality/update and cell-sampling
traffic at it, in two phases:

1. **steady state**: uniform arrivals, no chaos; interactive p99 must
   land inside the SLO;
2. **chaos**: 10x burst windows, seeded worker stalls, proof-cache wipes
   at block boundaries, a backing-store outage window and a slow-loris
   swarm; the tier must shed with honest rejections instead of
   collapsing (interactive goodput > 95%), and **every proof served must
   still verify**.

Every ``das_cells`` proof is built on the run's device, through the
merkle scheme's K6 (the cell leaves) and K2 (the tree levels) on the
card.

Usage:
    python -m pos_evolution_tpu_torch.serve_demo [--arrivals 100000]
        [--rate 6000] [--workers 4] [--validators 32] [--epochs 2]
        [--slo-ms 50] [--pattern hotspot] [--no-chaos] [--seed 7]
        [--device cuda|cpu] [--mainnet]
        [--events events.jsonl] [--json bench_serve.json]
        [--history bench_history.jsonl] [--record N]

``--mainnet`` runs under the mainnet config with the PeerDAS geometry
(``sim/driver.PEERDAS``: 9 blobs a block, 128 extended cells of 2,048
bytes), so ``--validators 65536 --mainnet`` is the full-width run; the
default is the minimal config. The recording run uses the resident fork
choice (``accelerated_forkchoice=True``), as the driver's entry point
does.

``--mp`` switches to the **multi-process** plane: shared-memory
``ShmViewBoard`` view publication, a supervised ``WorkerPool`` of
SO_REUSEPORT worker processes (each building its proofs on ``--device``)
across ``--fronts`` listeners, a health-routed ``Balancer`` and the
pipelined ``SwarmLoadGenerator``, driven at 20,000/s by default while
seeded chaos SIGKILLs workers, wedges heartbeats and exhausts fds. The
run fails unless the harness verdict is ok: goodput >= 99%, p99 inside
the SLO, zero verify failures, every kill and wedge detected, every
respawned worker on the current shared-memory generation, and the fleet
metrics scraped off the ``metrics`` RPC consistent with the loadgen's
ledger. ``--trace-rate``/``--trace-dir`` switch on end-to-end request
tracing (``python -m pos_evolution_tpu_torch.trace_merge`` joins the span
files); ``--metrics-out`` saves the fleet Prometheus text; ``--run-dir``
keeps each phase's worker heartbeats and fleet snapshots
(``python -m pos_evolution_tpu_torch.obs_top --dir RUN_DIR/chaos --once``).

The card's name and power limit are printed beside the numbers. Any
failed contract exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

# torch and the port are imported inside the functions: worker processes
# spawned by ``--mp`` import this module as their main module, and their
# boot beat must not wait for torch


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"serve_demo: {what}")


def _replay(state, views, duration_s: float, stop: threading.Event) -> None:
    """Publish recorded views evenly across the load window: every
    publish is a block boundary (new cache keys, chaos wipe hook)."""
    if not views:
        return
    gap = duration_s / len(views)
    for view in views:
        if stop.is_set():
            return
        state.publish(view)
        stop.wait(gap)


def _targets_fn(state):
    def fn():
        view = state.current()
        if view is None:
            return {"roots": [], "n_cells": 0, "n_blobs": {}}
        return {"roots": [r.hex() for r in view.sidecars],
                "n_cells": view.n_cells,
                "n_blobs": {r.hex(): len(s)
                            for r, s in view.sidecars.items()}}
    return fn


def _verify_update_fn():
    from pos_evolution_tpu_torch.lightclient.containers import LightClientUpdate
    from pos_evolution_tpu_torch.ssz import deserialize, hash_tree_root

    def verify(result: dict) -> bool:
        if result.get("update") is None:
            return True  # "no update yet" is honest, not a violation
        data = bytes.fromhex(result["update"])
        obj = deserialize(data, LightClientUpdate)
        return bytes(hash_tree_root(obj)).hex() == result["update_root"]
    return verify


def _emit_artifacts(args, emission: dict, kind: str) -> None:
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(emission, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"emission -> {args.json}")
    if args.record is not None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            f"SERVE_DEMO_r{args.record:02d}.json")
        with open(path, "w") as fh:
            json.dump(emission, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"record   -> {path}")
    if args.history:
        from pos_evolution_tpu_torch.profiling import history
        history.append_entry(args.history, emission, kind=kind)
        print(f"history  -> {args.history} (kind={kind})")


def _phase_line(tag: str, result: dict) -> None:
    load, verdict = result["load"], result["verdict"]
    inter = load["tiers"]["interactive"]
    bulk = load["tiers"]["bulk"]
    print(f"{tag}: interactive p50 {inter['p50_ms']} ms / "
          f"p99 {inter['p99_ms']} ms, goodput {inter['goodput_pct']}% "
          f"| bulk goodput {bulk['goodput_pct']}% | wall "
          f"{load['wall_s']}s | resends {verdict['resends']}, "
          f"lost {verdict['lost']} | worker kernel launches "
          f"{json.dumps(result.get('kernel_launches'))}")


def _main_mp(args, telemetry, dev, card: str) -> int:
    """The multi-process plane in two phases: a **steady** SLO phase at
    the full rate with no injections, then a **chaos** phase where
    workers are SIGKILLed and wedged mid-traffic; each phase is one
    ``run_mp_scenario`` call and must return a clean verdict."""
    from pos_evolution_tpu_torch.serve import run_mp_scenario
    t_start = time.perf_counter()
    n_workers = args.fronts * args.workers_per_front
    chaos_on = not args.no_chaos
    print(f"== mp serving demo [{card}]: steady {args.arrivals} arrivals @ "
          f"{args.rate:.0f}/s"
          + (f" + chaos {args.chaos_arrivals} @ "
             f"{args.chaos_rate:.0f}/s" if chaos_on else "")
          + f", {args.fronts} fronts x {args.workers_per_front} worker "
          f"processes on {dev}, seed={args.seed} ==")
    telemetry.bus.emit(
        "serve_mp_attach", fronts=args.fronts, workers=n_workers,
        arrivals=args.arrivals, rate=args.rate,
        chaos=({"seed": args.seed, "arrivals": args.chaos_arrivals,
                "rate": args.chaos_rate, "kills": args.kills,
                "wedges": args.wedges, "fd_exhaust": args.fd_exhaust}
               if chaos_on else None))

    trace_dir = None
    if args.trace_rate > 0:
        trace_dir = args.trace_dir or tempfile.mkdtemp(
            prefix="serve_mp_trace_")
        os.makedirs(trace_dir, exist_ok=True)

    # phase 1: steady state at the headline rate, the SLO phase
    steady = run_mp_scenario(
        n_fronts=args.fronts, workers_per_front=args.workers_per_front,
        arrivals=args.arrivals, rate=args.rate, seed=args.seed,
        kills=0, wedges=0, fd_exhaust_n=0, slo_ms=args.slo_ms,
        events_bus=telemetry.bus, trace_rate=args.trace_rate,
        trace_dir=trace_dir, device=str(dev), run_dir=_phase_dir(args, "steady"))
    _phase_line("steady", steady)
    s_verdict = steady["verdict"]

    # phase 2: process chaos (SIGKILLs, a heartbeat wedge and an
    # fd-exhaustion window against front 0), at a rate the survivors can
    # absorb while their peers respawn
    chaos = None
    if chaos_on:
        chaos = run_mp_scenario(
            n_fronts=args.fronts,
            workers_per_front=args.workers_per_front,
            arrivals=args.chaos_arrivals, rate=args.chaos_rate,
            seed=args.seed, kills=args.kills, wedges=args.wedges,
            fd_exhaust_n=args.fd_exhaust, slo_ms=args.slo_ms,
            events_bus=telemetry.bus, trace_rate=args.trace_rate,
            trace_dir=trace_dir, device=str(dev), run_dir=_phase_dir(args, "chaos"))
        _phase_line("chaos ", chaos)
        c_verdict = chaos["verdict"]
        print(f"pool:  {c_verdict['kills_delivered']} SIGKILLs "
              f"delivered ({c_verdict['crash_interruptions']} crash "
              f"interruptions), {c_verdict['hang_interruptions']} "
              f"hangs detected, {c_verdict['restarts']} respawns; "
              f"live workers on current generation: "
              f"{c_verdict['respawned_on_current_generation']}")

    verified = s_verdict["verified_proofs"] + (
        chaos["verdict"]["verified_proofs"] if chaos else 0)
    failures = s_verdict["verify_failures"] + (
        chaos["verdict"]["verify_failures"] if chaos else 0)
    print(f"SLO (steady interactive p99 <= {args.slo_ms} ms at "
          f"{args.rate:.0f}/s): "
          f"{'MET' if s_verdict['slo_ok'] else 'MISSED'}; verified "
          f"proofs {verified} (failures: {failures}) [{card}]")
    telemetry.bus.emit("serve_mp_summary", steady=steady, chaos=chaos)
    for tag, result in (("steady", steady),
                        ("chaos", chaos)) if chaos else (
                            ("steady", steady),):
        verdict = result["verdict"]
        detail = json.dumps({k: v for k, v in verdict.items()
                             if k != "ok"}, sort_keys=True)
        print(f"{tag} verdict: {'ok' if verdict['ok'] else 'FAILED'} "
              f"({detail})")

    s_inter = steady["load"]["tiers"]["interactive"]
    emission = {
        "metric": "bench_serve_mp",
        "card": card, "device": str(dev),
        "arrivals": args.arrivals + (args.chaos_arrivals
                                     if chaos_on else 0),
        "rate": args.rate,
        "fronts": args.fronts,
        "workers": n_workers,
        "seed": args.seed,
        "slo_ms": args.slo_ms,
        "slo_ok": s_verdict["slo_ok"],
        "serving": {
            "steady": {k: s_inter[k] for k in
                       ("p50_ms", "p99_ms", "p999_ms", "goodput_pct")},
            "verified_proofs": verified,
            "verify_failures": failures,
        },
        "board_generation": steady["board_generation"],
        "fleet": {
            "workers_reporting":
                s_verdict.get("fleet_workers_reporting"),
            "requests_by_worker":
                s_verdict.get("fleet_requests_by_worker"),
            "requests_total": s_verdict.get("fleet_requests_total"),
            "consistent": s_verdict.get("fleet_consistent"),
        },
        "kernel_launches": {"steady": steady.get("kernel_launches"),
                            "chaos": chaos.get("kernel_launches")
                            if chaos else None},
        "verdicts": {"steady": s_verdict,
                     "chaos": chaos["verdict"] if chaos else None},
        # seconds from the pool's start to every worker's first beat after
        # boot, and how far past the grace window that came (the wedges'
        # skew)
        "pool_ready_s": {tag: r.get("ready_s") for tag, r in
                         (("steady", steady), ("chaos", chaos)) if r},
        "wedge_skew_s": {tag: r.get("wedge_skew_s") for tag, r in
                         (("steady", steady), ("chaos", chaos)) if r},
        "elapsed_s": time.perf_counter() - t_start,
    }
    if trace_dir is not None:
        emission["traced"] = (steady["load"].get("traced", 0)
                              + (chaos["load"].get("traced", 0)
                                 if chaos else 0))
        emission["trace_dir"] = trace_dir
        print(f"traces   -> {trace_dir}")
    if args.metrics_out:
        prom = (chaos or steady).get("fleet_prometheus")
        if prom:
            with open(args.metrics_out, "w") as fh:
                fh.write(prom)
            print(f"metrics  -> {args.metrics_out}")
    if chaos is not None:
        c_inter = chaos["load"]["tiers"]["interactive"]
        c_bulk = chaos["load"]["tiers"]["bulk"]
        c_verdict = chaos["verdict"]
        emission["serving"]["chaos_interactive"] = {
            k: c_inter[k] for k in ("p50_ms", "p99_ms", "goodput_pct")}
        emission["serving"]["chaos_bulk"] = {
            "goodput_pct": c_bulk["goodput_pct"],
            "shed_pct": c_bulk["shed_pct"]}
        emission["serving"]["chaos_resends"] = c_verdict["resends"]
        emission["serving"]["chaos_lost"] = c_verdict["lost"]
        emission["chaos"] = {
            "arrivals": args.chaos_arrivals,
            "rate": args.chaos_rate,
            "injections": chaos["chaos"]["injections"],
            "fd_exhaust": chaos.get("fd_exhaust"),
        }
        emission["supervision"] = {
            "kills_delivered": c_verdict["kills_delivered"],
            "crash_interruptions": c_verdict["crash_interruptions"],
            "hang_interruptions": c_verdict["hang_interruptions"],
            "restarts": c_verdict["restarts"],
            "live_workers": c_verdict["live_workers"],
            "respawned_on_current_generation":
                c_verdict["respawned_on_current_generation"],
        }
    _emit_artifacts(args, emission, kind="bench_serve_mp")
    print(json.dumps(emission, sort_keys=True))
    if args.events:
        telemetry.close()
        print(f"events   -> {args.events}")
    _require(failures == 0,
             "a served proof failed verification: correctness violation")
    _require(s_verdict["ok"], "steady mp verdict failed")
    _require(chaos is None or chaos["verdict"]["ok"], "chaos mp verdict failed")
    return 0


def serve_views(views, scheme, *, arrivals: int, rate: float, workers: int = 4,
                pattern: str = "hotspot", seed: int = 7, chaos: bool = True,
                slo_ms: float = 50.0, device="cuda", telemetry=None) -> dict:
    """Serve recorded ``views`` from a ``ServeFront`` of ``workers``
    threads on ``scheme`` (proofs built on the scheme's device) under the
    two-phase open loop: ``arrivals // 2`` uniform arrivals at ``rate``,
    then the rest in ``pattern`` with, when ``chaos``, two 10x bursts, two
    worker stalls, proof-cache wipes at block boundaries, a backing outage
    and 8 slow-loris connections; the first half of the views replayed
    over the first phase, the rest over the second. Every served proof
    and update is verified (on ``device``). Returns the phases' load
    summaries, the front's summary and the contract's verdicts."""
    from pos_evolution_tpu_torch.serve import (
        LoadGenerator,
        ServeChaos,
        ServeClient,
        ServeFront,
        ServingState,
        SlowLorisSwarm,
    )
    from pos_evolution_tpu_torch.telemetry import Telemetry
    telemetry = telemetry if telemetry is not None else Telemetry()
    state = ServingState()
    state.publish(views[0])
    hazards = ServeChaos(seed, stall_prob=0.0, stall_s=0.08, wipe_prob=0.5) if chaos else None
    # read timeout below the loris dribble interval: a connection
    # stalled MID-frame longer than this is closed (real requests
    # arrive in one sendall; only an attacker dribbles)
    front = ServeFront(state, scheme=scheme, registry=telemetry.registry,
                       workers=workers, read_timeout_s=0.4, chaos=hazards)
    addr = front.start()
    n_steady = arrivals // 2
    n_chaos = arrivals - n_steady
    telemetry.bus.emit(
        "serve_attach", workers=workers, pattern=pattern, arrivals=arrivals, rate=rate,
        chaos=({"seed": seed, "stall_s": 0.08, "wipe_prob": 0.5, "bursts": 2,
                "slow_loris": 8} if chaos else None))
    try:
        # warmup: a short head burst before the SLO phase; the SLO is a
        # STEADY-STATE contract, and the first packets pay one-time costs
        warm = ServeClient(addr, connections=4)
        for _ in range(50):
            warm.request("head", deadline_s=1.0, tier=0)
        warm.close()

        # phase 1: steady state (the SLO phase)
        mid = max(len(views) // 2, 1)
        stop = threading.Event()
        replayer = threading.Thread(
            target=_replay, args=(state, views[1:mid], n_steady / rate, stop), daemon=True)
        replayer.start()
        steady = LoadGenerator(
            addr, n_steady, rate, pattern="uniform", seed=seed,
            targets_fn=_targets_fn(state), verify_update=_verify_update_fn(),
            device=device).run()
        stop.set()  # the load is done: no stale steady-phase publishes
        replayer.join(timeout=5.0)

        # phase 2: chaos (bursts + stalls + wipes + outage + loris)
        burst_windows = ()
        if hazards is not None:
            burst_windows = hazards.burst_windows(n_chaos / rate, n_bursts=2, mult=10.0,
                                                  width_frac=0.05)
        chaos_gen = LoadGenerator(
            addr, n_chaos, rate, pattern=pattern, seed=seed + 1,
            burst_windows=burst_windows, targets_fn=_targets_fn(state),
            verify_update=_verify_update_fn(), device=device)
        # 10x bursts COMPRESS the realized schedule, so injections are
        # armed against the actual span of the generated arrivals
        span = float(chaos_gen.offsets[-1])
        loris = outage = None
        if hazards is not None:
            # two seeded worker-stall windows inside the active span, each
            # freezing one of the workers for half a second
            hazards.arm_stalls(time.monotonic(), span * 0.8, n_stalls=2, stall_s=0.5,
                               workers=workers)
            loris = SlowLorisSwarm(addr, n=8, dribble_s=0.6)
            loris.start()
            # backing outage in the middle of the chaos window
            outage = threading.Timer(span * 0.4, hazards.fail_backing_for, (0.4,))
            outage.start()
        stop = threading.Event()
        replayer = threading.Thread(
            target=_replay, args=(state, views[mid:], span, stop), daemon=True)
        replayer.start()
        try:
            chaos_load = chaos_gen.run()
        finally:
            stop.set()
            replayer.join(timeout=5.0)
            if outage is not None:
                outage.cancel()
            if loris is not None:
                loris.stop()
        server = front.summary()
    finally:
        front.stop()
    s_int = steady["tiers"]["interactive"]
    c_int = chaos_load["tiers"]["interactive"]
    out = {
        "steady": steady, "chaos": chaos_load, "server": server,
        "hazards": hazards.summary() if hazards is not None else None,
        "verified_proofs": steady["verified_proofs"] + chaos_load["verified_proofs"],
        "verify_failures": steady["verify_failures"] + chaos_load["verify_failures"],
        "slo_ms": slo_ms,
        "slo_ok": (s_int["p99_ms"] or 0) <= slo_ms,
        "interactive_goodput_pct": c_int["goodput_pct"] or 0.0,
    }
    out["goodput_ok"] = out["interactive_goodput_pct"] > 95.0
    return out


def _phase_dir(args, phase: str) -> str | None:
    """``--run-dir``'s directory for one ``--mp`` phase (None: the harness
    makes a temp dir)."""
    return os.path.join(args.run_dir, phase) if args.run_dir else None


def _main_classic(args, telemetry, dev, card: str) -> int:
    from pos_evolution_tpu_torch.sim import Simulation

    print(f"== serving demo [{card}]: {args.arrivals} arrivals @ "
          f"{args.rate:.0f}/s, {args.workers} workers, "
          f"chaos={'off' if args.no_chaos else 'on'}, "
          f"{args.validators} validators on {dev} ==")
    # 1. record the chain and the per-slot serving views
    t0 = time.perf_counter()
    sim = Simulation(args.validators, accelerated_forkchoice=True, das=True,
                     serve=True, telemetry=telemetry, device=dev)
    sim.run_epochs(args.epochs)
    record_s = time.perf_counter() - t0
    views = sim.serving_state.views
    _require(bool(views), "the simulation never published a serving view")
    print(f"recorded {len(views)} serving views "
          f"({sum(len(v.sidecars) for v in views)} windowed blob "
          f"blocks) in {record_s:.3f} s")

    # 2. the live front over the replayed view stream, in two phases
    res = serve_views(views, sim.das.scheme, arrivals=args.arrivals, rate=args.rate,
                      workers=args.workers, pattern=args.pattern, seed=args.seed,
                      chaos=not args.no_chaos, slo_ms=args.slo_ms, device=dev,
                      telemetry=telemetry)
    steady, chaos_load, server_summary = res["steady"], res["chaos"], res["server"]
    s_int = steady["tiers"]["interactive"]
    c_int = chaos_load["tiers"]["interactive"]
    c_blk = chaos_load["tiers"]["bulk"]
    print(f"steady: interactive p50 {s_int['p50_ms']} ms / "
          f"p99 {s_int['p99_ms']} ms / p999 {s_int['p999_ms']} ms, "
          f"goodput {s_int['goodput_pct']}%")
    print(f"chaos:  interactive p50 {c_int['p50_ms']} ms / "
          f"p99 {c_int['p99_ms']} ms, goodput {c_int['goodput_pct']}%"
          f" | bulk goodput {c_blk['goodput_pct']}%, "
          f"shed {c_blk['shed_pct']}%")

    # 3. the acceptance contract
    verified, failures = res["verified_proofs"], res["verify_failures"]
    honest_rejects = (server_summary["by_status"].get("shed", 0)
                      + server_summary["by_status"].get("unavailable", 0)
                      + server_summary["by_status"].get("timeout", 0))
    print(f"verified proofs: {verified} (failures: {failures}); "
          f"honest rejections: {honest_rejects} "
          f"(shed/unavailable/timeout); hedges: "
          f"{steady['hedges'] + chaos_load['hedges']}; scheme builds "
          f"{server_summary['scheme_builds']}")
    print(f"SLO (steady interactive p99 <= {args.slo_ms} ms): "
          f"{'MET' if res['slo_ok'] else 'MISSED'}; chaos interactive "
          f"goodput {res['interactive_goodput_pct']}% [{card}]")

    load_combined = dict(chaos_load)
    load_combined["arrivals"] = steady["arrivals"] + chaos_load["arrivals"]
    load_combined["verified_proofs"] = verified
    load_combined["verify_failures"] = failures
    load_combined["hedges"] = steady["hedges"] + chaos_load["hedges"]
    load_combined["retries"] = steady["retries"] + chaos_load["retries"]
    load_combined["wall_s"] = round(steady["wall_s"] + chaos_load["wall_s"], 3)
    telemetry.bus.emit(
        "serve_summary", server=server_summary, load=load_combined,
        chaos=res["hazards"], steady=steady, slo_ms=args.slo_ms, slo_ok=res["slo_ok"])

    emission = {
        "metric": "bench_serve",
        "card": card, "device": str(dev),
        "validators": args.validators, "mainnet": args.mainnet,
        "views": len(views), "record_s": record_s,
        "arrivals": args.arrivals,
        "rate": args.rate,
        "workers": args.workers,
        "pattern": args.pattern,
        "chaos": not args.no_chaos,
        "slo_ms": args.slo_ms,
        "slo_ok": res["slo_ok"],
        "serving": {
            "steady": {k: s_int[k] for k in
                       ("p50_ms", "p99_ms", "p999_ms", "goodput_pct")},
            "chaos_interactive": {k: c_int[k] for k in
                                  ("p50_ms", "p99_ms", "goodput_pct")},
            "chaos_bulk": {"goodput_pct": c_blk["goodput_pct"],
                           "shed_pct": c_blk["shed_pct"]},
            "shed_rate": server_summary["shed_rate"],
            "verified_proofs": verified,
            "verify_failures": failures,
            "scheme_builds": server_summary["scheme_builds"],
            "singleflight_waits": server_summary["singleflight"]["waits"],
        },
        "telemetry": {"counts": telemetry.registry.counts()},
    }
    _emit_artifacts(args, emission, kind="bench_serve")
    print(json.dumps({k: v for k, v in emission.items() if k != "telemetry"},
                     sort_keys=True))
    if args.events:
        telemetry.close()
        print(f"events   -> {args.events}")
    _require(failures == 0,
             "a served proof failed verification: correctness violation")
    _require(res["slo_ok"], "steady-state p99 blew the SLO")
    _require(res["goodput_ok"], "interactive goodput collapsed under chaos")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mp", action="store_true",
                    help="drive the multi-process plane (board + "
                         "supervised worker pool + balancer) instead of "
                         "the in-process ServeFront")
    ap.add_argument("--arrivals", type=int, default=None,
                    help="total client arrivals (default 100000, "
                         "or 60000 with --mp)")
    ap.add_argument("--rate", type=float, default=None,
                    help="mean arrival rate per second (default 6000, "
                         "or 20000 with --mp)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--validators", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--pattern", default="hotspot",
                    choices=("uniform", "diurnal", "bursty", "hotspot"),
                    help="chaos-phase arrival pattern")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="interactive p99 SLO (default 50 steady-state, "
                         "or 300 under --mp process chaos)")
    ap.add_argument("--no-chaos", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the proofs are built and verified "
                         "(cuda unless asked otherwise)")
    ap.add_argument("--mainnet", action="store_true",
                    help="the mainnet config with the PeerDAS geometry "
                         "(default: the minimal config)")
    ap.add_argument("--fronts", type=int, default=2,
                    help="[--mp] SO_REUSEPORT listener groups")
    ap.add_argument("--workers-per-front", type=int, default=2,
                    help="[--mp] worker processes per front")
    ap.add_argument("--kills", type=int, default=2,
                    help="[--mp] seeded worker SIGKILLs")
    ap.add_argument("--wedges", type=int, default=1,
                    help="[--mp] seeded heartbeat-wedge windows")
    ap.add_argument("--fd-exhaust", type=int, default=32,
                    help="[--mp] idle connections held against front 0")
    ap.add_argument("--chaos-arrivals", type=int, default=30_000,
                    help="[--mp] chaos-phase arrivals")
    ap.add_argument("--chaos-rate", type=float, default=10_000.0,
                    help="[--mp] chaos-phase arrival rate: the rate "
                         "the surviving workers must hold while their "
                         "peers are killed, wedged and respawned")
    ap.add_argument("--trace-rate", type=float, default=0.0,
                    help="[--mp] seeded fraction of arrivals carrying "
                         "an end-to-end trace id (0 = tracing off)")
    ap.add_argument("--trace-dir",
                    help="[--mp] directory for per-process span files "
                         "(default: a fresh temp dir when --trace-rate > 0)")
    ap.add_argument("--run-dir",
                    help="[--mp] keep each phase's worker heartbeats, stats "
                         "and fleet snapshots under RUN_DIR/<phase> "
                         "(default: a fresh temp dir a phase), for "
                         "obs_top --dir")
    ap.add_argument("--metrics-out",
                    help="[--mp] write the fleet Prometheus text scraped "
                         "off the metrics RPC here")
    ap.add_argument("--events", help="telemetry JSONL output path")
    ap.add_argument("--json", help="write the bench emission here")
    ap.add_argument("--history",
                    help="append the emission to this bench_history.jsonl")
    ap.add_argument("--record", type=int, default=None,
                    help="also write SERVE_DEMO_r{N}.json at the repo root")
    args = ap.parse_args(argv)
    if args.arrivals is None:
        args.arrivals = 60_000 if args.mp else 100_000
    if args.rate is None:
        args.rate = 20_000.0 if args.mp else 6000.0
    if args.slo_ms is None:
        args.slo_ms = 300.0 if args.mp else 50.0

    from pos_evolution_tpu_torch.backend import use_backend
    from pos_evolution_tpu_torch.config import mainnet_config, minimal_config, use_config
    from pos_evolution_tpu_torch.device import card_line, resolve_device
    from pos_evolution_tpu_torch.sim.driver import PEERDAS
    from pos_evolution_tpu_torch.telemetry import Telemetry

    dev = resolve_device(args.device)
    card = card_line(dev)
    config = (mainnet_config().replace(**PEERDAS) if args.mainnet
              else minimal_config())
    if args.events:
        os.makedirs(os.path.dirname(os.path.abspath(args.events)), exist_ok=True)
    telemetry = Telemetry.to_file(args.events) if args.events else Telemetry()
    with use_config(config), use_backend("torch", device=dev):
        if args.mp:
            return _main_mp(args, telemetry, dev, card)
        return _main_classic(args, telemetry, dev, card)


if __name__ == "__main__":
    sys.exit(main())
