"""Run report: telemetry JSONL -> markdown / JSON, offline (the port's
counterpart of ``scripts/run_report.py``: the same report over the same
events, read through the port's own modules, plus the sections only the
port's runs fill, listed at the end of this docstring).

Reconstructs, from the event log alone (no live ``Simulation``):

- the **finality timeline** — per-slot justified/finalized epochs from
  ``slot`` events, plus the slots where finality actually advanced;
- **fault attribution vs. effects** — per-(action, kind) counts from the
  ``fault`` events ``sim/faults.py`` emits (these match the FaultPlan's
  seeded decisions exactly: same code path records both), next to the
  observable effects (childless gossip edges ≈ drops, handler rejects,
  invariant violations, crash/rejoin, degradations, watchdog incidents);
- **handler percentiles** — p50/p95/count over every event carrying
  ``handler`` + ``duration_ms`` (deliveries and ``get_head`` queries);
- **light-client lag** — worst/final head- and finality-lag per node;
- **merkleization** — totals + hit rate of the incremental-SSZ and
  fused-transition counters (``merkleization`` events: per-slot deltas of
  ``ssz.htr_cache_hit`` / ``ssz.htr_cache_miss`` / dirty-chunk counts and
  the fused sweep's upload/patch/reuse residency decisions);
- **DAS serving** — sampling-client population size, samples served /
  coalesced unique fetches, per-request p50/p95 serving latency,
  proof-path cache hit rate and verification failures, aggregated from
  the per-block ``das_serve`` events (``das/server.py``);
- the **dense phase budget** — the per-slot breakdown of
  ``DenseSimulation.run_slot`` from the sampled (device-fenced)
  ``dense_phase`` events: per-phase totals + share of the sampled slot
  wall, and the accounted percentage the CI smoke pins at >= 95%;
- **serving** — the live RPC tier's traffic story from ``serve_attach``
  / ``serve_summary`` events (``pos_evolution_tpu_torch/serve/``): per-tier
  p50/p99/p999, goodput vs. shed rate with shed reasons, hedges and
  retries, verified-proof counts, brownout/breaker transitions, chaos
  injections, and the SLO verdict;
- the **property audit** — the online monitor verdicts
  (``sim/monitors.py`` ``monitor`` events: accountable-safety /
  liveness / fork-choice-parity violations with slot, evidence size and
  slashable stake) next to the debug-gated ``invariant_violation``
  events, the attached monitor/adversary roster from ``monitor_attach``,
  and the repro-bundle path when the log lives inside a
  chaos-fuzz bundle (auto-discovered via a sibling ``violations.json``,
  or passed with ``--bundle``);
- **top device ops** — folded in from a ``top_ops.json`` (the table
  ``profiling/xplane.top_table`` makes of a trace's planes; the port's
  ``Simulation(profile=)`` writes one from its Kineto trace). When
  ``--top-ops`` is not given, the report auto-discovers
  ``top_ops.json`` / ``bench_trace/top_ops.json`` next to the event log
  (reports used to silently omit device ops whenever the flag was
  forgotten);
- **static cost tables** — a ``profiling/cost.py`` emission passed via
  ``--cost`` lands under ``cost_analysis`` (per-kernel FLOPs / bytes /
  peak memory next to the observed timeline).

Multi-process runs (``serve/harness.py`` with ``events_bus`` fan-out, or
any per-process ``EventBus``) write sibling
``events.<pid>.jsonl`` files instead of sharing one log. The report
auto-discovers those next to the given path and merges them with
``telemetry.merge_event_files`` (re-sequenced by wall clock, source pid
preserved as ``src_pid``) — pass the LOGICAL path
(``.../events.jsonl``); it does not need to exist when per-pid siblings
do.

Sections only the port fills (absent, so the report equals the JAX
script's, where a run emitted nothing for them):

- **kernel builds and launches** in the Device section: the flight
  recorder's artifact (``telemetry/device.FlightRecorder``) holds the
  build ledger (``profiling/ledger.CompileLedger``: one row a kernel
  source, function and phase, ``stage`` "build") and ``kernels``, the
  registry's ``kernel_builds_total{source}`` and
  ``kernel_launches_total{kernel}`` (``telemetry/torchrt``);
- **checkpoint digest launches** in the Resilience section: the kernel
  launches of the final attempt's checkpoint digests (K2 for the merkle
  digest), from the ``goodput`` event ``resilient_run`` emits;
- **top device kernels**: the device planes' top-ops rows folded by
  kernel function, over the paths of ranges that launched them (a Kineto
  op name is its launch path, ``profiling/kineto.py``);
- **worker interruption events** in the multi-process Serving section:
  the pool's live ``worker_interruption`` events (``serve/workers.py``),
  beside the rows of its closing summary.

Usage:
    python -m pos_evolution_tpu_torch.run_report events.jsonl
        [--json out.json] [--markdown out.md] [--top-ops top_ops.json]
        [--cost cost.json] [--device-ledger device_ledger.json]
        [--xplane TRACE]

Markdown goes to stdout unless ``--markdown`` is given. No torch: the
report reads files, wherever Python runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from pos_evolution_tpu_torch.telemetry import read_jsonl
from pos_evolution_tpu_torch.telemetry.events import (
    discover_per_process,
    merge_event_files,
)


def load_events(events_path: str) -> tuple[list[dict], list[str]]:
    """Events for a logical log path: the file itself when it stands
    alone, the merged union when per-process ``events.<pid>.jsonl``
    siblings exist (both when the logical file is also present — a
    harness that wrote its own lines next to its workers' files).
    Returns (events, merged_source_paths)."""
    per_proc = discover_per_process(events_path)
    if not per_proc:
        return read_jsonl(events_path), []
    paths = ([events_path] if os.path.exists(events_path) else []) \
        + per_proc
    return merge_event_files(paths), paths


def _percentile(xs: list[float], q: float) -> float:
    """Linear-interpolation percentile (numpy 'linear' method) — kept
    dependency-free so the report runs anywhere python does."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] * (1 - frac) + xs[hi] * frac


def discover_top_ops(events_path: str, events=()) -> str | None:
    """``top_ops.json`` next to the event log, under a sibling
    ``bench_trace/``, or wherever a
    ``profile_artifacts`` event in the log itself says
    ``Simulation(profile=<dir>)`` dropped its artifacts."""
    here = os.path.dirname(os.path.abspath(events_path))
    # the log's own recorded artifact dir is authoritative — proximity
    # guesses come AFTER it, or a stale bench_trace/ next to the log
    # would shadow this run's actual profile
    cands = [os.path.join(ev["dir"], "top_ops.json")
             for ev in events
             if ev.get("type") == "profile_artifacts" and ev.get("dir")]
    cands += [os.path.join(here, "top_ops.json"),
              os.path.join(here, "bench_trace", "top_ops.json")]
    for cand in cands:
        if os.path.exists(cand):
            return cand
    return None


def discover_device_ledger(events_path: str) -> str | None:
    """The flight recorder's artifact beside the event log
    (``*device_ledger.json``, written by ``FlightRecorder.
    write_artifact``) — same proximity contract as the fleet snapshot
    auto-discovery. Newest mtime wins when several runs share a dir."""
    here = os.path.dirname(os.path.abspath(events_path))
    cands = glob.glob(os.path.join(here, "*device_ledger.json"))
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)


def discover_bundle(events_path: str) -> str | None:
    """The chaos-fuzz repro bundle the event log belongs to, if any:
    ``write_bundle`` moves the violating run's ``events.jsonl`` next to
    its ``violations.json``, so a sibling marks the directory."""
    here = os.path.dirname(os.path.abspath(events_path))
    if os.path.exists(os.path.join(here, "violations.json")):
        return here
    return None


def _device_section(by_type: dict, device_ledger: dict | None) -> dict:
    """The "Device" section: flight-recorder artifact first
    (memory watermarks + compile ledger + skew table), live
    ``device_memory`` / ``shard_skew`` events as the fallback when the
    run died before writing one. Empty dict = no section."""
    out: dict = {}
    fr = (device_ledger or {}).get("flight_recorder") or {}
    if fr.get("memory"):
        out["memory"] = fr["memory"]
    if fr.get("compile_ledger"):
        out["compile_ledger"] = fr["compile_ledger"]
    if (fr.get("shard_skew") or {}).get("table"):
        out["shard_skew"] = fr["shard_skew"]
    if fr.get("kernels"):
        # the port's: kernel builds by source, launches by kernel
        out["kernels"] = fr["kernels"]
    curve = (device_ledger or {}).get("memory_curve") or []
    dm_events = by_type.get("device_memory", [])
    if "memory" not in out and dm_events:
        # reconstruct watermarks from the event stream alone
        peak: dict[str, int] = {}
        source = None
        for ev in dm_events:
            for row in ev.get("rows") or []:
                dev = row.get("device", "?")
                peak[dev] = max(peak.get(dev, 0),
                                int(row.get("bytes_in_use", 0)))
                source = row.get("platform")
        out["memory"] = {"samples": len(dm_events), "source": source,
                         "peak_bytes": peak}
    if curve or dm_events:
        points = curve or dm_events
        out["memory_events"] = len(points)
        first, last = points[0], points[-1]
        out["memory_span"] = {
            "first": {"site": first.get("site"),
                      "slot": first.get("slot")},
            "last": {"site": last.get("site"), "slot": last.get("slot")},
        }
    skew_events = by_type.get("shard_skew", [])
    if "shard_skew" not in out and skew_events:
        worst = max(skew_events,
                    key=lambda e: e.get("spread_ms") or 0)
        out["shard_skew"] = {
            "probes": len(skew_events),
            "worst": {"phase": worst.get("phase"),
                      "slot": worst.get("slot"),
                      "spread_ms": worst.get("spread_ms")},
        }
    return out


def kernel_name(op: str) -> str:
    """A device op's kernel function: the last segment of its launch path,
    without namespaces, template and argument lists or a return type
    (``sim_run/propose/merkle_level_kernel(int const*, ...)`` ->
    ``merkle_level_kernel``)."""
    fn = op.rsplit("/", 1)[-1].replace("(anonymous namespace)::", "")
    fn = fn.split("(", 1)[0]
    depth, bare = 0, []
    for ch in fn:   # drop template arguments, nested or not
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            bare.append(ch)
    fn = "".join(bare).strip().split(" ")[-1]
    return fn.rsplit("::", 1)[-1] or op


def device_kernels(top_ops: dict) -> dict:
    """The device planes' top-ops rows folded by kernel function:
    plane -> kernel -> {count, total_ms, paths}, heaviest first."""
    out: dict = {}
    for plane, rows in top_ops.items():
        if not (isinstance(rows, list) and plane.startswith("/device:")):
            continue
        fold: dict = {}
        for r in rows:
            row = fold.setdefault(kernel_name(str(r.get("op", ""))),
                                  {"count": 0, "total_ms": 0.0, "paths": 0})
            row["count"] += int(r.get("count") or 0)
            row["total_ms"] += float(r.get("total_ms") or 0.0)
            row["paths"] += 1
        if fold:
            out[plane] = {k: {**v, "total_ms": round(v["total_ms"], 3)}
                          for k, v in sorted(fold.items(),
                                             key=lambda kv: -kv[1]["total_ms"])}
    return out


def build_report(events: list[dict], top_ops: dict | None = None,
                 cost: dict | None = None,
                 bundle: str | None = None,
                 device_ledger: dict | None = None) -> dict:
    """Pure JSONL -> report-dict transform (the testable core)."""
    by_type: dict[str, list[dict]] = {}
    for ev in events:
        by_type.setdefault(ev["type"], []).append(ev)

    run_start = (by_type.get("run_start") or [{}])[0]

    # -- finality timeline ----------------------------------------------------
    slots = by_type.get("slot", [])
    timeline = [{"slot": e["slot"], "head_slot": e.get("head_slot"),
                 "justified_epoch": e.get("justified_epoch"),
                 "finalized_epoch": e.get("finalized_epoch"),
                 "participation": e.get("participation")}
                for e in slots]
    advances = []
    prev_fin = None
    for row in timeline:
        fin = row["finalized_epoch"]
        if prev_fin is not None and fin is not None and fin > prev_fin:
            advances.append({"slot": row["slot"], "finalized_epoch": fin})
        if fin is not None:
            prev_fin = fin

    # -- fault attribution vs. effects ----------------------------------------
    fault_counts: dict[str, dict[str, int]] = {}
    for e in by_type.get("fault", []):
        row = fault_counts.setdefault(e["action"], {})
        row[e["kind"]] = row.get(e["kind"], 0) + 1
    # dense-driver fault masks: per-(slot, view) aggregates,
    # not per-message events — fold into totals
    dense_faults = by_type.get("dense_fault", [])
    dense_fault_totals = None
    if dense_faults:
        dense_fault_totals = {
            "events": len(dense_faults),
            "dropped_votes": sum(e.get("dropped", 0) for e in dense_faults),
            "delayed_votes": sum(e.get("delayed", 0) for e in dense_faults),
        }
    gossip_spans = {e["span"] for e in by_type.get("gossip", [])
                    if e.get("span")}
    delivered_parents = {e.get("parent") for e in by_type.get("deliver", [])}
    rejects: dict[str, int] = {}
    for e in by_type.get("deliver", []):
        if e.get("status") == "reject":
            rejects[e["handler"]] = rejects.get(e["handler"], 0) + 1
    effects = {
        "gossip_edges": len(gossip_spans),
        "undelivered_gossip_edges": len(gossip_spans - delivered_parents),
        "handler_rejects": rejects,
        "invariant_violations": len(by_type.get("invariant_violation", [])),
        "crashes": [{"group": e["group"], "slot": e["slot"],
                     "lost_in_flight": e.get("lost_in_flight")}
                    for e in by_type.get("crash", [])],
        "rejoins": [{"group": e["group"], "slot": e["slot"],
                     "sync_checkpoint_epoch": e.get("sync_checkpoint_epoch")}
                    for e in by_type.get("rejoin", [])],
        "degradations": [{"component": e.get("component"),
                          "reason": e.get("reason")}
                         for e in by_type.get("degradation", [])],
        "watchdog_incidents": [{"tag": e.get("tag"), "step": e.get("step"),
                                "error": e.get("error")}
                               for e in by_type.get("watchdog_incident", [])],
    }

    # -- handler percentiles --------------------------------------------------
    durations: dict[str, list[float]] = {}
    for ev in events:
        h = ev.get("handler")
        d = ev.get("duration_ms")
        if h is not None and d is not None:
            durations.setdefault(h, []).append(float(d))
    handlers = {
        name: {"count": len(xs),
               "p50_ms": round(_percentile(xs, 50), 4),
               "p95_ms": round(_percentile(xs, 95), 4),
               "total_ms": round(sum(xs), 3)}
        for name, xs in sorted(durations.items())
    }

    # -- light clients --------------------------------------------------------
    lc: dict[int, dict] = {}
    for e in by_type.get("light_client_lag", []):
        row = lc.setdefault(e.get("node", 0), {
            "records": 0, "max_head_lag": 0, "max_finality_lag": 0,
            "final_head_lag": None, "final_finality_lag": None})
        row["records"] += 1
        row["max_head_lag"] = max(row["max_head_lag"], e.get("head_lag", 0))
        row["max_finality_lag"] = max(row["max_finality_lag"],
                                      e.get("finality_lag", 0))
        row["final_head_lag"] = e.get("head_lag")
        row["final_finality_lag"] = e.get("finality_lag")

    # -- merkleization (ssz/incremental.py + ops/transition.py counters) ------
    merk_events = by_type.get("merkleization", [])
    merk_totals: dict[str, int] = {}
    for e in merk_events:
        for k, v in e.items():
            if k.startswith(("ssz_", "fused_", "merkle_")) \
                    and isinstance(v, (int, float)):
                merk_totals[k] = merk_totals.get(k, 0) + v
    merkleization = None
    if merk_totals:
        hits = merk_totals.get("ssz_htr_cache_hit", 0)
        misses = merk_totals.get("ssz_htr_cache_miss", 0)
        dev_pairs = merk_totals.get("merkle_device_pairs", 0)
        host_pairs = merk_totals.get("merkle_host_pairs", 0)
        dev_ms = merk_totals.get("merkle_device_ms", 0)
        merkleization = {
            "slots_with_activity": len(merk_events),
            "totals": {k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in sorted(merk_totals.items())},
            "htr_hit_rate": (round(hits / (hits + misses), 4)
                             if hits + misses else None),
            # device-vs-host split of the level sweeps (ops/merkle_device)
            "device_pairs": dev_pairs,
            "host_pairs": host_pairs,
            "device_share": (round(dev_pairs / (dev_pairs + host_pairs), 4)
                             if dev_pairs + host_pairs else None),
            "device_pairs_per_s": (round(dev_pairs / (dev_ms / 1e3))
                                   if dev_ms else None),
        }

    # -- DAS serving (das/server.py summaries via das_serve events) -----------
    das_events = by_type.get("das_serve", [])
    das_serving = None
    if das_events:
        p50s = [float(e["p50_ms"]) for e in das_events if "p50_ms" in e]
        p95s = [float(e["p95_ms"]) for e in das_events if "p95_ms" in e]
        attach = (by_type.get("das_attach") or [{}])[0]
        das_serving = {
            "served_blocks": len(das_events),
            "clients": das_events[-1].get("clients"),
            "samples_per_client": attach.get("samples_per_client"),
            "samples_total": sum(e.get("samples", 0) for e in das_events),
            "unique_requests_total": sum(e.get("unique_requests", 0)
                                         for e in das_events),
            "verify_failures": sum(e.get("failed", 0) for e in das_events),
            "clients_all_ok_final": das_events[-1].get("clients_all_ok"),
            "cache_hit_rate": das_events[-1].get("cache_hit_rate"),
            # medians ACROSS served blocks of the per-block per-request
            # percentiles (the true pooled p95 would need the raw samples;
            # a percentile-of-percentiles is ~the max, which worst_p95_ms
            # already reports)
            "p50_ms": round(_percentile(p50s, 50), 4),
            "p95_ms": round(_percentile(p95s, 50), 4),
            "worst_p95_ms": round(max(p95s), 4) if p95s else None,
            "scheme": (das_events[-1].get("scheme")
                       or (attach.get("engine") or {}).get("scheme")),
            "aggregated": das_events[-1].get("aggregated"),
        }
        # served proof bytes per sample: the aggregation win (kzg serves
        # one multiproof per block; merkle serves a branch per cell)
        proof_bytes = sum(e.get("proof_bytes", 0) for e in das_events)
        if proof_bytes and das_serving["samples_total"]:
            das_serving["proof_bytes_total"] = proof_bytes
            das_serving["proof_bytes_per_sample"] = round(
                proof_bytes / das_serving["samples_total"], 4)

    # -- serving (serve/ RPC tier: serve_attach + serve_summary events) -------
    serve_events = by_type.get("serve_summary", [])
    serving = None
    if serve_events:
        last = serve_events[-1]
        attach = (by_type.get("serve_attach") or [{}])[0]
        server = last.get("server") or {}
        load = last.get("load") or {}
        chaos = last.get("chaos") or {}
        serving = {
            "workers": server.get("workers"),
            "pattern": load.get("pattern"),
            "arrivals": load.get("arrivals"),
            "rate": load.get("rate"),
            "wall_s": load.get("wall_s"),
            "tiers": load.get("tiers"),
            "requests_total": server.get("requests_total"),
            "by_status": server.get("by_status"),
            "shed_rate": server.get("shed_rate"),
            "shed_by_reason": server.get("shed_by_reason"),
            "hedges": load.get("hedges"),
            "retries": load.get("retries"),
            "verified_proofs": load.get("verified_proofs"),
            "verify_failures": load.get("verify_failures"),
            "brownout_transitions": server.get("brownout_transitions"),
            "breaker_state": server.get("breaker_state"),
            "breaker_transitions": server.get("breaker_transitions"),
            "singleflight": server.get("singleflight"),
            "scheme_builds": server.get("scheme_builds"),
            "proof_cache": server.get("proof_cache"),
            "slow_loris_closed": server.get("slow_loris_closed"),
            "chaos_stalls": server.get("chaos_stalls"),
            "chaos_injections": chaos.get("injections"),
            "slo_ms": last.get("slo_ms"),
            "slo_ok": last.get("slo_ok"),
            "attach": {k: attach.get(k) for k in
                       ("workers", "pattern", "arrivals", "rate", "chaos")
                       if attach.get(k) is not None} or None,
        }

    # -- multi-process serving (serve_mp_attach + serve_mp_summary) -----------
    mp_events = by_type.get("serve_mp_summary", [])
    serving_mp = None
    if mp_events:
        last = mp_events[-1]
        attach = (by_type.get("serve_mp_attach") or [{}])[0]

        def _mp_phase(result: dict | None) -> dict | None:
            if not result:
                return None
            inter = (result.get("load") or {}).get("tiers", {}).get(
                "interactive", {})
            verdict = result.get("verdict") or {}
            return {
                "arrivals": result.get("arrivals"),
                "rate": result.get("rate"),
                "wall_s": (result.get("load") or {}).get("wall_s"),
                "p50_ms": inter.get("p50_ms"),
                "p99_ms": inter.get("p99_ms"),
                "goodput_pct": inter.get("goodput_pct"),
                "resends": verdict.get("resends"),
                "lost": verdict.get("lost"),
                "verified_proofs": verdict.get("verified_proofs"),
                "verify_failures": verdict.get("verify_failures"),
                "traced": (result.get("load") or {}).get("traced"),
                "fleet_consistent": verdict.get("fleet_consistent"),
                "ok": verdict.get("ok"),
            }

        steady_r = last.get("steady") or {}
        chaos_r = last.get("chaos")
        # the chaos phase's pool carries the interruption story; a
        # no-chaos run falls back to the steady pool
        pool = ((chaos_r or steady_r).get("pool")) or {}
        serving_mp = {
            "fronts": attach.get("fronts") or steady_r.get("fronts"),
            "workers": attach.get("workers") or steady_r.get("workers"),
            "steady": _mp_phase(steady_r),
            "chaos": _mp_phase(chaos_r),
            "worker_rows": pool.get("workers") or [],
            "interruptions": pool.get("interruptions") or [],
            "interruptions_by_reason":
                pool.get("interruptions_by_reason") or {},
            "restarts": pool.get("restarts"),
            "parked": pool.get("parked"),
            "chaos_kills_delivered": pool.get("chaos_kills_delivered"),
            "board_generation": (chaos_r or steady_r).get(
                "board_generation"),
            "respawned_on_current_generation":
                ((chaos_r or steady_r).get("verdict") or {}).get(
                    "respawned_on_current_generation"),
        }
        live = by_type.get("worker_interruption", [])
        if live:
            # the port's: the pool's interruptions as it emitted them
            serving_mp["interruption_events"] = [
                {k: e.get(k) for k in ("worker", "reason", "pid", "exit_code",
                                       "wall_s") if e.get(k) is not None}
                for e in live]
        # fleet metrics: the scraped FleetAggregator summary
        # rides the phase result, the consistency verdict rides the
        # phase verdict — the chaos phase (when run) is the story
        fl_verdict = (chaos_r or steady_r).get("verdict") or {}
        fl_raw = (chaos_r or steady_r).get("fleet") or {}
        if fl_raw or fl_verdict.get("fleet_requests_by_worker") \
                is not None:
            serving_mp["fleet"] = {
                "workers_reporting":
                    fl_verdict.get("fleet_workers_reporting"),
                "requests_by_worker":
                    fl_verdict.get("fleet_requests_by_worker")
                    or fl_raw.get("requests_by_worker"),
                "requests_total":
                    fl_verdict.get("fleet_requests_total"),
                "window": fl_verdict.get("fleet_window"),
                "consistent": fl_verdict.get("fleet_consistent"),
                "snapshots_merged": fl_raw.get("snapshots_merged"),
                "snapshots_skipped": fl_raw.get("snapshots_skipped"),
            }

    # -- dense phase budget (profiling/phases.py dense_phase events) ----------
    dense_ph = by_type.get("dense_phase", [])
    dense_budget = None
    if dense_ph:
        ph_totals: dict[str, float] = {}
        sampled_wall = 0.0
        for e in dense_ph:
            sampled_wall += float(e.get("wall_ms") or 0.0)
            for name, ms in (e.get("phases") or {}).items():
                ph_totals[name] = ph_totals.get(name, 0.0) + float(ms)
        accounted = sum(ph_totals.values())
        dense_budget = {
            "sampled_slots": len(dense_ph),
            "sampled_wall_ms": round(sampled_wall, 3),
            "phases": {
                name: {"total_ms": round(ms, 3),
                       "share_pct": (round(100.0 * ms / sampled_wall, 2)
                                     if sampled_wall > 0 else None)}
                for name, ms in sorted(ph_totals.items(),
                                       key=lambda kv: -kv[1])},
            "accounted_pct": (round(100.0 * accounted / sampled_wall, 2)
                              if sampled_wall > 0 else None),
        }

    # -- resilience (resilience/ checkpoint + supervisor events) --------------
    ckpts = by_type.get("checkpoint_saved", [])
    interruptions = by_type.get("supervisor_interruption", [])
    resumes = by_type.get("run_resumed", [])
    quarantines = by_type.get("checkpoint_quarantined", [])
    integrity = by_type.get("integrity_violation", [])
    goodput_ev = (by_type.get("goodput") or [None])[-1]
    resilience = None
    if ckpts or interruptions or resumes or goodput_ev or integrity:
        final = (by_type.get("checkpoint_final") or [{}])[-1]
        segments = by_type.get("run_segment", [])
        run_wall = sum(float(s.get("wall_s", 0)) for s in segments)
        blocked_ms = sum(float(e.get("blocked_ms", 0)) for e in ckpts)
        from pos_evolution_tpu_torch.resilience import replayed_slots_from_events
        replayed = replayed_slots_from_events(events)
        # overhead: the goodput event's figure is canonical (final
        # attempt's in-loop blocked time over that attempt's wall); the
        # event-derived fallback sums blocked_ms over EVERY attempt but
        # run_segment only over completed ones, so it overstates
        # overhead whenever a run was interrupted
        if goodput_ev and goodput_ev.get("ckpt_overhead_pct") is not None:
            overhead_pct = goodput_ev["ckpt_overhead_pct"]
        elif run_wall and not interruptions:
            overhead_pct = round(100.0 * blocked_ms / (run_wall * 1e3), 3)
        else:
            overhead_pct = None
        resilience = {
            "checkpoints_saved": len(ckpts),
            "checkpoint_blocked_ms": round(blocked_ms, 3),
            "checkpoint_overhead_pct": overhead_pct,
            "checkpoint_bytes": final.get("bytes"),
            "async_mode": ckpts[-1].get("async_mode") if ckpts else None,
            "interruptions": [
                {k: e.get(k) for k in ("attempt", "reason", "exit_code",
                                       "wall_s") if e.get(k) is not None}
                for e in interruptions],
            "resumes": [{"step": e.get("step"), "slot": e.get("slot")}
                        for e in resumes],
            "replayed_slots": replayed,
            "quarantined_checkpoints": [
                {"step": e.get("step"), "reason": e.get("reason")}
                for e in quarantines],
            "rejected_checkpoints": [
                {"step": e.get("step"), "reason": e.get("reason")}
                for e in by_type.get("checkpoint_rejected", [])],
            "integrity_violations": [
                {"slot": e.get("slot"), "findings": e.get("findings")}
                for e in integrity],
            "gave_up": bool(by_type.get("supervisor_gaveup")),
        }
        if (goodput_ev or {}).get("ckpt_digest_launches"):
            # the port's: the final attempt's checkpoint digests' launches
            resilience["checkpoint_digest_launches"] = \
                goodput_ev["ckpt_digest_launches"]
        if goodput_ev is not None:
            resilience["goodput"] = {
                k: goodput_ev.get(k) for k in
                ("attempts", "interruptions", "replayed_slots",
                 "final_slot", "goodput_pct", "ckpt_overhead_pct",
                 "total_wall_s", "resumed_on_degraded_mesh")
                if goodput_ev.get(k) is not None}

    # -- variant audit (variants/ per-slot records + variant_safety) ----------
    variant_events = by_type.get("variant", [])
    variant_audit = None
    if variant_events:
        last = variant_events[-1]
        groups = {}
        for gid, row in (last.get("groups") or {}).items():
            groups[gid] = {k: row.get(k) for k in
                           ("head_slot", "confirmed_slot",
                            "fast_confirmed_slot", "justified_slot",
                            "finalized_slot", "n_finalized",
                            "equivocators") if row.get(k) is not None}
        fast_confirms = sum(
            1 for e in variant_events
            for row in (e.get("groups") or {}).values()
            if row.get("fast_confirmed_slot") == e.get("slot") - 1)
        variant_audit = {
            "variant": last.get("variant"),
            "slots_recorded": len(variant_events),
            "final": groups,
            "fast_confirmations": fast_confirms,
            "slashable_evidence": last.get("slashable_evidence", 0),
            "violations": [
                {k: e.get(k) for k in ("slot", "kind", "checkpoint",
                                       "groups", "slots", "roots",
                                       "evidence_size", "slashable_stake",
                                       "accountability_scale", "detail")
                 if e.get(k) is not None}
                for e in by_type.get("monitor", [])
                if e.get("monitor") == "variant_safety"],
        }

    # -- dense variants (the variant seam in the dense driver) ----------------
    dv_attach = by_type.get("variant_attach", [])
    dv_decisions = by_type.get("variant_decision", [])
    dense_variants = None
    if dv_attach or dv_decisions:
        att = dv_attach[-1] if dv_attach else {}
        by_rule: dict = {}
        for e in dv_decisions:
            row = by_rule.setdefault(
                str(e.get("rule")),
                {"count": 0, "last_slot": None, "views": set()})
            row["count"] += 1
            row["last_slot"] = e.get("slot")
            row["views"].add(e.get("view"))
        dense_variants = {
            "variant": att.get("variant"),
            "riders": att.get("riders") or [],
            "decisions": len(dv_decisions),
            "rules": {k: {"count": v["count"],
                          "last_slot": v["last_slot"],
                          "views": sorted(v["views"])}
                      for k, v in sorted(by_rule.items())},
            "violations": [
                {k: e.get(k) for k in
                 ("slot", "kind", "rule", "groups", "decision_slot",
                  "roots", "evidence_size", "slashable_stake",
                  "total_stake", "detail") if e.get(k) is not None}
                for e in by_type.get("monitor", [])
                if e.get("monitor") == "variant_safety"],
        }

    # -- property audit (sim/monitors.py verdicts + invariant checker) --------
    attach = (by_type.get("monitor_attach") or [{}])[0]
    violations = [
        {k: e.get(k) for k in ("slot", "monitor", "kind", "checkpoint",
                               "groups", "epochs", "roots",
                               "evidence_size", "slashable_stake",
                               "total_stake", "epoch",
                               "best_finalized_epoch", "lag_epochs",
                               "bound_epochs", "group", "detail")
         if e.get(k) is not None}
        for e in by_type.get("monitor", [])]
    slashing = by_type.get("slashing_detected", [])
    audit = {
        "monitors": attach.get("monitors") or [],
        "adversaries": attach.get("adversaries") or [],
        "violations": violations,
        "invariant_violations": [
            {k: e.get(k) for k in ("slot", "group", "check", "detail")
             if e.get(k) is not None}
            for e in by_type.get("invariant_violation", [])],
        "slashing_evidence": {
            "detections": sum(e.get("n_new", 0) for e in slashing),
            "implicated_total":
                slashing[-1].get("implicated_total") if slashing else 0,
        },
        "clean": (not violations
                  and not by_type.get("invariant_violation")),
    }
    if bundle:
        audit["repro_bundle"] = bundle

    report = {
        "schema_version": events[0]["v"] if events else None,
        "n_events": len(events),
        "run": {k: run_start.get(k) for k in
                ("n_validators", "n_groups", "accelerated_forkchoice",
                 "debug", "dense", "mesh") if k in run_start},
        "finality": {
            "timeline": timeline,
            "advances": advances,
            "final_justified_epoch":
                timeline[-1]["justified_epoch"] if timeline else None,
            "final_finalized_epoch":
                timeline[-1]["finalized_epoch"] if timeline else None,
        },
        "faults": {"counts": fault_counts, "effects": effects,
                   **({"dense_totals": dense_fault_totals}
                      if dense_fault_totals else {})},
        "property_audit": audit,
        "handlers": handlers,
        "light_clients": {str(k): v for k, v in sorted(lc.items())},
    }
    if resilience:
        report["resilience"] = resilience
    if serving:
        report["serving"] = serving
    if serving_mp:
        report["serving_mp"] = serving_mp
    if dense_budget:
        report["dense_phase_budget"] = dense_budget
    device = _device_section(by_type, device_ledger)
    if device:
        report["device"] = device
    if merkleization:
        report["merkleization"] = merkleization
    if das_serving:
        report["das_serving"] = das_serving
    if variant_audit:
        report["variant_audit"] = variant_audit
    if dense_variants:
        report["dense_variants"] = dense_variants
    if top_ops:
        report["top_device_ops"] = top_ops
        kernels = device_kernels(top_ops)
        if kernels:
            report["top_device_kernels"] = kernels
    if cost:
        report["cost_analysis"] = cost
    # device-time attribution emitted by profiling.ProfiledRegion runs
    profiles = by_type.get("profile", [])
    if profiles:
        report["profiles"] = [
            {k: p.get(k) for k in ("name", "by_jit", "attribution",
                                   "by_shard_map", "trace_dir", "error")
             if k in p}
            for p in profiles]
    return report


# -- markdown rendering --------------------------------------------------------

def _md_table(headers: list[str], rows: list[list]) -> list[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(x) for x in r) + " |")
    return out


def to_markdown(report: dict) -> str:
    md = ["# Run report", ""]
    run = report.get("run", {})
    md.append(f"- events: **{report['n_events']}** "
              f"(schema v{report['schema_version']})")
    if run:
        md.append("- run: " + ", ".join(f"{k}={v}" for k, v in run.items()))
    fin = report["finality"]
    md += ["", "## Finality timeline", ""]
    if fin["timeline"]:
        md.append(f"- final justified epoch: "
                  f"**{fin['final_justified_epoch']}**, "
                  f"final finalized epoch: "
                  f"**{fin['final_finalized_epoch']}**")
        if fin["advances"]:
            md += ["", *_md_table(
                ["slot", "finalized epoch"],
                [[a["slot"], a["finalized_epoch"]] for a in fin["advances"]])]
        else:
            md.append("- finality never advanced")
    else:
        md.append("- no slot events in the log")

    faults = report["faults"]
    md += ["", "## Faults: attribution vs. effects", ""]
    if faults["counts"]:
        rows = [[action, kind, n]
                for action, kinds in sorted(faults["counts"].items())
                for kind, n in sorted(kinds.items())]
        md += _md_table(["action", "kind", "count"], rows)
    else:
        md.append("- no fault events (clean network or no FaultPlan sink)")
    eff = faults["effects"]
    md += ["",
           f"- gossip edges: {eff['gossip_edges']} "
           f"(undelivered: {eff['undelivered_gossip_edges']})",
           f"- handler rejects: {eff['handler_rejects'] or 'none'}",
           f"- invariant violations: {eff['invariant_violations']}",
           f"- crashes: {eff['crashes'] or 'none'}",
           f"- rejoins: {eff['rejoins'] or 'none'}"]
    if eff["degradations"]:
        md.append(f"- degradations: {eff['degradations']}")
    if eff["watchdog_incidents"]:
        md.append(f"- watchdog incidents: {eff['watchdog_incidents']}")

    audit = report.get("property_audit") or {}
    md += ["", "## Property audit", ""]
    roster = ", ".join(m.get("kind", "?") for m in audit.get("monitors", []))
    adv = ", ".join(a.get("kind", "?") for a in audit.get("adversaries", []))
    md.append(f"- monitors: {roster or 'none attached'}")
    if adv:
        md.append(f"- adversaries: {adv}")
    se = audit.get("slashing_evidence") or {}
    if se.get("detections"):
        md.append(f"- slashing evidence: {se['detections']} detection(s), "
                  f"{se['implicated_total']} validator(s) implicated")
    if audit.get("clean", True):
        if audit.get("monitors"):
            md.append("- **all properties held** (no monitor or invariant "
                      "violations)")
        else:
            md.append("- no monitors were attached — nothing was audited")
    if audit.get("violations"):
        md += ["", *_md_table(
            ["slot", "monitor", "kind", "evidence", "slashable/total stake"],
            [[v.get("slot"), v.get("monitor"), v.get("kind"),
              v.get("evidence_size", ""),
              (f"{v['slashable_stake']}/{v['total_stake']}"
               if "slashable_stake" in v else "")]
             for v in audit["violations"]])]
    if audit.get("invariant_violations"):
        md += ["", f"- invariant violations: "
               f"{len(audit['invariant_violations'])}"]
        for iv in audit["invariant_violations"][:10]:
            md.append(f"  - {iv}")
    if audit.get("repro_bundle"):
        md.append(f"- repro bundle: `{audit['repro_bundle']}`")

    if report.get("variant_audit"):
        va = report["variant_audit"]
        md += ["", "## Variant audit", ""]
        md.append(f"- protocol variant: **{va.get('variant')}** "
                  f"({va.get('slots_recorded')} slots recorded)")
        md.append(f"- fast confirmations: {va.get('fast_confirmations', 0)}")
        if va.get("slashable_evidence"):
            md.append(f"- variant slashing evidence: "
                      f"{va['slashable_evidence']} validator(s)")
        if va.get("final"):
            md += ["", *_md_table(
                ["group", "head slot", "confirmed", "fast-confirmed",
                 "justified", "finalized"],
                [[gid, row.get("head_slot", ""),
                  row.get("confirmed_slot", ""),
                  row.get("fast_confirmed_slot", ""),
                  row.get("justified_slot", ""),
                  row.get("finalized_slot", "")]
                 for gid, row in sorted(va["final"].items())])]
        if va.get("violations"):
            md += ["", *_md_table(
                ["slot", "kind", "checkpoint", "evidence",
                 "slashable/scale stake"],
                [[v.get("slot"), v.get("kind"), v.get("checkpoint"),
                  v.get("evidence_size", ""),
                  (f"{v['slashable_stake']}/{v['accountability_scale']}"
                   if "slashable_stake" in v else "")]
                 for v in va["violations"]])]
        else:
            md.append("- no variant-safety violations")

    if report.get("dense_variants"):
        dv = report["dense_variants"]
        md += ["", "## Dense variants", ""]
        var = dv.get("variant") or {}
        kind = var.get("kind", "gasper") if isinstance(var, dict) else var
        params = ", ".join(f"{k}={v}" for k, v in sorted(var.items())
                           if k != "kind") if isinstance(var, dict) else ""
        md.append(f"- protocol variant: **{kind}**"
                  + (f" ({params})" if params else ""))
        for r in dv.get("riders", []):
            desc = ", ".join(f"{k}={v}" for k, v in sorted(r.items())
                             if k != "kind")
            md.append(f"- workload rider: **{r.get('kind')}** ({desc})")
        md.append(f"- variant decisions: {dv.get('decisions', 0)}")
        if dv.get("rules"):
            md += ["", *_md_table(
                ["rule", "decisions", "last slot", "views"],
                [[rule, row["count"], row["last_slot"],
                  ",".join(str(v) for v in row["views"])]
                 for rule, row in sorted(dv["rules"].items())])]
        if dv.get("violations"):
            md += ["", *_md_table(
                ["slot", "kind", "rule", "evidence", "slashable/total"],
                [[v.get("slot"), v.get("kind"), v.get("rule", ""),
                  v.get("evidence_size", ""),
                  (f"{v['slashable_stake']}/{v['total_stake']}"
                   if "slashable_stake" in v else "")]
                 for v in dv["violations"]])]
        else:
            md.append("- no dense variant-safety violations")

    if report.get("resilience"):
        res = report["resilience"]
        md += ["", "## Resilience", ""]
        md.append(f"- checkpoints saved: **{res['checkpoints_saved']}** "
                  f"({'async' if res.get('async_mode') else 'sync'} mode, "
                  f"{res['checkpoint_blocked_ms']} ms blocked in-loop"
                  + (f", {res['checkpoint_overhead_pct']}% of run wall"
                     if res.get("checkpoint_overhead_pct") is not None
                     else "") + ")")
        ints = res.get("interruptions") or []
        md.append(f"- interruptions: {len(ints)}"
                  + (" — " + ", ".join(
                      f"attempt {i.get('attempt')}: {i.get('reason')} "
                      f"(exit {i.get('exit_code')})" for i in ints)
                     if ints else " (uninterrupted)"))
        if res.get("resumes"):
            md.append("- resumes: " + ", ".join(
                f"step {r['step']} -> slot {r['slot']}"
                for r in res["resumes"])
                + f" (replayed slots: {res.get('replayed_slots', 0)})")
        gp = res.get("goodput")
        if gp:
            md.append(f"- effective goodput: **{gp.get('goodput_pct')}%** "
                      f"({gp.get('final_slot')} useful slots, "
                      f"{gp.get('replayed_slots')} replayed, "
                      f"{gp.get('attempts')} attempt(s), total wall "
                      f"{gp.get('total_wall_s')}s)")
            if gp.get("resumed_on_degraded_mesh"):
                md.append(f"- resumed on a DEGRADED mesh: "
                          f"{gp['resumed_on_degraded_mesh']}")
        for q in res.get("quarantined_checkpoints") or []:
            md.append(f"- **quarantined checkpoint** step {q['step']}: "
                      f"{q['reason']}")
        for iv in res.get("integrity_violations") or []:
            md.append(f"- **integrity violation** at slot {iv['slot']}: "
                      f"{iv['findings']}")
        if res.get("checkpoint_digest_launches"):
            md.append(f"- checkpoint digest launches (final attempt): "
                      f"{res['checkpoint_digest_launches']}")
        if res.get("gave_up"):
            md.append("- **SUPERVISOR GAVE UP** — retry budget exhausted")

    if report.get("merkleization"):
        merk = report["merkleization"]
        md += ["", "## Merkleization", ""]
        if merk.get("htr_hit_rate") is not None:
            md.append(f"- field-root cache hit rate: "
                      f"**{merk['htr_hit_rate']:.1%}** over "
                      f"{merk['slots_with_activity']} active slot(s)")
        if merk.get("device_share") is not None:
            md.append(f"- level-sweep dispatch: "
                      f"**{merk['device_pairs']}** pairs on device / "
                      f"{merk['host_pairs']} on host "
                      f"({merk['device_share']:.1%} device)"
                      + (f", device sweep throughput "
                         f"{merk['device_pairs_per_s']} pairs/s"
                         if merk.get("device_pairs_per_s") else ""))
        md += ["", *_md_table(
            ["counter", "total"],
            [[k, v] for k, v in merk["totals"].items()])]

    if report.get("serving"):
        s = report["serving"]
        md += ["", "## Serving", ""]
        md.append(f"- RPC front: **{s.get('workers')}** workers, "
                  f"pattern **{s.get('pattern')}**, "
                  f"{s.get('arrivals')} arrivals at {s.get('rate')}/s "
                  f"over {s.get('wall_s')}s")
        tiers = s.get("tiers") or {}
        if tiers:
            md += ["", *_md_table(
                ["tier", "arrivals", "goodput %", "shed %",
                 "p50 ms", "p99 ms", "p999 ms"],
                [[name, row.get("arrivals"), row.get("goodput_pct"),
                  row.get("shed_pct"), row.get("p50_ms"),
                  row.get("p99_ms"), row.get("p999_ms")]
                 for name, row in sorted(tiers.items())]), ""]
        md.append(f"- honest rejections: shed rate "
                  f"**{s.get('shed_rate')}** by reason "
                  f"{s.get('shed_by_reason')}")
        md.append(f"- hedged retries: {s.get('hedges')} hedges, "
                  f"{s.get('retries')} retries")
        md.append(f"- verified proofs: **{s.get('verified_proofs')}** "
                  f"(failures: {s.get('verify_failures')})")
        sf = s.get("singleflight") or {}
        md.append(f"- stampede suppression: {s.get('scheme_builds')} "
                  f"backing builds, {sf.get('waits', 0)} coalesced "
                  f"waiters, proof cache {s.get('proof_cache')}")
        md.append(f"- brownout transitions: "
                  f"{s.get('brownout_transitions')}; circuit breaker: "
                  f"{s.get('breaker_state')} "
                  f"({s.get('breaker_transitions')} transitions)")
        if s.get("chaos_injections"):
            md.append(f"- chaos injections: {s['chaos_injections']} "
                      f"(worker stalls served: {s.get('chaos_stalls')}, "
                      f"slow-loris closed: {s.get('slow_loris_closed')})")
        if s.get("slo_ms") is not None:
            verdict = "**met**" if s.get("slo_ok") else "**MISSED**"
            md.append(f"- interactive p99 SLO {s['slo_ms']} ms: {verdict}")

    if report.get("serving_mp"):
        s = report["serving_mp"]
        md += ["", "## Serving (multi-process)", ""]
        md.append(f"- plane: **{s.get('fronts')}** fronts x "
                  f"**{s.get('workers')}** worker processes over "
                  f"shared-memory view generation "
                  f"{s.get('board_generation')}")
        phases = [(name, s.get(name)) for name in ("steady", "chaos")
                  if s.get(name)]
        if phases:
            md += ["", *_md_table(
                ["phase", "arrivals", "rate/s", "goodput %", "p50 ms",
                 "p99 ms", "resends", "lost", "verify fails", "verdict"],
                [[name, p.get("arrivals"), p.get("rate"),
                  p.get("goodput_pct"), p.get("p50_ms"), p.get("p99_ms"),
                  p.get("resends"), p.get("lost"),
                  p.get("verify_failures"),
                  "ok" if p.get("ok") else "FAILED"]
                 for name, p in phases]), ""]
        if s.get("worker_rows"):
            md += [*_md_table(
                ["worker", "pid", "alive", "restarts", "requests",
                 "generation", "rss kb", "hb age s"],
                [[r.get("worker"), r.get("pid"), r.get("alive"),
                  r.get("restarts"), r.get("requests"),
                  r.get("generation"), r.get("rss_kb"),
                  r.get("hb_age_s")]
                 for r in s["worker_rows"]]), ""]
        if s.get("interruptions"):
            md.append(f"- worker interruptions "
                      f"({s.get('interruptions_by_reason')}; "
                      f"{s.get('chaos_kills_delivered')} chaos SIGKILLs "
                      f"delivered, {s.get('restarts')} respawns, "
                      f"{s.get('parked')} parked):")
            md += ["", *_md_table(
                ["worker", "reason", "pid", "exit code", "at wall s"],
                [[r.get("worker"), r.get("reason"), r.get("pid"),
                  r.get("exit_code"), r.get("wall_s")]
                 for r in s["interruptions"]]), ""]
        if s.get("interruption_events"):
            md += [f"- worker_interruption events: "
                   f"{len(s['interruption_events'])}", "", *_md_table(
                       ["worker", "reason", "pid", "exit code", "at wall s"],
                       [[r.get("worker"), r.get("reason"), r.get("pid"),
                         r.get("exit_code"), r.get("wall_s")]
                        for r in s["interruption_events"]]), ""]
        regen = s.get("respawned_on_current_generation")
        md.append(f"- respawned workers on current shared-memory "
                  f"generation: "
                  f"{'**yes**' if regen else '**NO — silent fork**'}")
        fl = s.get("fleet")
        if fl:
            lohi = fl.get("window") or [None, None]
            md += ["", "### Fleet metrics", ""]
            md.append(f"- workers reporting: "
                      f"**{fl.get('workers_reporting')}** "
                      f"({fl.get('snapshots_merged')} snapshots merged, "
                      f"{fl.get('snapshots_skipped')} skipped)")
            if fl.get("requests_by_worker"):
                md += ["", *_md_table(
                    ["worker", "requests (fleet counter)"],
                    [[w, int(n)] for w, n in sorted(
                        (fl["requests_by_worker"] or {}).items(),
                        key=lambda kv: int(kv[0]))]), ""]
            verdict = ("**consistent**" if fl.get("consistent")
                       else "**INCONSISTENT**")
            md.append(f"- fleet total {fl.get('requests_total')} vs "
                      f"loadgen window [{lohi[0]}, {lohi[1]}]: {verdict}")

    if report.get("dense_phase_budget"):
        d = report["dense_phase_budget"]
        md += ["", "## Dense phase budget", ""]
        md.append(f"- accounted: **{d.get('accounted_pct')}%** of the "
                  f"sampled slot wall ({d.get('sampled_wall_ms')} ms over "
                  f"{d.get('sampled_slots')} fenced slot(s))")
        md += ["", *_md_table(
            ["phase", "total ms", "share %"],
            [[name, row.get("total_ms"), row.get("share_pct")]
             for name, row in (d.get("phases") or {}).items()])]

    if report.get("device"):
        d = report["device"]
        md += ["", "## Device", ""]
        mem = d.get("memory") or {}
        if mem:
            peaks = ", ".join(
                f"{dev}: {b / (1 << 20):.1f} MiB"
                for dev, b in sorted((mem.get("peak_bytes") or {}).items()))
            md.append(f"- memory watermark ({mem.get('samples')} samples, "
                      f"source **{mem.get('source')}**): {peaks or 'n/a'}")
            if mem.get("source") == "host_rss":
                md.append("  - host_rss measures the whole PROCESS "
                          "(python, numpy, caches) — a CPU headroom "
                          "proxy, not accelerator memory")
        led = d.get("compile_ledger") or {}
        attr = led.get("attribution") or {}
        if attr and "builds" in attr:
            # the port's build ledger: kernel builds, one nvcc a source
            md.append(f"- build ledger: **{attr.get('named')}/"
                      f"{attr.get('builds')}** kernel builds on a named "
                      f"(function, phase) row ({attr.get('named_pct')}%)")
        elif attr:
            md.append(f"- compile ledger: **{attr.get('named')}/"
                      f"{attr.get('backend_compiles')}** backend "
                      f"compiles on a named (function, phase) row "
                      f"({attr.get('named_pct')}%)")
        rows = led.get("rows") or []
        if rows and any("source" in r for r in rows):
            md += ["", *_md_table(
                ["stage", "source", "function", "phase", "count", "seconds"],
                [[r.get("stage"), r.get("source"), r.get("function"),
                  r.get("phase"), r.get("count"), r.get("seconds")]
                 for r in rows[:12]])]
        elif rows:
            md += ["", *_md_table(
                ["stage", "function", "phase", "count", "seconds"],
                [[r.get("stage"), r.get("function"), r.get("phase"),
                  r.get("count"), r.get("seconds")]
                 for r in rows[:12]])]
        kern = d.get("kernels") or {}
        if kern.get("builds") or kern.get("launches"):
            md += ["", *_md_table(
                ["counter", "label", "total"],
                [["kernel_builds_total", f"source={k}", v]
                 for k, v in sorted((kern.get("builds") or {}).items())]
                + [["kernel_launches_total", f"kernel={k}", v]
                   for k, v in sorted((kern.get("launches") or {}).items())])]
        skew = d.get("shard_skew") or {}
        if skew.get("table"):
            md += ["", "shard skew (per phase x device):", "",
                   *_md_table(
                       ["phase", "device", "mean ms", "max ms", "probes"],
                       [[r.get("phase"), r.get("device"),
                         r.get("mean_ms"), r.get("max_ms"),
                         r.get("probes")]
                        for r in skew["table"][:16]])]
        elif skew.get("worst"):
            w = skew["worst"]
            md.append(f"- worst shard skew: {w.get('spread_ms')} ms "
                      f"spread in **{w.get('phase')}** at slot "
                      f"{w.get('slot')} ({skew.get('probes')} probes)")

    if report.get("das_serving"):
        d = report["das_serving"]
        md += ["", "## DAS serving", ""]
        md.append(f"- clients: **{d['clients']}** "
                  f"({d.get('samples_per_client', '?')} samples each, "
                  f"scheme: {d.get('scheme', '?')})")
        md.append(f"- samples served: **{d['samples_total']}** over "
                  f"{d['served_blocks']} served block(s), coalesced to "
                  f"{d['unique_requests_total']} unique cell fetches")
        md.append(f"- serving latency per coalesced request: "
                  f"p50 **{d['p50_ms']} ms**, p95 **{d['p95_ms']} ms** "
                  f"(typical served block; worst block p95 "
                  f"{d['worst_p95_ms']} ms)")
        if d.get("cache_hit_rate") is not None:
            md.append(f"- proof-path cache hit rate: "
                      f"**{d['cache_hit_rate']:.1%}**")
        if d.get("proof_bytes_per_sample") is not None:
            agg = " (one aggregated multiproof per served block)" \
                if d.get("aggregated") else ""
            md.append(f"- served proof bytes/sample: "
                      f"**{d['proof_bytes_per_sample']}**{agg}")
        md.append(f"- sample verification failures: {d['verify_failures']} "
                  f"(clients fully satisfied at last serve: "
                  f"{d['clients_all_ok_final']})")

    md += ["", "## Handler percentiles", ""]
    if report["handlers"]:
        md += _md_table(
            ["handler", "count", "p50 ms", "p95 ms", "total ms"],
            [[h, v["count"], v["p50_ms"], v["p95_ms"], v["total_ms"]]
             for h, v in report["handlers"].items()])
    else:
        md.append("- no handler timings in the log")

    if report.get("light_clients"):
        md += ["", "## Light clients", ""]
        md += _md_table(
            ["node", "records", "max head lag", "max finality lag",
             "final head lag", "final finality lag"],
            [[k, v["records"], v["max_head_lag"], v["max_finality_lag"],
              v["final_head_lag"], v["final_finality_lag"]]
             for k, v in report["light_clients"].items()])

    if report.get("top_device_ops"):
        md += ["", "## Top device ops", ""]
        for plane, rows in report["top_device_ops"].items():
            md.append(f"### {plane}")
            md += _md_table(["op", "total ms", "count"],
                            [[r["op"], r["total_ms"], r["count"]]
                             for r in rows])
            md.append("")

    if report.get("top_device_kernels"):
        md += ["", "## Top device kernels", ""]
        for plane, rows in report["top_device_kernels"].items():
            md.append(f"### {plane}")
            md += _md_table(["kernel", "total ms", "count", "launch paths"],
                            [[k, r["total_ms"], r["count"], r["paths"]]
                             for k, r in rows.items()])
            md.append("")

    if report.get("profiles"):
        md += ["", "## Device-time attribution", ""]
        for p in report["profiles"]:
            md.append(f"### region `{p.get('name', '?')}`")
            if p.get("error"):
                md.append(f"- profiling degraded: {p['error']}")
            attr = p.get("attribution") or {}
            if attr:
                rows = sorted(attr.items(),
                              key=lambda kv: -kv[1].get("total_ms", 0))
                md += _md_table(["span / kernel", "total ms", "ops"],
                                [[k, v.get("total_ms"), v.get("count")]
                                 for k, v in rows])
            sm = p.get("by_shard_map") or {}
            if sm:
                rows = sorted(sm.items(),
                              key=lambda kv: -kv[1].get("total_ms", 0))
                md += ["", "shard_map regions:", "", *_md_table(
                    ["shard_map region", "total ms", "ops"],
                    [[k, v.get("total_ms"), v.get("count")]
                     for k, v in rows])]
            md.append("")

    if report.get("cost_analysis"):
        cost = report["cost_analysis"]
        md += ["", "## Static cost analysis",
               f"(backend {cost.get('backend')}, "
               f"n={cost.get('n_validators')})", ""]
        rows = []
        for k, v in sorted((cost.get("kernels") or {}).items()):
            if "error" in v:
                rows.append([k, "error", v["error"][:40], "", ""])
            else:
                rows.append([k, v.get("flops"), v.get("bytes_accessed"),
                             v.get("temp_bytes"), v.get("peak_bytes")])
        md += _md_table(
            ["kernel", "flops", "bytes accessed", "temp B", "peak B"], rows)
    return "\n".join(md) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events", help="telemetry JSONL file")
    ap.add_argument("--json", help="write the report dict to this path")
    ap.add_argument("--markdown",
                    help="write markdown here instead of stdout")
    ap.add_argument("--top-ops",
                    help="top_ops.json to fold into the report (default: "
                         "auto-discovered next to the event log)")
    ap.add_argument("--cost",
                    help="profiling/cost.py JSON emission to fold in "
                         "(python -m pos_evolution_tpu_torch.profiling.cost "
                         "--json)")
    ap.add_argument("--bundle",
                    help="chaos-fuzz repro bundle the log belongs to "
                         "(default: auto-discovered when the log sits "
                         "next to a violations.json)")
    ap.add_argument("--device-ledger",
                    help="flight-recorder artifact to fold into the "
                         "Device section (default: auto-discovered "
                         "*device_ledger.json next to the event log)")
    ap.add_argument("--xplane", metavar="TRACE",
                    help="trace dir/file to summarize into the "
                         "top-device-ops table: xplane files, else "
                         "torch.profiler (Kineto) traces (absorbs "
                         "scripts/trace_summary.py; wins over --top-ops)")
    ap.add_argument("--top-n", type=int, default=10,
                    help="rows per plane for --xplane (default 10)")
    args = ap.parse_args(argv)

    events, merged_from = load_events(args.events)
    if merged_from:
        print(f"# merged {len(merged_from)} per-process event logs: "
              + ", ".join(os.path.basename(p) for p in merged_from),
              file=sys.stderr)
    top_ops_path = args.top_ops or discover_top_ops(args.events, events)
    if args.top_ops is None and top_ops_path is not None:
        print(f"# auto-discovered top-ops table: {top_ops_path}",
              file=sys.stderr)
    top_ops = None
    if args.xplane:
        # the trace_summary.py fold-in: summarize a trace directly into
        # the same table --top-ops would have carried; a trace dir with
        # no xplane file is read as torch.profiler's (Kineto) traces
        from pos_evolution_tpu_torch.profiling import kineto, xplane
        try:
            blob = xplane.summarize_path(args.xplane, args.top_n)
        except FileNotFoundError:
            blob = xplane.top_table(xplane.summarize_planes(
                kineto.parse_path(args.xplane)), args.top_n)
        top_ops = blob.get("planes", blob)
    elif top_ops_path and os.path.exists(top_ops_path):
        with open(top_ops_path) as fh:
            blob = json.load(fh)
        top_ops = blob.get("planes", blob)
    cost = None
    if args.cost and os.path.exists(args.cost):
        with open(args.cost) as fh:
            cost = json.load(fh)
    bundle = args.bundle or discover_bundle(args.events)
    ledger_path = args.device_ledger or discover_device_ledger(args.events)
    device_ledger = None
    if ledger_path and os.path.exists(ledger_path):
        if args.device_ledger is None:
            print(f"# auto-discovered device ledger: {ledger_path}",
                  file=sys.stderr)
        with open(ledger_path) as fh:
            device_ledger = json.load(fh)
    report = build_report(events, top_ops=top_ops, cost=cost, bundle=bundle,
                          device_ledger=device_ledger)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
    md = to_markdown(report)
    if args.markdown:
        with open(args.markdown, "w") as fh:
            fh.write(md)
    else:
        sys.stdout.write(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
