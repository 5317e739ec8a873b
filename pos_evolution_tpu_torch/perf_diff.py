"""Perf regression attribution: rank what explains a wall-clock delta
(the port's counterpart of ``scripts/perf_diff.py``).

``perf_gate`` tells you *that* a metric regressed; this tool says
*why* — it diffs two runs and ranks the phase walls, counters, and
build-ledger rows whose deltas best explain the wall-clock delta, so
a CI failure prints an attribution table instead of a bare ratio.

The port's ledger rows are kernel builds (``profiling/ledger``: one row a
kernel source, function and phase, ``stage`` "build"): each delta row
names its source, under "kernel-build deltas". A JAX-shaped ledger
(``stage`` a compile stage, no source) diffs as the JAX script diffs it.

Accepted inputs (each side independently):

- an **emission** JSON file (``resilient_run --json``, ``serve_demo
  --json``, or any emission with ``phases``/``counts``/``walls`` leaves);
- a **run summary** JSON (``DenseSimulation.summary()`` — the
  ``dense_phases``/``device`` sections are understood);
- an **event log** (``*.jsonl``): ``dense_phase`` events are
  re-aggregated into per-phase totals;
- via ``--history FILE --kind K``: the last two entries of that kind in
  a ``bench_history.jsonl`` (candidate = newest).

Ranking: phases sort by absolute delta-ms; each row carries the share
of the wall delta it explains. Counters rank by relative change,
ledger rows by build-count delta (a kernel rebuilt mid-run names its
culprit here). Exit code is always 0 — this is a diagnostic, the *gate*
decides pass/fail. No torch: it reads files, wherever Python runs.

Usage:
    python -m pos_evolution_tpu_torch.perf_diff BASELINE CANDIDATE [--top 10]
        [--json out]
    python -m pos_evolution_tpu_torch.perf_diff --history h.jsonl --kind K
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["diff", "load_side", "normalize", "render"]


def _phases_table(obj) -> dict:
    """Pull a ``{phase: total_ms}`` table out of any known shape."""
    if not isinstance(obj, dict):
        return {}
    for key in ("phases", "sampled_phases"):
        tab = obj.get(key)
        if isinstance(tab, dict) and tab:
            out = {}
            for name, row in tab.items():
                if isinstance(row, dict) and "total_ms" in row:
                    out[name] = float(row["total_ms"])
                elif isinstance(row, (int, float)):
                    out[name] = float(row)
            if out:
                return out
    for key in ("dense_phases", "dense_phase_budget"):
        if isinstance(obj.get(key), dict):
            nested = _phases_table(obj[key])
            if nested:
                return nested
    return {}


def _wall_ms(obj) -> float | None:
    if not isinstance(obj, dict):
        return None
    walls = obj.get("walls")
    if isinstance(walls, dict):
        for key in ("steady_ms", "budget_ms", "wall_ms"):
            if isinstance(walls.get(key), (int, float)):
                return float(walls[key])
    for key in ("wall_ms", "sampled_wall_ms"):
        if isinstance(obj.get(key), (int, float)):
            return float(obj[key])
    dense = obj.get("dense_phases")
    if isinstance(dense, dict):
        return _wall_ms(dense)
    return None


def _ledger_rows(obj) -> dict:
    """``{"stage|function|phase": count}`` from any shape carrying a
    ledger (emission ``device`` section or a raw summary); a kernel-build
    row's key is ``"build|source|function|phase"``."""
    if not isinstance(obj, dict):
        return {}
    led = obj.get("compile_ledger")
    if led is None and isinstance(obj.get("device"), dict):
        led = obj["device"].get("compile_ledger")
    rows = (led or {}).get("rows") if isinstance(led, dict) else None
    out = {}
    for r in rows or []:
        key = f"{r.get('stage')}|{r.get('function')}|{r.get('phase')}"
        if r.get("source") is not None:
            key = f"{r.get('stage')}|{r['source']}|{r.get('function')}|{r.get('phase')}"
        out[key] = out.get(key, 0) + int(r.get("count", 0))
    return out


def _counts(obj) -> dict:
    if not isinstance(obj, dict):
        return {}
    counts = obj.get("counts")
    if isinstance(counts, dict):
        return {k: v for k, v in counts.items()
                if isinstance(v, (int, float))}
    tel = obj.get("telemetry")
    if isinstance(tel, dict) and isinstance(tel.get("counts"), dict):
        return {k: v for k, v in tel["counts"].items()
                if isinstance(v, (int, float))}
    return {}


def normalize(obj) -> dict:
    """One side of the diff, reduced to comparable tables."""
    return {"wall_ms": _wall_ms(obj), "phases": _phases_table(obj),
            "counts": _counts(obj), "ledger": _ledger_rows(obj)}


def _from_events(path: str) -> dict:
    """Aggregate ``dense_phase`` events from a JSONL log into one side."""
    from pos_evolution_tpu_torch.telemetry.events import read_jsonl
    phases: dict[str, float] = {}
    wall = 0.0
    n = 0
    for ev in read_jsonl(path):
        if ev.get("type") != "dense_phase":
            continue
        n += 1
        wall += float(ev.get("wall_ms") or 0.0)
        for name, ms in (ev.get("phases") or {}).items():
            phases[name] = phases.get(name, 0.0) + float(ms)
    return {"wall_ms": round(wall, 4) if n else None,
            "phases": {k: round(v, 4) for k, v in phases.items()},
            "counts": {}, "ledger": {}}


def load_side(path: str) -> dict:
    """Load one comparand: ``.jsonl`` -> event aggregation, else a JSON
    document fed through ``normalize``."""
    if path.endswith(".jsonl"):
        return _from_events(path)
    with open(path) as fh:
        return normalize(json.load(fh))


def diff(baseline: dict, candidate: dict, top: int = 10) -> dict:
    """Rank deltas between two normalized (or normalizable) sides."""
    normalized_keys = {"wall_ms", "phases", "counts", "ledger"}
    if set(baseline) != normalized_keys:
        baseline = normalize(baseline)
    if set(candidate) != normalized_keys:
        candidate = normalize(candidate)
    b_ph, c_ph = baseline["phases"], candidate["phases"]
    wall_b, wall_c = baseline["wall_ms"], candidate["wall_ms"]
    wall_delta = (wall_c - wall_b
                  if wall_b is not None and wall_c is not None else None)
    if wall_delta is None:
        wall_delta = sum(c_ph.values()) - sum(b_ph.values())

    phase_rows = []
    for name in sorted(set(b_ph) | set(c_ph)):
        b, c = b_ph.get(name, 0.0), c_ph.get(name, 0.0)
        d = c - b
        row = {"phase": name, "baseline_ms": round(b, 4),
               "candidate_ms": round(c, 4), "delta_ms": round(d, 4),
               "ratio": round(c / b, 4) if b > 0 else None,
               "wall_share_pct": (round(100.0 * d / wall_delta, 2)
                                  if wall_delta else None)}
        phase_rows.append(row)
    phase_rows.sort(key=lambda r: -abs(r["delta_ms"]))

    counter_rows = []
    b_ct, c_ct = baseline["counts"], candidate["counts"]
    for name in sorted(set(b_ct) | set(c_ct)):
        b, c = b_ct.get(name, 0), c_ct.get(name, 0)
        if b == c:
            continue
        counter_rows.append({
            "counter": name, "baseline": b, "candidate": c,
            "delta": c - b, "ratio": round(c / b, 4) if b else None})
    counter_rows.sort(key=lambda r: -(abs(r["ratio"] - 1.0)
                                      if r["ratio"] else float("inf")))

    ledger_rows = []
    b_led, c_led = baseline["ledger"], candidate["ledger"]
    for key in sorted(set(b_led) | set(c_led)):
        b, c = b_led.get(key, 0), c_led.get(key, 0)
        if b == c:
            continue
        parts = key.split("|")
        if len(parts) == 4:
            # a kernel build: its source named
            stage, source, fn, phase = parts
            ledger_rows.append({"stage": stage, "source": source, "function": fn,
                                "phase": phase, "baseline": b, "candidate": c,
                                "delta": c - b})
            continue
        stage, fn, phase = (parts + ["?", "?"])[:3]
        ledger_rows.append({"stage": stage, "function": fn, "phase": phase,
                            "baseline": b, "candidate": c, "delta": c - b})
    ledger_rows.sort(key=lambda r: -abs(r["delta"]))

    return {
        "wall": {"baseline_ms": wall_b, "candidate_ms": wall_c,
                 "delta_ms": (round(wall_delta, 4)
                              if wall_delta is not None else None)},
        "phases": phase_rows[:top],
        "counters": counter_rows[:top],
        "compile_ledger": ledger_rows[:top],
        "top_phase": phase_rows[0]["phase"] if phase_rows else None,
    }


def render(d: dict) -> str:
    lines = []
    w = d["wall"]
    if w["baseline_ms"] is not None and w["candidate_ms"] is not None:
        lines.append(f"wall: {w['baseline_ms']:.2f} ms -> "
                     f"{w['candidate_ms']:.2f} ms "
                     f"({w['delta_ms']:+.2f} ms)")
    if d["phases"]:
        lines.append("phase attribution (|delta| desc):")
        lines.append(f"  {'phase':<22} {'baseline':>10} {'candidate':>10} "
                     f"{'delta':>9} {'share':>7}")
        for r in d["phases"]:
            share = (f"{r['wall_share_pct']:6.1f}%"
                     if r["wall_share_pct"] is not None else "      -")
            lines.append(f"  {r['phase']:<22} {r['baseline_ms']:>10.2f} "
                         f"{r['candidate_ms']:>10.2f} "
                         f"{r['delta_ms']:>+9.2f} {share}")
    if d["counters"]:
        lines.append("counter deltas (relative change desc):")
        for r in d["counters"]:
            ratio = f"x{r['ratio']}" if r["ratio"] is not None else "new"
            lines.append(f"  {r['counter']:<46} {r['baseline']} -> "
                         f"{r['candidate']} ({ratio})")
    builds = [r for r in d["compile_ledger"] if "source" in r]
    if builds:
        lines.append("kernel-build deltas (rebuild culprits):")
        for r in builds:
            lines.append(f"  {r['source']:<20} {r['function']:<28} "
                         f"phase={r['phase']:<18} {r['baseline']} -> "
                         f"{r['candidate']} ({r['delta']:+d})")
    compiles = [r for r in d["compile_ledger"] if "source" not in r]
    if compiles:
        lines.append("compile-ledger deltas (recompile culprits):")
        for r in compiles:
            lines.append(f"  {r['stage']:<16} {r['function']:<28} "
                         f"phase={r['phase']:<18} {r['baseline']} -> "
                         f"{r['candidate']} ({r['delta']:+d})")
    if d.get("top_phase"):
        lines.append(f"top attribution: {d['top_phase']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("baseline", nargs="?",
                    help="emission/summary JSON or event-log .jsonl")
    ap.add_argument("candidate", nargs="?",
                    help="emission/summary JSON or event-log .jsonl")
    ap.add_argument("--history",
                    help="bench_history.jsonl; diffs the last two "
                         "entries of --kind instead of two files")
    ap.add_argument("--kind", help="history kind (with --history)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", help="write the attribution table here")
    args = ap.parse_args(argv)

    if args.history:
        from pos_evolution_tpu_torch.profiling.history import read_history
        entries = [e for e in read_history(args.history)
                   if args.kind in (None, e.get("kind"))]
        if len(entries) < 2:
            print(f"perf_diff: need >= 2 history entries of kind "
                  f"{args.kind!r}, found {len(entries)}", file=sys.stderr)
            return 0
        baseline = normalize(entries[-2].get("emission") or {})
        candidate = normalize(entries[-1].get("emission") or {})
    elif args.baseline and args.candidate:
        baseline = load_side(args.baseline)
        candidate = load_side(args.candidate)
    else:
        ap.error("need BASELINE CANDIDATE files or --history/--kind")
        return 2  # unreachable; ap.error raises

    d = diff(baseline, candidate, top=args.top)
    print(render(d))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(d, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
