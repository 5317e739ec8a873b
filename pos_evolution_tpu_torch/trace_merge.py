"""Merge per-process span files into ONE Chrome trace (ISSUE 18 leg b).

Every process in the serving plane — the loadgen/harness process and
each worker — writes its sampled request spans to its own append-only
``spans.<pid>.jsonl`` (``telemetry/tracing.py``); nothing at runtime
coordinates across processes beyond the deterministic trace id riding
the frame protocol. This tool does the joining after the fact:

- discovers every ``spans.*.jsonl`` under the trace directory;
- re-bases all ``t0`` wall-clock stamps to the earliest span (Chrome
  trace timestamps are microsecond offsets, and epoch-seconds-as-µs
  overflows the viewer's usable range);
- renders each process as its own pid lane (``process_name`` metadata
  from the recorded ``proc`` label) with "X" duration slices, so one
  hedged request reads as a ladder: ``balancer_pick``/``client`` in the
  loadgen lane, ``queue_wait``/``service``/``backing`` in each worker
  lane that touched it;
- links the spans of one trace id with Chrome flow arrows (``s``/``t``/
  ``f`` events keyed by the trace id) so the cross-process hops are
  drawn, not inferred — a hedge that lands on two workers shows two
  linked service spans under one arrow chain.

The span files double as the programmatic source: every slice carries
``args.trace``, so Perfetto's query engine (or ``--trace ID`` here) can
pull one request's full timeline.

Usage:
    python scripts/trace_merge.py <trace_dir> [--out merged.json]
        [--trace ID] [--expect-pids N]

Prints a one-line inventory (files / processes / spans / traces);
``--expect-pids`` exits 1 when fewer distinct processes contributed
spans — the CI assertion that tracing actually crossed the process
boundary.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

_META_KEYS = ("trace", "name", "t0", "dur_ms", "pid", "proc", "tid")


def discover_span_files(directory: str) -> list[str]:
    return sorted(glob.glob(os.path.join(directory, "spans.*.jsonl")))


def read_spans(path: str) -> list[dict]:
    """Spans from one file; torn tail lines (a process killed mid-write)
    are skipped, never fatal — same posture as the fleet snapshots."""
    spans = []
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    span = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(span, dict) and "t0" in span \
                        and "trace" in span:
                    spans.append(span)
    except OSError:
        return []
    return spans


def load_directory(directory: str,
                   trace: str | None = None) -> list[dict]:
    spans = [s for path in discover_span_files(directory)
             for s in read_spans(path)]
    if trace is not None:
        spans = [s for s in spans if s.get("trace") == trace]
    return spans


def merge_chrome(spans: list[dict]) -> dict:
    """Span records -> Chrome trace_event JSON object form (the same
    shape ``profiling/export.py`` emits, loadable by Perfetto and
    chrome://tracing)."""
    out: list[dict] = []
    if not spans:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t0_min = min(float(s["t0"]) for s in spans)
    procs: dict[int, str] = {}
    for s in spans:
        pid = int(s.get("pid", 0))
        procs.setdefault(pid, str(s.get("proc", f"pid{pid}")))
    for pid, proc in sorted(procs.items()):
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": proc}})
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        ts_us = (float(s["t0"]) - t0_min) * 1e6
        dur_us = max(float(s.get("dur_ms", 0.0)) * 1e3, 0.5)
        args = {k: v for k, v in s.items() if k not in _META_KEYS}
        args["trace"] = s["trace"]
        slice_ = {"name": str(s.get("name", "?")), "cat": "request",
                  "ph": "X", "ts": round(ts_us, 3),
                  "dur": round(dur_us, 3), "pid": int(s.get("pid", 0)),
                  "tid": int(s.get("tid", 0)), "args": args}
        out.append(slice_)
        by_trace.setdefault(str(s["trace"]), []).append(slice_)
    # flow arrows: chain each trace's spans in start order so the
    # cross-process hops are DRAWN. The flow id is the trace id's low
    # bits; the events bind to their slice by (pid, tid, ts-inside).
    for trace, slices in sorted(by_trace.items()):
        if len(slices) < 2:
            continue
        slices = sorted(slices, key=lambda e: e["ts"])
        try:
            flow_id = int(trace, 16) & 0x7FFF_FFFF
        except ValueError:
            flow_id = abs(hash(trace)) & 0x7FFF_FFFF
        last = len(slices) - 1
        for k, e in enumerate(slices):
            ph = "s" if k == 0 else ("f" if k == last else "t")
            ev = {"ph": ph, "cat": "trace", "name": "request",
                  "id": flow_id, "pid": e["pid"], "tid": e["tid"],
                  "ts": round(e["ts"] + min(e["dur"] / 2, 0.25), 3)}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace_dir", help="directory of spans.*.jsonl files")
    ap.add_argument("--out", help="write the merged Chrome trace here "
                                  "(default: <trace_dir>/merged.json)")
    ap.add_argument("--trace", help="keep only this trace id")
    ap.add_argument("--expect-pids", type=int, default=0,
                    help="exit 1 unless at least this many distinct "
                         "processes contributed spans")
    args = ap.parse_args(argv)

    files = discover_span_files(args.trace_dir)
    spans = load_directory(args.trace_dir, trace=args.trace)
    merged = merge_chrome(spans)
    pids = {s["pid"] for s in spans if "pid" in s}
    traces = {s["trace"] for s in spans}
    out_path = args.out or os.path.join(args.trace_dir, "merged.json")
    with open(out_path, "w") as fh:
        json.dump(merged, fh)
        fh.write("\n")
    print(f"trace_merge: {len(files)} span files, {len(pids)} processes, "
          f"{len(spans)} spans, {len(traces)} traces -> {out_path}")
    if args.expect_pids and len(pids) < args.expect_pids:
        print(f"trace_merge: expected spans from >= {args.expect_pids} "
              f"processes, got {len(pids)} — tracing did not cross the "
              f"process boundary", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
