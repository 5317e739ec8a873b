"""Trace exporters: telemetry JSONL + device ops -> Chrome trace_event
JSON (Perfetto-loadable) and collapsed-stack flamegraphs (port of
``pos_evolution_tpu/profiling/export.py``; the functions are the JAX
package's, and on the same events and planes they write the same bytes).

Two timelines, one file:

- **sim lane (pid 1)**: the message-lifecycle span tree from the event
  bus. ``deliver`` events carry sim-time ``t`` (seconds) and measured
  ``duration_ms``; ``gossip`` edges carry ``t``; ``propose``/``attest``
  roots carry no time of their own, so they inherit the earliest ``t``
  of their children (the span tree is deterministic ids, so the join is
  exact). Events with no derivable time fall back to ``seq``
  microseconds — structurally valid, ordinal rather than temporal.
  ``tid`` is the view-group id, so each group's deliveries read as one
  thread track.
- **device lane (pid 2)**: the device planes of a torch.profiler trace
  (``profiling/kineto.py``), one thread per stream, using the line's
  ``timestamp_ns`` + per-event ``offset_ps``. Device timestamps are
  wall-clock and sim ``t`` is simulation time — the two lanes are
  separate pids precisely because their clocks do not share an origin;
  Perfetto renders them as independent process tracks.

Flamegraphs are Brendan-Gregg collapsed stacks (``a;b;c <weight>``):
the sim view stacks event types along span lineage
(``propose;gossip;deliver:on_block``) weighted by measured microseconds
(count when unmeasured); the device view splits each device event's
launch path (``sim_run;slot;on_block;aten::index_add_;<kernel>``)
weighted by device microseconds.

CLI:
    python -m pos_evolution_tpu_torch.profiling.export events.jsonl
        [--chrome out.json] [--flame out.txt] [--trace trace_dir]
        [--device-flame out2.txt]

``--trace`` takes a torch.profiler trace (a ``*.pt.trace.json`` file or
a directory of them, as ``tensorboard_trace_handler`` and
``utils/metrics.device_trace`` write it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pos_evolution_tpu_torch.profiling import kineto as _kineto
from pos_evolution_tpu_torch.profiling import xplane as _xplane

SIM_PID = 1
DEVICE_PID = 2

# span-carrying / duration-carrying event types rendered as slices; any
# OTHER bus event that carries sim-time ``t`` (faults on a timed edge,
# custom emitters) becomes an instant marker — events with no derivable
# time are dropped rather than plotted at a fake position
_SLICE_TYPES = {"propose", "attest", "gossip", "deliver", "handler"}


def _event_name(ev: dict) -> str:
    t = ev.get("type", "?")
    qual = ev.get("handler") or ev.get("kind")
    return f"{t}:{qual}" if qual else t


def _span_times(events) -> dict[str, float]:
    """span id -> start seconds: own ``t`` when carried, else the
    earliest ``t`` among descendants (exact: ids are deterministic)."""
    children: dict[str, list[dict]] = {}
    by_span: dict[str, dict] = {}
    for ev in events:
        s = ev.get("span")
        if s is not None:
            by_span.setdefault(s, ev)
        p = ev.get("parent")
        if p is not None:
            children.setdefault(p, []).append(ev)

    times: dict[str, float] = {}

    def start_of(span, ev, depth=0) -> float | None:
        if span in times:
            return times[span]
        t = ev.get("t")
        if t is None and depth < 8:
            kids = [start_of(k.get("span"), k, depth + 1)
                    for k in children.get(span, ())]
            kids = [k for k in kids if k is not None]
            t = min(kids) if kids else None
        if t is not None:
            times[span] = float(t)
        return times.get(span)

    for span, ev in by_span.items():
        start_of(span, ev)
    return times


def chrome_trace(events, device_planes=None,
                 max_device_events: int | None = None) -> dict:
    """-> ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` (the JSON
    object form of the Chrome trace_event format; Perfetto and
    chrome://tracing both load it).

    ``max_device_events`` caps the device lane at the N longest slices —
    a long run records one event per kernel, hundreds of thousands of
    them (tens of MB of JSON), and the long ones are the ones worth
    looking at. Never a silent cap: the dropped count lands in a ``truncated``
    metadata event and the caller's log."""
    out = [
        {"ph": "M", "pid": SIM_PID, "name": "process_name",
         "args": {"name": "simulation (sim-time)"}},
    ]
    times = _span_times(events)
    for ev in events:
        typ = ev.get("type")
        if typ not in _SLICE_TYPES:
            if ev.get("t") is not None:  # timed marker (e.g. fault)
                out.append({"name": _event_name(ev), "cat": typ, "ph": "i",
                            "s": "p", "ts": round(float(ev["t"]) * 1e6, 3),
                            "pid": SIM_PID,
                            "tid": int(ev.get("group",
                                              ev.get("dst", 0)) or 0)})
            continue
        span = ev.get("span")
        t = ev.get("t")
        if t is None and span is not None:
            t = times.get(span)
        ts_us = float(t) * 1e6 if t is not None \
            else float(ev.get("seq", 0))  # ordinal fallback
        dur_ms = ev.get("duration_ms")
        dur_us = float(dur_ms) * 1e3 if dur_ms is not None else 1.0
        args = {k: v for k, v in ev.items()
                if k in ("slot", "status", "reason", "proposer", "committee",
                         "src", "dst", "kind", "handler", "span", "parent")}
        out.append({
            "name": _event_name(ev), "cat": typ, "ph": "X",
            "ts": round(ts_us, 3), "dur": round(dur_us, 3),
            "pid": SIM_PID, "tid": int(ev.get("group", ev.get("dst", 0)) or 0),
            "args": args,
        })
    if device_planes:
        out.append({"ph": "M", "pid": DEVICE_PID, "name": "process_name",
                    "args": {"name": "device (wall-clock)"}})
        tid = 0
        dev = []
        t0_ns = min((line["timestamp_ns"] for p in device_planes
                     for line in p["lines"] if line["events"]), default=0)
        for plane in device_planes:
            for line in plane["lines"]:
                if not line["events"]:
                    continue
                tid += 1
                out.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"{plane['name']}/"
                                             f"{line['name'] or tid}"}})
                base_us = (line["timestamp_ns"] - t0_ns) / 1e3
                meta = plane["event_metadata"]
                for e in line["events"]:
                    op = meta.get(e["metadata_id"], f"#{e['metadata_id']}")
                    dev.append({
                        "name": op.rsplit("/", 1)[-1] or op, "cat": "device",
                        "ph": "X",
                        "ts": round(base_us + e["offset_ps"] / 1e6, 3),
                        "dur": round(max(e["duration_ps"] / 1e6, 0.001), 3),
                        "pid": DEVICE_PID, "tid": tid,
                        "args": {"op_name": op},
                    })
        if max_device_events is not None and len(dev) > max_device_events:
            dropped = len(dev) - max_device_events
            dev.sort(key=lambda e: -e["dur"])
            dev = sorted(dev[:max_device_events], key=lambda e: e["ts"])
            out.append({"ph": "M", "pid": DEVICE_PID, "name": "truncated",
                        "args": {"dropped_short_events": dropped,
                                 "kept": max_device_events}})
        out.extend(dev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def collapsed_stacks(events) -> list[str]:
    """Sim-side flamegraph: one line per unique span-lineage stack,
    ``frame;frame;frame weight`` with integer microsecond weights
    (1 per event when no duration was measured)."""
    by_span: dict[str, dict] = {}
    for ev in events:
        s = ev.get("span")
        if s is not None and s not in by_span:
            by_span[s] = ev

    stacks: dict[str, int] = {}
    for ev in events:
        if ev.get("type") not in _SLICE_TYPES:
            continue
        frames = [_event_name(ev)]
        parent = ev.get("parent")
        hops = 0
        while parent is not None and hops < 8:
            pev = by_span.get(parent)
            if pev is None:
                break
            frames.append(_event_name(pev))
            parent = pev.get("parent")
            hops += 1
        key = ";".join(reversed(frames))
        dur_ms = ev.get("duration_ms")
        weight = int(round(float(dur_ms) * 1e3)) if dur_ms is not None else 1
        stacks[key] = stacks.get(key, 0) + max(weight, 1)
    return [f"{k} {v}" for k, v in sorted(stacks.items())]


def device_collapsed_stacks(planes, exclude_ops=frozenset()) -> list[str]:
    """Device-side flamegraph: the launch path as the stack, device
    microseconds as the weight. Planes go through the shared
    ``xplane.select_planes`` device filter, and ``exclude_ops`` drops
    enveloping slices (on the host-plane fallback a region's own range
    overlaps every op it launched — folding both in double-counts),
    matching the attribution views."""
    from pos_evolution_tpu_torch.profiling.attribution import is_python_frame
    stacks: dict[str, int] = {}
    for _, _, op, _, dur in _xplane.iter_ops(_xplane.select_planes(planes)):
        if is_python_frame(op) or op in exclude_ops:
            continue
        key = ";".join(seg.replace(" ", "_")
                       for seg in op.split("/") if seg) or "unknown"
        us = max(int(round(dur / 1e6)), 1)
        stacks[key] = stacks.get(key, 0) + us
    return [f"{k} {v}" for k, v in sorted(stacks.items())]


def write_artifacts(outdir, events=(), planes=None, top_ops=None,
                    max_device_events: int | None = None,
                    exclude_ops=frozenset()) -> dict:
    """Write the standard artifact set into ``outdir`` and return
    ``{artifact: path}`` — the ONE place the filenames live (the sim
    driver and any reader of a profile directory depend on them
    agreeing):

    - ``chrome_trace.json``  always (sim spans + device ops);
    - ``flame.txt``          when span events were given;
    - ``flame_device.txt``   when trace planes were given;
    - ``top_ops.json``       when a top-op table was given (callers that
      own a separate top_ops protocol pass None).
    """
    outdir = os.fspath(outdir)
    os.makedirs(outdir, exist_ok=True)
    events = list(events)
    written = {}

    def _path(name):
        written[name] = os.path.join(outdir, name)
        return written[name]

    with open(_path("chrome_trace.json"), "w") as fh:
        json.dump(chrome_trace(events, device_planes=planes,
                               max_device_events=max_device_events), fh)
        fh.write("\n")
    if events:
        with open(_path("flame.txt"), "w") as fh:
            fh.write("\n".join(collapsed_stacks(events)) + "\n")
    if planes:
        with open(_path("flame_device.txt"), "w") as fh:
            fh.write("\n".join(
                device_collapsed_stacks(planes, exclude_ops=exclude_ops))
                + "\n")
    if top_ops:
        with open(_path("top_ops.json"), "w") as fh:
            json.dump({"source": "profiled_region", "planes": top_ops},
                      fh, indent=1)
            fh.write("\n")
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events", help="telemetry JSONL file")
    ap.add_argument("--chrome", help="write Chrome trace_event JSON here")
    ap.add_argument("--flame", help="write sim collapsed stacks here")
    ap.add_argument("--trace",
                    help="torch.profiler trace dir/file to fold device ops in")
    ap.add_argument("--device-flame",
                    help="write device collapsed stacks here")
    ap.add_argument("--max-device-events", type=int, default=50_000,
                    help="cap the Chrome device lane at the N longest "
                         "slices (0 = unlimited; a long run records one "
                         "event per kernel — tens of MB untruncated)")
    args = ap.parse_args(argv)

    from pos_evolution_tpu_torch.telemetry import read_jsonl
    events = read_jsonl(args.events)
    planes = _kineto.parse_path(args.trace) if args.trace else None
    cap = args.max_device_events or None

    wrote = []
    if args.chrome:
        with open(args.chrome, "w") as fh:
            json.dump(chrome_trace(events, device_planes=planes,
                                   max_device_events=cap), fh)
            fh.write("\n")
        wrote.append(args.chrome)
    if args.flame:
        with open(args.flame, "w") as fh:
            fh.write("\n".join(collapsed_stacks(events)) + "\n")
        wrote.append(args.flame)
    if args.device_flame:
        if planes is None:
            print("--device-flame needs --trace", file=sys.stderr)
            return 2
        with open(args.device_flame, "w") as fh:
            fh.write("\n".join(device_collapsed_stacks(planes)) + "\n")
        wrote.append(args.device_flame)
    if not wrote:
        json.dump(chrome_trace(events, device_planes=planes,
                               max_device_events=cap), sys.stdout)
        sys.stdout.write("\n")
    else:
        print("wrote: " + ", ".join(wrote), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
