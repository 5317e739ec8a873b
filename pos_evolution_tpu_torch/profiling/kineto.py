"""torch.profiler traces read into the plane schema of ``profiling/xplane.py``
(the port's counterpart of ``xplane.parse_path``).

torch.profiler (Kineto) writes a Chrome trace_event JSON, ``*.pt.trace.json``
(``torch.profiler.tensorboard_trace_handler`` or ``export_chrome_trace``;
``.json.gz`` too). ``parse_trace`` reads one into the structural view
``xplane.parse_xspace`` returns, so the attribution, the exporters and the
top-ops table work on it unchanged:

    [{name, event_metadata: {id: op_name},
      lines: [{name, timestamp_ns, events: [{metadata_id, offset_ps, duration_ps}]}]}]

Planes:

- ``/device:GPU:<i>``, one per GPU (``xplane.is_device_plane`` matches it),
  one line per stream (``stream <s>``), holding the device's work: kernels,
  copies and memsets. Kineto's ``gpu_user_annotation`` slices, a range's
  projection onto the stream, envelop the kernels they cover and are left
  out: they would count the work twice;
- ``/host:CPU``, one line per host thread, holding every host slice (ranges,
  torch operators, CUDA runtime and driver calls) under its own name.

**A device event's op name is the path of its launch**: the host ranges
(``record_function`` and other user annotations) that enclose the launch
on the launching thread, outermost first, then the innermost torch operator
enclosing it (a ``namespace::name``, where torch launched the kernel; a
TorchScript fusion group's operator is named as its kernel and appears
once), then the kernel's function name, joined by ``/``:
``sim_run/slot/aggregate_verify/(anonymous namespace)::agg_sig_kernel(...)``.
That is the counterpart of XLA's ``jit(f)/.../op`` metadata, on which
``attribution.op_frames`` and ``attribute_to_spans`` work. A ``/`` inside a
name becomes ``|`` so that the path splits only between its segments.

The launch is found through Kineto's correlation: the CUDA runtime or
driver call (``cudaLaunchKernel``, or ``cuLaunchKernel`` where TorchScript's
fuser launches) whose ``correlation`` argument is the device event's, or
else the start of the ``ac2g`` flow with that id. Kernels launched through
``ctypes`` from the port's own libraries (``ops/kernels.py``) are linked
the same way: their ``cudaLaunchKernel`` is recorded with its correlation
(on an NVIDIA H100 with torch 2.11 and CUDA 12.8). A device event whose
launch is not in the trace keeps its bare function name, so totals are
kept. No link is guessed from wall-clock overlap: a launch is
asynchronous, and its kernel runs after the host has left the range.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"user_annotation", "cpu_op", "cuda_runtime", "cuda_driver"})
_LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
_RANGE, _OPERATOR = "user_annotation", "cpu_op"
HOST_PLANE = "/host:CPU"


def _ns(ts) -> int:
    """A trace time in microseconds (a float with ns digits) -> int ns."""
    return int(round(float(ts) * 1000))


def _segment(name: str) -> str:
    return name.replace("/", "|")


def _enclosing(slices: list, points: list) -> dict:
    """For each launch point (ts_ns, key) on one thread, the names the
    path takes from the host slices enclosing it: the ranges, outermost
    first, then the innermost operator, if any. ``slices`` are (start_ns,
    end_ns, category, name)."""
    slices = sorted(slices, key=lambda s: (s[0], -s[1]))
    out, open_, i = {}, [], 0
    for ts, key in sorted(points):
        while i < len(slices) and slices[i][0] <= ts:
            open_.append(slices[i])
            i += 1
        open_ = [s for s in open_ if s[1] >= ts]
        ranges = [_segment(s[3]) for s in open_ if s[2] == _RANGE]
        ops = [s for s in open_ if s[2] == _OPERATOR]
        out[key] = ranges + ([_segment(ops[-1][3])] if ops else [])
    return out


class _Plane:
    def __init__(self, name: str):
        self.name = name
        self.ids: dict[str, int] = {}
        self.lines: dict = {}     # key -> (line name, [(start_ns, dur_ps, op)])

    def add(self, key, line_name: str, start_ns: int, dur_ps: int, op: str) -> None:
        self.lines.setdefault(key, (line_name, []))[1].append((start_ns, dur_ps, op))

    def build(self) -> dict:
        lines = []
        for key in sorted(self.lines):
            name, evs = self.lines[key]
            evs.sort(key=lambda e: e[0])
            t0 = evs[0][0]
            events = []
            for start, dur, op in evs:
                mid = self.ids.setdefault(op, len(self.ids) + 1)
                events.append({"metadata_id": mid, "offset_ps": (start - t0) * 1000,
                               "duration_ps": dur})
            lines.append({"name": name, "timestamp_ns": t0, "events": events})
        return {"name": self.name,
                "event_metadata": {mid: op for op, mid in self.ids.items()},
                "lines": lines}


def parse_trace(trace: dict) -> list[dict]:
    """One Kineto Chrome trace (the parsed JSON object) -> planes in the
    ``xplane.parse_xspace`` schema: the GPU planes by index, then the
    host plane."""
    base = int(trace.get("baseTimeNanoseconds") or 0)
    threads: dict = {}      # (pid, tid) -> thread name
    host: dict = {}         # (pid, tid) -> [slice]
    device = []
    launches: dict = {}     # correlation -> (pid, tid, ts_ns)
    flows: dict = {}        # ac2g id -> (pid, tid, ts_ns) of its start
    for e in trace.get("traceEvents", ()):
        ph, cat = e.get("ph"), e.get("cat")
        if ph == "X" and cat in DEVICE_CATS:
            device.append(e)
        elif ph == "X" and cat in HOST_CATS:
            start = base + _ns(e["ts"])
            thread = (e.get("pid"), e.get("tid"))
            host.setdefault(thread, []).append(
                (start, start + _ns(e.get("dur", 0)), cat, e.get("name", "")))
            corr = (e.get("args") or {}).get("correlation")
            if cat in _LAUNCH_CATS and corr is not None:
                launches.setdefault(corr, (*thread, start))
        elif ph == "s" and cat == "ac2g":
            flows.setdefault(e.get("id"), (e.get("pid"), e.get("tid"), base + _ns(e["ts"])))
        elif ph == "M" and e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = (e.get("args") or {}).get("name")

    # each device event's launch point, grouped by the launching thread
    points: dict = {}
    for i, e in enumerate(device):
        corr = (e.get("args") or {}).get("correlation")
        at = launches.get(corr) or flows.get(corr) if corr is not None else None
        if at is not None and (at[0], at[1]) in host:
            points.setdefault((at[0], at[1]), []).append((at[2], i))
    prefix: dict = {}
    for thread, pts in points.items():
        prefix.update(_enclosing(host[thread], pts))

    gpus: dict[int, _Plane] = {}
    for i, e in enumerate(device):
        args = e.get("args") or {}
        index = args.get("device", e.get("pid"))
        index = index if isinstance(index, int) else 0
        stream = args.get("stream", e.get("tid"))
        plane = gpus.setdefault(index, _Plane(f"/device:GPU:{index}"))
        name = _segment(e.get("name", ""))
        path = list(prefix.get(i, ()))
        if path and path[-1] == name:
            path.pop()      # a TorchScript fusion group: its range is named as its kernel
        op = "/".join([*path, name])
        plane.add(stream, f"stream {stream}", base + _ns(e["ts"]),
                  int(round(float(e.get("dur", 0)) * 1e6)), op)
    planes = [gpus[k].build() for k in sorted(gpus)]
    if host:
        cpu = _Plane(HOST_PLANE)
        for thread, slices in host.items():
            name = threads.get(thread) or f"thread {thread[1]}"
            for start, end, _cat, op in slices:
                cpu.add(thread, name, start, (end - start) * 1000, op)
        planes.append(cpu.build())
    return planes


def trace_files(path) -> list[str]:
    """The torch.profiler traces a directory (searched recursively) or a
    single file holds."""
    path = os.fspath(path)
    if os.path.isfile(path):
        return [path]
    return sorted(f for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
                  for f in glob.glob(os.path.join(path, "**", pattern), recursive=True))


def parse_path(path) -> list[dict]:
    """``parse_trace`` over every torch.profiler trace under ``path``."""
    files = trace_files(path)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {path}")
    planes = []
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            planes.extend(parse_trace(json.load(fh)))
    return planes
