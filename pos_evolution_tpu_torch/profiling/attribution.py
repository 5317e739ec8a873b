"""Device-time attribution: from a torch.profiler trace back to the code
that launched it (port of ``pos_evolution_tpu/profiling/attribution.py``).

``profiling/kineto.py`` names every device event by the path of its
launch, the host ranges enclosing it, outermost first, then the torch
operator that launched it, if one did, then the kernel:

    sim_run/slot/on_block/aten::index_add_/void at::native::indexFuncLargeIndex<...>(...)

That path plays the part of XLA's ``jit(f)/.../op`` metadata in the JAX
package. Its *innermost host range* (the segment before the kernel, past
the launching operator: torch operators are ``namespace::name``) names
the code that launched the work: ``innermost_jit`` returns it and
``group_by_jit`` groups by it, with ``"unranged"`` for work that no range
encloses. Spans on the telemetry bus (handler names like
``on_block``/``get_head``, span ids, extra names) are matched against the
path's segments, folding device milliseconds onto the span that launched
them; everything unmatched lands in ``unattributed`` so the table always
sums to the trace total (no silently vanishing time).
``group_by_shard_map`` is not ported: a device mesh is ROADMAP Queue 1
item 3.

``ProfiledRegion`` is the capture harness: a context manager that wraps
any sim/bench section in a ``torch.profiler`` session (CPU and CUDA
activities where CUDA is available, CPU alone otherwise) and a
``record_function`` range of its name, writes the trace into
``trace_dir``, reads it back with ``kineto.parse_path``, attributes device
work to the telemetry spans emitted *during the region*, and (when a
telemetry bundle is attached) emits one ``profile`` event carrying the
summary, with the JAX package's keys, so run reports can show "where the
device time went" next to "what happened".

The region's own range encloses every launch it makes, so its name is a
segment of every path in it. It is therefore not an attribution target
in its own right: a kernel no span claims goes to the innermost range of
its path inside the region, which is the region's own name only where no
tighter range encloses the launch.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile

from pos_evolution_tpu_torch.profiling import kineto, ledger, xplane

_JIT_RE = re.compile(r"jit\(([^()]*)\)")


def is_python_frame(op_name: str) -> bool:
    """Host python-tracer frames (``$file.py:123 fn``) — timeline context,
    not executed device work; the aggregate views skip them (they nest
    around everything and would double-count the real ops under them)."""
    return op_name.startswith("$")


def op_frames(op_name: str) -> list[str]:
    """The scope path of one op: ``sim_run/slot/aten::add/kernel`` ->
    ``['sim_run', 'slot', 'aten::add', 'kernel']``."""
    return [seg for seg in op_name.split("/") if seg]


def innermost_jit(op_name: str) -> str | None:
    """The innermost host range of an op's path: the segment before the
    kernel's name, past the torch operator that launched it (a
    ``namespace::name``); None for a bare name (no range enclosed the
    launch, or the launch is not in the trace)."""
    frames = op_frames(op_name)[:-1]
    if frames and "::" in frames[-1]:
        frames.pop()
    return frames[-1] if frames else None


def group_by_jit(planes, device_only: bool = True,
                 exclude_ops=frozenset()) -> dict[str, dict]:
    """Aggregate a trace's planes by innermost host range:
    ``{range: {"total_ms", "count", "ops": {op: [ms, count]}}}``.

    ``exclude_ops``: op names dropped entirely — ``ProfiledRegion``
    passes its own range's name here, because on the CPU-plane
    fallback the region's slice *envelops* every op it launched and
    would double-count the whole region as work.
    Ops that no range encloses key under ``"unranged"``. ``device_only``
    keeps planes whose name smells like a device (``xplane.
    is_device_plane``); on a CPU-only run nothing matches, so it falls
    back to every plane — the host timeline is the only one there."""
    chosen = xplane.select_planes(planes, device_only)
    out: dict[str, dict] = {}
    key_of: dict[str, str] = {}  # op_name -> key: a trace has ~10^5 events
    # but far fewer distinct op names; resolve each once
    for _, _, op, _, dur in xplane.iter_ops(chosen):
        key = key_of.get(op)
        if key is None:
            if is_python_frame(op) or op in exclude_ops:
                key_of[op] = ""
                continue
            key = key_of[op] = innermost_jit(op) or "unranged"
        elif not key:
            continue
        row = out.setdefault(key, {"total_ms": 0.0, "count": 0, "ops": {}})
        ms = dur / 1e9
        row["total_ms"] += ms
        row["count"] += 1
        cell = row["ops"].setdefault(op, [0.0, 0])
        cell[0] += ms
        cell[1] += 1
    for row in out.values():
        row["total_ms"] = round(row["total_ms"], 4)
        row["ops"] = {k: [round(v[0], 4), v[1]]
                      for k, v in sorted(row["ops"].items(),
                                         key=lambda kv: -kv[1][0])}
    return out


def attribute_to_spans(planes, span_names, device_only: bool = True,
                       exclude_ops=frozenset(), region: str | None = None) -> dict:
    """Fold device op time onto telemetry span / range names.
    ``exclude_ops`` as in ``group_by_jit`` (enveloping slices must not be
    counted as the work they contain).

    An op attributes to the first span name (iteration order of
    ``span_names``) that appears in the op's scope path — as a
    ``jit(<name>)`` frame, a literal path segment (host ranges are
    segments), or a substring of a segment (exact/segment matches are
    tried first, substring last). With ``region`` (a ``ProfiledRegion``'s
    name), an op no span name claims whose path runs through the region
    goes to its innermost range (``innermost_jit``), so the region's own
    name claims only what no tighter range encloses. Ops nothing claims
    land in ``"unattributed"`` — the table is a partition of the trace,
    totals preserved. Without ``region`` the result is the JAX package's."""
    names = list(dict.fromkeys(span_names))  # de-dup, keep order
    out: dict[str, dict] = {}

    def bucket(key):
        return out.setdefault(key, {"total_ms": 0.0, "count": 0})

    def resolve(op: str) -> str | None:
        if is_python_frame(op) or op in exclude_ops:
            return None
        frames = op_frames(op)
        jits = _JIT_RE.findall(op)
        for name in names:
            if name in jits or name in frames:
                return name
        for name in names:
            if any(name in f for f in frames):
                return name
        if region is not None and region in frames[:-1]:
            return innermost_jit(op)
        return "unattributed"

    # memoize per distinct op name: a big trace has ~10^5 events over
    # far fewer names, and resolve() scans span_names
    target_of: dict[str, str | None] = {}
    for _, _, op, _, dur in xplane.iter_ops(
            xplane.select_planes(planes, device_only)):
        if op in target_of:
            target = target_of[op]
        else:
            target = target_of[op] = resolve(op)
        if target is None:
            continue
        row = bucket(target)
        row["total_ms"] += dur / 1e9
        row["count"] += 1
    for row in out.values():
        row["total_ms"] = round(row["total_ms"], 4)
    return out


class ProfiledRegion:
    """Capture a device trace around a code region and attribute it.

    >>> with ProfiledRegion("epoch", telemetry=tel) as prof:
    ...     run_the_workload()
    >>> prof.top_ops          # plane -> top-N [{op, total_ms, count}]
    >>> prof.by_jit           # innermost-range attribution table
    >>> prof.attribution      # span-name attribution (needs telemetry)

    The trace lands in ``trace_dir`` (a temp dir deleted on exit unless
    ``keep_trace``/an explicit dir is given). With a telemetry bundle
    attached, span/handler names emitted on the bus *during* the region
    become attribution targets and one ``profile`` event with the summary
    is emitted on exit: ``name``, ``by_jit`` (here by innermost host
    range: ``{range: {total_ms, count}}``), ``by_shard_map`` (always
    empty: no mesh, item 3), ``attribution``, and ``error`` and
    ``trace_dir`` where they apply. On exit the region waits for the
    device (``torch.cuda.synchronize``) so that every kernel it launched
    is in the trace. Profiling failures (a second concurrent profiler
    session, an unreadable trace) degrade to empty tables with
    ``self.error`` set — profiling must never kill the run it observes."""

    def __init__(self, name: str = "profiled", telemetry=None,
                 trace_dir=None, top_n: int = 10, keep_trace: bool = False,
                 extra_span_names=()):
        self.name = name
        self.telemetry = telemetry
        self.trace_dir = os.fspath(trace_dir) if trace_dir is not None \
            else None
        self.top_n = top_n
        self.keep_trace = keep_trace or trace_dir is not None
        self.extra_span_names = list(extra_span_names)
        self.planes: list[dict] = []
        self.top_ops: dict = {}
        self.by_jit: dict = {}
        self.by_shard_map: dict = {}
        self.attribution: dict = {}
        self.error: str | None = None
        self._bus_mark = 0
        self._profiler = None
        self._range = None
        self._prev_region = None

    def __enter__(self) -> "ProfiledRegion":
        # name this region in the build-provenance span context
        # (profiling/ledger.py): kernel builds inside the region are
        # charged to it when no tighter function scope or phase is active
        self._prev_region = ledger.push_region(self.name)
        if self.trace_dir is None:
            self.trace_dir = tempfile.mkdtemp(prefix=".profiled_region_")
        os.makedirs(self.trace_dir, exist_ok=True)
        if self.telemetry is not None:
            self._bus_mark = len(self.telemetry.bus.events)
        import torch
        if torch._C._autograd._profiler_enabled():
            # torch starts a second session without a word, and stopping
            # the two later can crash the process: refuse it here
            self.error = "trace start failed: a profiler session is already active"
            return self
        try:
            from torch.profiler import ProfilerActivity, profile, record_function
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            self._profiler = prof
            self._range = record_function(self.name)
            self._range.__enter__()
        except Exception as e:
            self.error = f"trace start failed: {e!r:.200}"
        return self

    def _region_span_names(self) -> list[str]:
        """The attribution targets: the extra names, then the bus's
        handler and span names, in order; not the region's own name
        (``attribute_to_spans(region=...)`` places it last)."""
        names = list(self.extra_span_names)
        if self.telemetry is not None:
            for ev in self.telemetry.bus.events[self._bus_mark:]:
                h = ev.get("handler")
                if h:
                    names.append(h)
                s = ev.get("span")
                if s:
                    names.append(s)
        return names

    def _stop(self, exc) -> None:
        import torch
        if self._range is not None:
            self._range.__exit__(*exc)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._profiler.__exit__(*exc)
        self._profiler.export_chrome_trace(
            os.path.join(self.trace_dir, f"{self.name}.pt.trace.json"))

    def __exit__(self, *exc) -> None:
        ledger.pop_region(self._prev_region)
        if self._profiler is not None:
            try:
                self._stop(exc)
            except Exception as e:
                self.error = self.error or f"trace stop failed: {e!r:.200}"
            else:
                try:
                    self.planes = kineto.parse_path(self.trace_dir)
                    self.top_ops = xplane.top_table(
                        xplane.summarize_planes(self.planes), self.top_n)
                    # the region's own slice envelops every op it launched:
                    # exclude it or CPU-fallback tables double-count the whole
                    # region (the top_ops view keeps it: there it reads as a
                    # total, not work)
                    self.by_jit = group_by_jit(self.planes,
                                               exclude_ops={self.name})
                    self.attribution = attribute_to_spans(
                        self.planes, self._region_span_names(),
                        exclude_ops={self.name}, region=self.name)
                except Exception as e:
                    # a truncated trace (killed writer, full disk), a missing
                    # file, anything: profiling must never kill the run it
                    # observes
                    self.planes = []
                    self.error = f"trace parse failed: {e!r:.200}"
        if self.telemetry is not None:
            payload = {
                "name": self.name,
                "by_jit": {k: {"total_ms": v["total_ms"],
                               "count": v["count"]}
                           for k, v in self.by_jit.items()},
                "by_shard_map": {},
                "attribution": self.attribution,
            }
            if self.error is not None:
                payload["error"] = self.error
            if self.keep_trace:
                payload["trace_dir"] = self.trace_dir
            try:
                self.telemetry.bus.emit("profile", **payload)
            except Exception:
                pass  # a closed bus must not raise out of the region
        if not self.keep_trace and self.trace_dir is not None:
            shutil.rmtree(self.trace_dir, ignore_errors=True)
