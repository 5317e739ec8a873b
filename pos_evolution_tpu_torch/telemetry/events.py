"""Structured event bus: schema-versioned JSONL with span lineage.

Every event is one JSON object per line, self-describing enough that
``scripts/run_report.py`` can reconstruct a run — finality timeline,
per-handler percentiles, fault attribution — **without access to the live
``Simulation``** (the acceptance contract of ISSUE 3).

Envelope (schema v1):

    {"v": 1, "seq": <int>, "type": "<event type>", ...payload...}

- ``seq`` is a per-bus monotonic ordinal: JSONL has no transactional
  ordering guarantee across writers, so consumers sort by ``seq``;
- span events additionally carry ``span`` (this event's id) and
  ``parent`` (the id of the causally preceding span, or null at the
  root). Span ids are **deterministic message identities**
  (``blk-<slot>-<proposer>``, ``att-<slot>-g<group>-c<committee>``, and
  per-edge ``…/g<dst>`` suffixes), not random uuids — the same run
  always produces the same lineage, which is what lets tests pin
  parent/child integrity across checkpoint/resume;
- ``t`` is SIMULATION time where the emitter has one (delivery events).
  The bus itself never stamps absolute wall-clock onto the envelope;
  emitters may still include measured fields (``duration_ms`` on
  deliveries, ``unix``/``elapsed_s`` on watchdog incidents), so golden
  JSONL fixtures are hand-authored, not regenerated from live runs.

The bus is deliberately not simulation state: ``Simulation.checkpoint``
excludes it (like wall-clock handler timings), and a resumed run records
only post-resume events.
"""

from __future__ import annotations

import io
import json
import os

SCHEMA_VERSION = 1


class EventBus:
    """Append-only event sink: in-memory list + optional JSONL file.

    ``path=None`` keeps events in memory only (tests, ad-hoc runs); with a
    path every ``emit`` writes one line immediately (line-buffered), so a
    crashed run still leaves a parseable prefix — the commit-on-arrival
    posture of ``utils/watchdog.py`` applied to events.
    """

    def __init__(self, path: str | os.PathLike | None = None,
                 keep_in_memory: bool = True, append: bool = False):
        self.path = os.fspath(path) if path is not None else None
        self.keep_in_memory = keep_in_memory
        self.events: list[dict] = []
        self._seq = 0
        self._fh: io.TextIOBase | None = None
        if self.path is not None:
            # append mode (ISSUE 10): a resumed attempt extends the
            # previous attempt's log instead of truncating it, and
            # continues the seq ordinal past the existing maximum so the
            # sort-by-seq contract keeps the attempts in order (a torn
            # final line from the killed writer is tolerated, exactly as
            # read_jsonl would)
            if append and os.path.exists(self.path):
                try:
                    prior = read_versioned_jsonl(self.path, SCHEMA_VERSION)
                    self._seq = 1 + max(
                        (e.get("seq", -1) for e in prior), default=-1)
                except ValueError:
                    pass  # mid-log corruption: emit from 0, report sorts
                # a killed writer can leave the final line without its
                # newline. Appending straight onto it would corrupt BOTH
                # events, and newline-terminating it would be worse: the
                # fragment would become a NON-final unparseable line,
                # which read_jsonl treats as fatal mid-log corruption.
                # Readers already drop a torn tail, so TRUNCATE it.
                with open(self.path, "rb+") as prev:
                    prev.seek(0, os.SEEK_END)
                    size = prev.tell()
                    if size > 0:
                        prev.seek(-1, os.SEEK_END)
                        if prev.read(1) != b"\n":
                            prev.seek(0)
                            data = prev.read(size)
                            keep = data.rfind(b"\n") + 1
                            prev.truncate(keep)
            self._fh = open(self.path, "a" if append else "w", buffering=1)

    # -- emission --------------------------------------------------------------

    def emit(self, type_: str, *, span: str | None = None,
             parent: str | None = None, **fields) -> dict:
        """Record one event; returns the envelope (callers chain span ids
        off it). Payload values must be JSON-serializable."""
        ev = {"v": SCHEMA_VERSION, "seq": self._seq, "type": type_}
        self._seq += 1
        if span is not None:
            ev["span"] = span
        if parent is not None:
            ev["parent"] = parent
        ev.update(fields)
        if self.keep_in_memory:
            self.events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
        return ev

    # -- queries (test/report convenience on the in-memory view) ---------------

    def of_type(self, type_: str) -> list[dict]:
        return [e for e in self.events if e["type"] == type_]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_versioned_jsonl(path: str | os.PathLike, expected_version: int,
                         label: str = "event") -> list[dict]:
    """The one torn-tail-tolerant, schema-versioned JSONL reader — shared
    by the telemetry event log and the bench history
    (``profiling/history.py``), so the subtle semantics cannot drift
    between them.

    Tolerates a torn FINAL line (a run killed mid-write) — everything
    before it is still usable, which is the point of line-at-a-time
    commit. A decode error anywhere EARLIER is corruption, not a torn
    tail, and raises with the line number: silently dropping the suffix
    would present a truncated log as a complete one. Also raises on an
    unknown ``"v"``: consumers must not misread future formats.
    """
    with open(path) as fh:
        lines = [(i + 1, line.strip()) for i, line in enumerate(fh)]
    lines = [(ln, text) for ln, text in lines if text]
    out = []
    for pos, (ln, text) in enumerate(lines):
        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            if pos == len(lines) - 1:
                break  # torn tail from a killed writer
            raise ValueError(
                f"{os.fspath(path)}:{ln}: corrupt {label} line mid-log "
                f"(only the final line may be torn)")
        v = obj.get("v")
        if v != expected_version:
            raise ValueError(
                f"unknown {label} schema version {v!r} "
                f"(this reader understands v{expected_version})")
        out.append(obj)
    return out


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    """Load a JSONL event log back into memory, sorted by ``seq``
    (see ``read_versioned_jsonl`` for the torn-tail/corruption/schema
    contract)."""
    events = read_versioned_jsonl(path, SCHEMA_VERSION, label="event")
    events.sort(key=lambda e: e.get("seq", 0))
    return events


# -- multi-process event logs (ISSUE 18) ---------------------------------------
#
# Two processes appending to ONE EventBus file interleave partial lines
# whenever a write straddles a pipe buffer — the old plane only survived
# because workers reopened the file per emission and wrote short lines.
# The supported shape is one file per process: ``per_process_path``
# derives ``events.<pid>.jsonl`` from the logical log path, each process
# owns its file exclusively, and ``merge_event_files`` re-sequences the
# union for the offline consumers.

def per_process_path(path: str | os.PathLike,
                     pid: int | None = None) -> str:
    """``/run/events.jsonl`` -> ``/run/events.<pid>.jsonl``. Appending
    the pid BEFORE the final suffix keeps the ``.jsonl`` extension so
    every existing glob/tooling convention still matches."""
    path = os.fspath(path)
    pid = os.getpid() if pid is None else int(pid)
    root, ext = os.path.splitext(path)
    return f"{root}.{pid}{ext or '.jsonl'}"


def discover_per_process(path: str | os.PathLike) -> list[str]:
    """Sibling ``events.<pid>.jsonl`` files of a logical log path,
    sorted by pid — what ``scripts/run_report.py`` auto-merges."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    root, ext = os.path.splitext(base)
    found = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not (name.startswith(root + ".") and name.endswith(ext)):
            continue
        middle = name[len(root) + 1:len(name) - len(ext)]
        if middle.isdigit():
            found.append((int(middle), os.path.join(directory, name)))
    return [p for _, p in sorted(found)]


def merge_event_files(paths, out_path: str | os.PathLike | None = None
                      ) -> list[dict]:
    """Merge per-process event logs into one stream, re-sequenced by
    ``(wall, seq, source order)`` — wall when the emitter stamped one
    (cross-process ordering needs a shared clock; per-bus ``seq`` only
    orders within one process), falling back to ``seq`` so single-file
    merges keep their original order. The merged events get fresh
    contiguous ``seq`` ordinals; the original ordinal survives as
    ``src_seq`` and the source pid (parsed from the filename) as
    ``src_pid``, so lineage back to the per-process file is never lost.

    ``out_path`` additionally writes the merged stream as JSONL (the
    shape every existing consumer reads)."""
    rows = []
    for order, path in enumerate(paths):
        pid = None
        root = os.path.splitext(os.path.basename(os.fspath(path)))[0]
        tail = root.rsplit(".", 1)[-1]
        if tail.isdigit():
            pid = int(tail)
        # events between wall-stamped ones inherit the last stamp seen
        # (carry-forward): per-file seq order is preserved exactly, and
        # cross-file interleave happens at wall-clock granularity
        last_wall = 0.0
        for ev in read_versioned_jsonl(path, SCHEMA_VERSION,
                                       label="event"):
            wall = ev.get("wall")
            if wall is not None:
                last_wall = max(last_wall, float(wall))
            rows.append(((last_wall, order, ev.get("seq", 0)), pid, ev))
    rows.sort(key=lambda r: r[0])
    merged = []
    for seq, (_, pid, ev) in enumerate(rows):
        ev = dict(ev)
        ev["src_seq"] = ev.get("seq", 0)
        if pid is not None:
            ev["src_pid"] = pid
        ev["seq"] = seq
        merged.append(ev)
    if out_path is not None:
        with open(os.fspath(out_path), "w") as fh:
            for ev in merged:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
    return merged
