"""End-to-end request tracing (ISSUE 18 leg b).

One logical request — hedged, resent, breaker-probed — becomes one
visible timeline across process boundaries:

- **sampling is a seeded stateless decision** (PEV002 decision-scope
  contract): ``sample(seed, index, rate)`` hashes the request identity
  with blake2b, exactly the ``sim/faults.stateless_unit`` discipline.
  No wall clock, no RNG cursor — the same (seed, index) always samples
  the same way, so a replayed load schedule traces the same requests;
- **trace ids are deterministic**: ``trace_id(seed, index)`` is a hash
  of the identity, not a uuid, so client- and server-side spans of the
  same request agree on the id without coordination;
- the id + sample decision ride the frame protocol's optional ``trace``
  field (``{"id": "...", "s": 1}``) — absent for unsampled traffic,
  which keeps the byte-template and byte-scan fast paths byte-identical
  to the untraced plane;
- each process buffers its spans in a ``SpanBuffer`` and flushes them
  (append-only JSONL, one file per pid: ``spans.<pid>.jsonl``) on its
  own cadence; ``scripts/trace_merge.py`` merges the per-process set
  into one Chrome trace with one pid lane per process.

Span record (one JSON object per line):

    {"trace": <id>, "name": "service", "ph": "span",
     "t0": <unix seconds>, "dur_ms": <float>, "pid": <os pid>,
     "proc": "<label>", "tid": <int>, ...free-form args...}

``t0`` is wall-clock epoch seconds on purpose — it is the only clock
processes on one host share, and the merge tool re-bases everything to
the earliest span so Chrome renders microsecond offsets. Span emission
must never fail the request it observes: every buffer operation
swallows into a dropped-span counter rather than raising.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time

__all__ = ["sample", "trace_id", "SpanBuffer", "span_filename",
           "install_buffer", "get_buffer", "record_span"]

_TRACE_TAG = 0x7452_6163  # "tRac": domain-separates trace draws from
# fault/adversary draws sharing a run seed


def _unit(seed: int, *key: int) -> float:
    """blake2b -> uniform [0,1): the ``sim/faults.stateless_unit``
    discipline, inlined so telemetry never imports the sim tier."""
    h = hashlib.blake2b(
        struct.pack(f"<{len(key) + 1}q", seed, *key),
        digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0**64


def sample(seed: int, index: int, rate: float) -> bool:
    """Seeded per-request sample decision. ``rate`` is the sampled
    fraction (0 disables tracing entirely, 1 traces everything)."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return _unit(seed, _TRACE_TAG, index) < rate


def trace_id(seed: int, index: int) -> str:
    """Deterministic 16-hex-digit trace id for request ``index``."""
    h = hashlib.blake2b(
        struct.pack("<3q", seed, _TRACE_TAG ^ 0x1D, index),
        digest_size=8).hexdigest()
    return h


def span_filename(pid: int | None = None) -> str:
    return f"spans.{os.getpid() if pid is None else pid}.jsonl"


class SpanBuffer:
    """Per-process span sink: bounded in-memory list + incremental
    append-only JSONL flush.

    ``flush()`` appends every span recorded since the previous flush to
    ``<directory>/spans.<pid>.jsonl`` — append-only because the worker's
    beat thread calls it on a cadence and a crash between flushes must
    keep everything already written (the same commit-on-arrival posture
    as the event bus). A full buffer drops new spans and counts them:
    tracing is an observer, backpressure on the observed path would be
    a measurement artifact worse than a gap."""

    def __init__(self, directory: str | os.PathLike | None = None,
                 proc: str = "", max_spans: int = 100_000):
        self.directory = (os.fspath(directory)
                          if directory is not None else None)
        self.proc = proc or f"pid{os.getpid()}"
        self.max_spans = int(max_spans)
        self.spans: list[dict] = []
        self.dropped = 0
        self._flushed = 0
        self._lock = threading.Lock()

    def add(self, trace: str, name: str, t0: float, dur_ms: float,
            tid: int = 0, **args) -> None:
        span = {"trace": trace, "name": name,
                "t0": round(float(t0), 6),
                "dur_ms": round(float(dur_ms), 4),
                "pid": os.getpid(), "proc": self.proc, "tid": int(tid)}
        for k, v in args.items():
            if v is not None:
                span[k] = v
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return
            self.spans.append(span)

    def mark(self, trace: str, name: str, tid: int = 0, **args) -> None:
        """Zero-duration instant (breaker probe, resend decision)."""
        self.add(trace, name, time.time(), 0.0, tid=tid, **args)

    def flush(self) -> int:
        """Append unflushed spans to this process's span file; returns
        the number written. No directory -> in-memory only (tests)."""
        with self._lock:
            pending = self.spans[self._flushed:]
            self._flushed = len(self.spans)
        if not pending or self.directory is None:
            return 0
        path = os.path.join(self.directory, span_filename())
        try:
            with open(path, "a") as fh:
                for span in pending:
                    fh.write(json.dumps(span, sort_keys=True) + "\n")
        except OSError:
            # the trace file is an observer artifact — a full disk must
            # not take the serving plane down with it
            return 0
        return len(pending)

    def summary(self) -> dict:
        with self._lock:
            return {"spans": len(self.spans), "dropped": self.dropped,
                    "flushed": self._flushed}


# -- per-process singleton -------------------------------------------------
#
# The serving tier's span emitters (client pool, front worker loops, the
# das backing path) have no natural constructor handle to thread a
# buffer through, exactly like the global telemetry sink: install once
# per process, no-op when absent.

_BUFFER: list[SpanBuffer | None] = [None]


def install_buffer(directory: str | os.PathLike | None,
                   proc: str = "") -> SpanBuffer:
    buf = SpanBuffer(directory, proc=proc)
    _BUFFER[0] = buf
    return buf


def get_buffer() -> SpanBuffer | None:
    return _BUFFER[0]


def record_span(trace: str | None, name: str, t0: float, dur_ms: float,
                tid: int = 0, **args) -> None:
    """Module-level convenience: record onto the installed buffer if
    tracing is on AND this request carried a sampled trace id."""
    if trace is None:
        return
    buf = _BUFFER[0]
    if buf is not None:
        buf.add(trace, name, t0, dur_ms, tid=tid, **args)
