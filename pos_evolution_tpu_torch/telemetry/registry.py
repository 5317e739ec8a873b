"""``MetricsRegistry``: named counters / gauges / histograms with label
support and Prometheus-text + JSON export (SURVEY.md §5 "structured
metrics"; the prose reference has none).

Design constraints, in order:

- **host-side and allocation-light** — metrics are updated from the sim
  driver's per-message hot loop and from ``ops/resident.py`` device-call
  sites, so one update must be a dict lookup + integer add, never I/O
  (export is pull-based: ``to_prometheus()`` / ``to_json()`` walk the
  registry when asked);
- **labels as sorted key-tuples** — the Prometheus data model
  (``name{k="v"}``) without a client-library dependency (nothing may be
  pip-installed in this image);
- **counts are the contract** — ``scripts/perf_gate.py`` gates on count
  metrics (recompiles, handler calls, dispatches) because counts are
  deterministic on CPU CI where timings are not. ``counts()`` flattens
  every counter into one {name[;labels]: int} dict for exactly that
  consumer.
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left

# Cross-process snapshot format (``snapshot()`` / ``merge_snapshot()``):
# bumped only when the shape changes incompatibly — readers refuse
# unknown versions instead of misfolding a future format.
SNAPSHOT_VERSION = 1


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_text(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.series: dict[tuple, object] = {}
        # updates are read-modify-writes: the serving tier
        # (serve/server.py) increments one registry from N worker and
        # reader threads, where an unlocked `get + set` silently drops
        # counts — and the perf gate gates on those counts. One
        # uncontended lock acquisition is ~100 ns; the driver hot loop
        # doesn't notice.
        self._lock = threading.Lock()

    def _prom_header(self) -> list[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        return out

    def to_prometheus(self) -> list[str]:
        """One scalar sample per labelled series (Histogram overrides)."""
        out = self._prom_header()
        for key in sorted(self.series):
            out.append(f"{self.name}{_label_text(key)} {self.series[key]}")
        return out


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def inc(self, amount: int | float = 1, **labels) -> None:
        assert amount >= 0, "counters only go up"
        key = _label_key(labels)
        with self._lock:
            self.series[key] = self.series.get(key, 0) + amount

    def value(self, **labels):
        return self.series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-write-wins scalar (queue depths, capacities, lag)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        # last-write-wins is the gauge semantic, but the first touch of a
        # key races dict insertion against concurrent inc() resizes —
        # same discipline as every other series update
        with self._lock:
            self.series[_label_key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self.series[key] = self.series.get(key, 0) + amount

    def value(self, **labels):
        return self.series.get(_label_key(labels), 0)


# Default bounds sized for handler latencies in seconds: 0.1 ms .. ~13 s.
_DEFAULT_BUCKETS = tuple(0.0001 * 2 ** i for i in range(18))


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = _DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        self.observe_n(value, 1, **labels)

    def observe_n(self, value: float, n: int, **labels) -> None:
        """``n`` observations of ``value`` in one bucket update — hot
        paths that tally identical sub-bucket samples batch them here
        instead of paying the label-key encode + lock per sample."""
        key = _label_key(labels)
        with self._lock:
            row = self.series.get(key)
            if row is None:
                row = {"bucket_counts": [0] * len(self.buckets),
                       "sum": 0.0, "count": 0}
                self.series[key] = row
            i = bisect_left(self.buckets, value)
            if i < len(self.buckets):
                row["bucket_counts"][i] += n
            row["sum"] += value * n
            row["count"] += n

    def value(self, **labels) -> dict | None:
        return self.series.get(_label_key(labels))

    def to_prometheus(self) -> list[str]:
        out = self._prom_header()
        for key in sorted(self.series):
            row = self.series[key]
            cum = 0
            for le, c in zip(self.buckets, row["bucket_counts"]):
                cum += c
                bkey = key + (("le", repr(float(le))),)
                out.append(f"{self.name}_bucket{_label_text(bkey)} {cum}")
            bkey = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_label_text(bkey)} {row['count']}")
            out.append(f"{self.name}_sum{_label_text(key)} {row['sum']}")
            out.append(f"{self.name}_count{_label_text(key)} {row['count']}")
        return out


class MetricsRegistry:
    """One namespace of metrics; get-or-create accessors so call sites
    never need registration order."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw):
        # get-or-create under the lock: two threads first touching the
        # same metric name concurrently must share ONE object, or the
        # loser's updates land on an orphan and vanish
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
        assert isinstance(m, cls), \
            f"metric {name!r} already registered as {m.kind}"
        return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    # -- export ----------------------------------------------------------------

    def to_prometheus(self) -> str:
        lines = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].to_prometheus())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            for key, val in sorted(m.series.items()):
                entry = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry.update(val)
                    entry["buckets"] = list(m.buckets)
                else:
                    entry["value"] = val
                series.append(entry)
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True)

    # -- cross-process snapshot / merge (ISSUE 18 fleet pipeline) --------------

    def snapshot(self) -> dict:
        """Schema-versioned, JSON-serializable copy of every series —
        the unit a worker process flushes beside its heartbeat file and
        a ``FleetAggregator`` merges back. Unlike ``to_json`` this holds
        each metric's lock while copying, so a concurrent ``observe_n``
        can never leave a torn histogram row (bucket counts from one
        batch, ``count`` from another) in the snapshot."""
        metrics: dict[str, dict] = {}
        for name, m in sorted(self._metrics.items()):
            with m._lock:
                if m.kind == "histogram":
                    series = [{"labels": dict(key),
                               "bucket_counts": list(row["bucket_counts"]),
                               "sum": row["sum"], "count": row["count"]}
                              for key, row in sorted(m.series.items())]
                else:
                    series = [{"labels": dict(key), "value": val}
                              for key, val in sorted(m.series.items())]
            entry = {"kind": m.kind, "help": m.help, "series": series}
            if m.kind == "histogram":
                entry["buckets"] = list(m.buckets)
            metrics[name] = entry
        return {"v": SNAPSHOT_VERSION, "metrics": metrics}

    def merge_snapshot(self, snap: dict, extra_labels: dict | None = None
                       ) -> None:
        """Fold one ``snapshot()`` emission into this registry,
        optionally tagging every series with ``extra_labels`` (the fleet
        aggregator passes ``{"worker": "<id>"}`` so per-worker series
        stay distinguishable after the merge). Counters and histogram
        rows ADD — merging two snapshots of the same worker double
        counts, by design the caller's problem; gauges are last-write-
        wins, matching their single-registry semantics."""
        if snap.get("v") != SNAPSHOT_VERSION:
            raise ValueError(
                f"unknown metrics snapshot version {snap.get('v')!r} "
                f"(this reader understands v{SNAPSHOT_VERSION})")
        extra = extra_labels or {}
        for name, entry in sorted((snap.get("metrics") or {}).items()):
            kind = entry.get("kind")
            if kind == "counter":
                c = self.counter(name, entry.get("help", ""))
                for row in entry.get("series", ()):
                    c.inc(row.get("value", 0),
                          **{**row.get("labels", {}), **extra})
            elif kind == "gauge":
                g = self.gauge(name, entry.get("help", ""))
                for row in entry.get("series", ()):
                    g.set(row.get("value", 0),
                          **{**row.get("labels", {}), **extra})
            elif kind == "histogram":
                bounds = tuple(entry.get("buckets", _DEFAULT_BUCKETS))
                h = self.histogram(name, entry.get("help", ""),
                                   buckets=bounds)
                for row in entry.get("series", ()):
                    labels = {**row.get("labels", {}), **extra}
                    if h.buckets == tuple(sorted(bounds)):
                        key = _label_key(labels)
                        with h._lock:
                            dst = h.series.get(key)
                            if dst is None:
                                dst = {"bucket_counts":
                                       [0] * len(h.buckets),
                                       "sum": 0.0, "count": 0}
                                h.series[key] = dst
                            src = row.get("bucket_counts", ())
                            for i, n in enumerate(src[:len(h.buckets)]):
                                dst["bucket_counts"][i] += n
                            dst["sum"] += row.get("sum", 0.0)
                            dst["count"] += row.get("count", 0)
                    else:
                        # bucket bounds drifted between emitter and
                        # merger (mixed code versions): degrade to
                        # re-observing each bucket at its upper bound —
                        # totals stay exact, bucket placement approximate
                        srcb = sorted(bounds)
                        counts = list(row.get("bucket_counts", ()))
                        for le, n in zip(srcb, counts):
                            if n:
                                h.observe_n(le, n, **labels)
                        over = row.get("count", 0) - sum(counts)
                        if over > 0 and srcb:  # +Inf-bucket residue
                            h.observe_n(srcb[-1] * 2, over, **labels)

    def counts(self) -> dict[str, int | float]:
        """Flatten all counters (and histogram counts) into one
        {name[;k=v;...]: value} dict — the count-based emission
        ``scripts/perf_gate.py`` gates on."""
        out: dict[str, int | float] = {}
        for name, m in sorted(self._metrics.items()):
            for key, val in sorted(m.series.items()):
                suffix = "".join(f";{k}={v}" for k, v in key)
                if m.kind == "counter":
                    out[name + suffix] = val
                elif m.kind == "histogram":
                    out[name + suffix + ";stat=count"] = val["count"]
        return out
