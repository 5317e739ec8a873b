"""Cross-process metrics pipeline (ISSUE 18 leg a).

Each ``WorkerPool`` worker process owns a private ``MetricsRegistry``;
nothing in the plane shares memory for metrics (the shared-memory board
carries health rows, not series). The pipeline that makes the fleet
observable as ONE registry:

- the worker's beat thread calls ``write_snapshot`` every beat — an
  atomic tmp+rename JSON dump of ``MetricsRegistry.snapshot()`` beside
  its heartbeat file, named ``worker<id>.pid<pid>.metrics.json``. The
  pid in the name is load-bearing: a respawned incarnation writes a NEW
  file instead of overwriting its predecessor's, so a SIGKILLed
  worker's last-flushed counts survive into the fleet view (only the
  final beat-interval of updates is lost);
- ``FleetAggregator`` scans a directory for those snapshots and merges
  them into one registry, tagging every series with a ``worker=<id>``
  label (incarnations of the same worker id fold into one labelled
  series — counters add, which is exactly right across a respawn);
- the merged registry is served live by the admission-exempt
  ``metrics`` RPC on every ``ServeFront`` (Prometheus text + JSON),
  consumed by the balancer's health bias, asserted by
  ``run_mp_scenario``'s verdict (per-worker request counts must sum to
  the loadgen's sent count ± resends), and rendered by
  ``scripts/run_report.py``.

Snapshot files are self-describing: the registry snapshot rides under
``"registry"`` next to a small meta header (worker id, pid, front,
generation, wall). Readers tolerate a torn/absent file — a snapshot
mid-rename or a worker that died before its first beat must never fail
the scrape.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

from pos_evolution_tpu_torch.telemetry.registry import (
    SNAPSHOT_VERSION,
    MetricsRegistry,
)

__all__ = ["FleetAggregator", "write_snapshot", "load_snapshot",
           "snapshot_path", "discover_snapshots"]

_SNAP_RE = re.compile(r"^worker(\d+)\.pid(\d+)\.metrics\.json$")


def snapshot_path(directory: str | os.PathLike, worker: int,
                  pid: int) -> str:
    return os.path.join(os.fspath(directory),
                        f"worker{worker}.pid{pid}.metrics.json")


def write_snapshot(path: str | os.PathLike, registry: MetricsRegistry,
                   worker: int, pid: int, front: int | None = None,
                   generation: int | None = None) -> None:
    """Atomic tmp+rename dump — a reader never sees a half-written
    snapshot, same discipline as the worker stats/heartbeat files."""
    path = os.fspath(path)
    blob = {
        "v": SNAPSHOT_VERSION,
        "worker": int(worker),
        "pid": int(pid),
        "front": front,
        "generation": generation,
        "wall": time.time(),
        "registry": registry.snapshot(),
    }
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".metrics_")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(blob, fh)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_snapshot(path: str | os.PathLike) -> dict | None:
    """One snapshot blob, or None when the file is absent/torn — a
    worker killed mid-rename must never fail the whole scrape."""
    try:
        with open(path) as fh:
            blob = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(blob, dict) \
            or blob.get("v") != SNAPSHOT_VERSION \
            or not isinstance(blob.get("registry"), dict):
        return None
    return blob


def discover_snapshots(directory: str | os.PathLike) -> list[str]:
    """Every ``worker<id>.pid<pid>.metrics.json`` under ``directory``,
    sorted by (worker, pid) for deterministic merge order."""
    directory = os.fspath(directory)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for name in names:
        m = _SNAP_RE.match(name)
        if m:
            found.append((int(m.group(1)), int(m.group(2)), name))
    return [os.path.join(directory, name)
            for _, _, name in sorted(found)]


class FleetAggregator:
    """Merge per-worker registry snapshots into one fleet registry.

    >>> agg = FleetAggregator.from_dir(run_dir)
    >>> agg.registry.to_prometheus()     # every series worker-labelled
    >>> agg.worker_totals("serve_requests_total")
    {'0': 812, '1': 790, ...}
    """

    def __init__(self):
        self.registry = MetricsRegistry()
        self.workers: dict[str, dict] = {}  # worker id -> freshest meta
        self.snapshots_merged = 0
        self.snapshots_skipped = 0

    @classmethod
    def from_dir(cls, directory: str | os.PathLike,
                 extra: tuple = ()) -> "FleetAggregator":
        """Aggregate every snapshot in ``directory``; ``extra`` holds
        already-loaded blobs to fold in on top (the serving front passes
        its own in-memory registry this way so the live process is never
        a beat-interval stale in its own scrape)."""
        agg = cls()
        for path in discover_snapshots(directory):
            agg.add(load_snapshot(path))
        for blob in extra:
            agg.add(blob)
        return agg

    def add(self, blob: dict | None) -> bool:
        """Fold one snapshot blob in; False when the blob was unusable
        (torn file, schema drift) — counted, never raised."""
        if blob is None:
            self.snapshots_skipped += 1
            return False
        worker = str(blob.get("worker", "?"))
        try:
            self.registry.merge_snapshot(blob["registry"],
                                         extra_labels={"worker": worker})
        except (ValueError, KeyError, TypeError):
            self.snapshots_skipped += 1
            return False
        meta = self.workers.get(worker)
        if meta is None or (blob.get("wall") or 0) >= (meta.get("wall")
                                                       or 0):
            new = {
                "pid": blob.get("pid"), "front": blob.get("front"),
                "generation": blob.get("generation"),
                "wall": blob.get("wall"),
            }
            if meta is not None:
                # a live-registry blob carries no front/generation —
                # don't let it blank out what the beat snapshot knew
                for k in ("front", "generation"):
                    if new[k] is None:
                        new[k] = meta.get(k)
            self.workers[worker] = new
        self.snapshots_merged += 1
        return True

    # -- fleet views -----------------------------------------------------------

    def worker_totals(self, metric: str) -> dict[str, float]:
        """Per-worker total of one counter (all non-worker labels
        summed out): the shape the harness verdict and the balancer
        health bias consume."""
        m = self.registry._metrics.get(metric)
        out: dict[str, float] = {}
        if m is None or m.kind != "counter":
            return out
        for key, val in m.series.items():
            labels = dict(key)
            w = labels.get("worker")
            if w is not None:
                out[w] = out.get(w, 0) + val
        return out

    def fleet_total(self, metric: str) -> float:
        return sum(self.worker_totals(metric).values())

    def worker_status_totals(self, metric: str
                             ) -> dict[str, dict[str, float]]:
        """Per-worker counts split by ``status`` label — the balancer's
        health-bias input (error fraction per worker)."""
        m = self.registry._metrics.get(metric)
        out: dict[str, dict[str, float]] = {}
        if m is None or m.kind != "counter":
            return out
        for key, val in m.series.items():
            labels = dict(key)
            w = labels.get("worker")
            if w is None:
                continue
            by = out.setdefault(w, {})
            st = labels.get("status", "?")
            by[st] = by.get(st, 0) + val
        return out

    def summary(self) -> dict:
        """The JSON shape the ``metrics`` RPC returns next to the
        Prometheus text: merge provenance + per-worker request totals."""
        return {
            "v": SNAPSHOT_VERSION,
            "workers": {w: dict(meta)
                        for w, meta in sorted(self.workers.items())},
            "snapshots_merged": self.snapshots_merged,
            "snapshots_skipped": self.snapshots_skipped,
            "requests_by_worker":
                self.worker_totals("serve_requests_total"),
        }
