"""Device flight recorder: memory watermarks, the shard-skew probe and the
build-provenance ledger in one armable bundle (port of
``pos_evolution_tpu/telemetry/device.py``).

- **memory watermarks**: :class:`DeviceMemorySampler` reads, for every
  CUDA device this process has initialized, ``torch.cuda.memory_stats``
  (allocated bytes now and at peak, reserved bytes now and at peak)
  and ``torch.cuda.mem_get_info`` (free and total), and turns them into
  ``device_memory_bytes{device,stat}`` gauges, ``device_memory`` events
  and an in-memory headroom curve. A process that never touched CUDA
  (a CPU run) takes the JAX module's pure-host path: the resident-set
  bytes of ``/proc/self/statm``, labelled ``platform=host_rss`` because
  they measure the process, not a device;
- **shard-skew probe**: :func:`shard_completion_times` waits for one
  output tensor and records when its device finished. The port runs on
  one device (the mesh is ROADMAP Queue 1 item 3), so a probe has one
  row;
- **flight recorder**: :class:`FlightRecorder` bundles the sampler, a
  ``profiling/ledger.CompileLedger`` (kernel builds by span) and the
  skew accumulator behind one ``install()`` and cadence policy, so the
  dense driver arms them with one argument. Probes run every
  ``sample_every``-th slot.

Everything degrades silently: telemetry must never be the reason a run
dies. Torch is imported only inside the calls that read a device.
"""

from __future__ import annotations

import json
import os
import time

__all__ = [
    "DeviceMemorySampler",
    "FlightRecorder",
    "host_rss_bytes",
    "shard_completion_times",
]

#: retained headroom-curve points before decimation
CURVE_CAP = 4096

# torch.cuda.memory_stats key -> row key
_CUDA_STATS = (("allocated_bytes.all.current", "bytes_in_use"),
               ("allocated_bytes.all.peak", "peak_bytes_in_use"),
               ("reserved_bytes.all.current", "reserved_bytes"),
               ("reserved_bytes.all.peak", "peak_reserved_bytes"))


def host_rss_bytes() -> int | None:
    """Resident-set bytes of this process from ``/proc/self/statm``
    (field 2 = resident pages). None off-Linux."""
    try:
        with open("/proc/self/statm") as fh:
            rss_pages = int(fh.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return None  # the estimator is best-effort


def _cuda_rows() -> list[dict]:
    """One row per CUDA device of an initialized CUDA runtime; none
    when CUDA was never touched (sampling must not create a context)."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        rows = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            row = {"device": f"cuda:{i}", "platform": "cuda"}
            for src, dst in _CUDA_STATS:
                row[dst] = int(stats.get(src, 0))
            free, total = torch.cuda.mem_get_info(i)
            row["free_bytes"] = int(free)
            row["limit_bytes"] = int(total)
            rows.append(row)
        return rows
    except Exception:
        return []  # sampling must never kill a run


class DeviceMemorySampler:
    """Per-device memory watermarks with a host-RSS fallback.

    ``sample()`` never raises; each call appends one point (per device)
    to the in-memory curve, updates peak watermarks, sets
    ``device_memory_bytes`` gauges, and emits one ``device_memory``
    event when a bus is attached. ``peak`` is the highest allocated
    bytes seen at a sample; on the card the allocator's own peak
    (``peak_bytes_in_use``, between samples too) is in the rows.
    """

    def __init__(self, registry=None, bus=None, curve_cap: int = CURVE_CAP):
        self.registry = registry
        self.bus = bus
        self.curve_cap = max(int(curve_cap), 2)
        self.samples = 0
        self.source: str | None = None
        self.curve: list[dict] = []
        self._curve_stride = 1  # decimation factor after cap overflows
        self.peak: dict[str, int] = {}
        self.allocator_peak: dict[str, int] = {}

    def _rows(self) -> list[dict]:
        rows = _cuda_rows()
        if rows:
            self.source = "memory_stats"
            return rows
        rss = host_rss_bytes()
        if rss is not None:
            self.source = "host_rss"
            return [{"device": "host", "platform": "host_rss",
                     "bytes_in_use": rss}]
        self.source = "unavailable"
        return []

    def sample(self, *, site: str = "slot", slot=None) -> list[dict]:
        rows = self._rows()
        if not rows:
            return rows
        self.samples += 1
        for row in rows:
            dev = row["device"]
            in_use = row["bytes_in_use"]
            if in_use > self.peak.get(dev, -1):
                self.peak[dev] = in_use
            if row.get("peak_bytes_in_use", -1) > self.allocator_peak.get(dev, -1):
                self.allocator_peak[dev] = row["peak_bytes_in_use"]
        reg = self.registry
        if reg is not None:
            try:
                g = reg.gauge("device_memory_bytes",
                              "per-device memory watermark samples")
                for row in rows:
                    dev = row["device"]
                    g.set(row["bytes_in_use"], device=dev, stat="bytes_in_use")
                    g.set(self.peak[dev], device=dev, stat="peak_bytes_in_use")
                    for stat in ("limit_bytes", "reserved_bytes", "free_bytes"):
                        if row.get(stat) is not None:
                            g.set(row[stat], device=dev, stat=stat)
            except Exception:
                pass  # gauges are best-effort
        point = {"unix": time.time(), "site": site, "slot": slot, "rows": rows}
        if self.bus is not None:
            try:
                self.bus.emit("device_memory", **point)
            except Exception:
                pass  # a closed bus must not kill the run
        # bounded curve: on overflow drop every other retained point and
        # double the stride; spacing coarsens, endpoints survive
        if self.samples % self._curve_stride == 0:
            self.curve.append(point)
            if len(self.curve) >= self.curve_cap:
                del self.curve[1::2]
                self._curve_stride *= 2
        return rows

    def watermark(self) -> dict:
        return {"samples": self.samples, "source": self.source,
                "peak_bytes": dict(self.peak),
                "allocator_peak_bytes": dict(self.allocator_peak),
                "curve_points": len(self.curve),
                "curve_stride": self._curve_stride}


def shard_completion_times(array) -> list[dict]:
    """Readiness of one output tensor, ms since the probe started: one
    row, its device (the port runs on one device). Empty for anything
    that is not a tensor."""
    t0 = time.perf_counter()
    try:
        import torch
        if not isinstance(array, torch.Tensor):
            return []
        if array.device.type == "cuda":
            torch.cuda.synchronize(array.device)
        return [{"device": str(array.device),
                 "ms": round((time.perf_counter() - t0) * 1e3, 4)}]
    except Exception:
        return []  # probing is best-effort


class FlightRecorder:
    """Arms the device flight recorder for one run.

    >>> fr = FlightRecorder(telemetry=tel, sample_every=16)
    >>> sim = DenseSimulation(n, telemetry=tel, flight_recorder=fr)
    >>> sim.run_epochs(4)
    >>> fr.summary()["memory"]["peak_bytes"]

    The dense driver calls ``install()`` (idempotent) at its first slot,
    then ``should_probe``/``on_slot``/``on_epoch``/``probe_skew``/
    ``sample_memory`` at the cadence sites.
    """

    def __init__(self, telemetry=None, *, registry=None, bus=None,
                 sample_every: int = 16, skew: bool = True,
                 ledger: bool = True, memory: bool = True):
        if telemetry is not None:
            registry = registry if registry is not None else telemetry.registry
            bus = bus if bus is not None else telemetry.bus
        self.registry = registry
        self.bus = bus
        self.sample_every = max(int(sample_every), 1)
        self.memory = (DeviceMemorySampler(registry=registry, bus=bus)
                       if memory else None)
        if ledger:
            from pos_evolution_tpu_torch.profiling.ledger import CompileLedger
            self.ledger = CompileLedger(registry=registry)
        else:
            self.ledger = None
        self.skew_enabled = bool(skew)
        self.skew_probes = 0
        # (phase, device) -> [total_ms, count, max_ms]
        self._skew: dict[tuple[str, str], list] = {}
        self._installed = False

    # -- lifecycle -------------------------------------------------------------

    @property
    def installed(self) -> bool:
        return self._installed

    def install(self) -> FlightRecorder:
        """Point runtime telemetry at this recorder's registry and attach
        the build ledger. Idempotent; the last install wins."""
        from pos_evolution_tpu_torch.telemetry import torchrt
        if self.registry is not None:
            torchrt.install(self.registry)
        if self.ledger is not None:
            torchrt.attach_ledger(self.ledger)
        self._installed = True
        return self

    def detach(self) -> None:
        from pos_evolution_tpu_torch.telemetry import torchrt
        if self.ledger is not None and torchrt.current_ledger() is self.ledger:
            torchrt.attach_ledger(None)
        self._installed = False

    # -- cadence sites (called by the drivers) ---------------------------------

    def should_probe(self, slot: int) -> bool:
        return (slot % self.sample_every) == 0

    def on_slot(self, slot: int) -> None:
        if self.memory is not None and self.should_probe(slot):
            self.memory.sample(site="slot", slot=slot)

    def on_epoch(self, slot: int) -> None:
        if self.memory is not None:
            self.memory.sample(site="epoch", slot=slot)
        from pos_evolution_tpu_torch.telemetry import torchrt
        torchrt.collect_launches()

    def sample_memory(self, *, site: str, slot=None) -> None:
        if self.memory is not None:
            self.memory.sample(site=site, slot=slot)

    def probe_skew(self, phase: str, array, slot=None) -> list[dict]:
        """Record the completion of ``array`` under ``phase``. Call only
        at probed slots: this waits for the device."""
        if not self.skew_enabled:
            return []
        rows = shard_completion_times(array)
        if not rows:
            return rows
        self.skew_probes += 1
        for row in rows:
            cell = self._skew.setdefault((phase, row["device"]), [0.0, 0, 0.0])
            cell[0] += row["ms"]
            cell[1] += 1
            cell[2] = max(cell[2], row["ms"])
        spread = round(max(r["ms"] for r in rows) - min(r["ms"] for r in rows), 4)
        if self.bus is not None:
            try:
                self.bus.emit("shard_skew", phase=phase, slot=slot,
                              spread_ms=spread, rows=rows)
            except Exception:
                pass  # probing is best-effort
        if self.registry is not None:
            try:
                self.registry.gauge(
                    "shard_skew_ms",
                    "straggler spread (max-min shard readiness) at the "
                    "last probed slot").set(spread, phase=phase)
            except Exception:
                pass  # gauges are best-effort
        return rows

    # -- reporting -------------------------------------------------------------

    def skew_table(self) -> list[dict]:
        rows = [{"phase": k[0], "device": k[1],
                 "mean_ms": round(v[0] / v[1], 4), "max_ms": round(v[2], 4),
                 "probes": v[1]}
                for k, v in self._skew.items()]
        rows.sort(key=lambda r: (r["phase"], -r["max_ms"], r["device"]))
        return rows

    def kernel_counts(self) -> dict:
        """The registry's ``kernel_builds_total`` by source and
        ``kernel_launches_total`` by kernel (launches collected first,
        when this recorder feeds runtime telemetry)."""
        if self.registry is None:
            return {}
        if self._installed:
            from pos_evolution_tpu_torch.telemetry import torchrt
            torchrt.collect_launches()
        out: dict = {}
        for key, n in self.registry.counts().items():
            name, _, label = key.partition(";")
            kind = {"kernel_builds_total": "builds",
                    "kernel_launches_total": "launches"}.get(name)
            if kind and label.count("=") == 1:
                out.setdefault(kind, {})[label.split("=", 1)[1]] = n
        return out

    def summary(self) -> dict:
        out: dict = {"sample_every": self.sample_every,
                     "installed": self._installed}
        if self.memory is not None:
            out["memory"] = self.memory.watermark()
        if self.ledger is not None:
            out["compile_ledger"] = self.ledger.summary()
        kernels = self.kernel_counts()
        if kernels:
            out["kernels"] = kernels
        if self.skew_enabled:
            out["shard_skew"] = {"probes": self.skew_probes,
                                 "table": self.skew_table()}
        return out

    def write_artifact(self, path: str) -> dict:
        """Write the device-ledger artifact (``*device_ledger.json``):
        the summary and the whole memory curve, atomically."""
        doc = {"v": 1, "flight_recorder": self.summary()}
        if self.memory is not None:
            doc["memory_curve"] = self.memory.curve
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return doc
