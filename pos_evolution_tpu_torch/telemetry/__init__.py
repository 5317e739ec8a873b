"""Unified telemetry (port of ``pos_evolution_tpu/telemetry/__init__.py``).

One bundle, three legs:

- ``MetricsRegistry`` (``registry.py``, a copy): counters, gauges and
  histograms with labels, Prometheus text and JSON export;
- ``EventBus`` (``events.py``, a copy): schema-versioned JSONL, the
  drivers' slot records and message spans, fault attribution,
  supervision and degradation events;
- the PyTorch runtime (``torchrt.py``): kernel builds and launches,
  dispatch and transfer bytes, folded into the same registry.

Two attachment modes:

- **scoped**: pass a ``Telemetry`` to ``Simulation(telemetry=...)`` or
  ``DenseSimulation(telemetry=...)``: the driver emits to that bus only;
- **global sink**: components with no handle to a bus (the checkpoint
  manager's quarantine, the watchdog, the dense driver's supervision)
  call ``emit_global``, a no-op until a harness calls
  ``set_global``/``Telemetry.install_global``.

Telemetry is not simulation state: a checkpoint excludes it, and a
resumed run records only post-resume events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from pos_evolution_tpu_torch.telemetry.device import (
    DeviceMemorySampler,
    FlightRecorder,
)
from pos_evolution_tpu_torch.telemetry.events import (
    SCHEMA_VERSION,
    EventBus,
    discover_per_process,
    merge_event_files,
    per_process_path,
    read_jsonl,
)
from pos_evolution_tpu_torch.telemetry.fleet import FleetAggregator
from pos_evolution_tpu_torch.telemetry.registry import (
    SNAPSHOT_VERSION,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "SCHEMA_VERSION", "SNAPSHOT_VERSION", "EventBus", "read_jsonl",
    "per_process_path", "discover_per_process", "merge_event_files",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FleetAggregator", "DeviceMemorySampler", "FlightRecorder",
    "Telemetry", "set_global", "get_global", "emit_global",
]


@dataclass
class Telemetry:
    """The bundle a harness threads through a run: one bus, one registry,
    and the debug flag that arms ``StoreInvariantChecker`` in the spec
    driver (a snapshot and compare around every handler call)."""

    bus: EventBus = field(default_factory=EventBus)
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    debug: bool = False

    @classmethod
    def to_file(cls, path, debug: bool = False,
                keep_in_memory: bool = True,
                append: bool = False) -> Telemetry:
        """``append=True`` extends an existing log instead of truncating
        it (a resumed attempt's log: seq ordinals continue past the
        previous attempt's maximum)."""
        return cls(bus=EventBus(path, keep_in_memory=keep_in_memory,
                                append=append),
                   debug=debug)

    def install_torch_runtime(self) -> bool:
        """Fold kernel builds and launches into this bundle's registry
        (process-global; the last install wins)."""
        from pos_evolution_tpu_torch.telemetry import torchrt
        return torchrt.install(self.registry)

    def install_global(self) -> Telemetry:
        """Also make this bundle the global sink for bus-less emitters."""
        set_global(self)
        return self

    def close(self) -> None:
        self.bus.close()


_GLOBAL: list = [None]


def set_global(telemetry: Telemetry | None) -> None:
    _GLOBAL[0] = telemetry


def get_global() -> Telemetry | None:
    return _GLOBAL[0]


def emit_global(type_: str, **fields) -> dict | None:
    """Emit onto the global bus if one is installed; no-op otherwise.
    The call sites must never fail because telemetry is absent or
    broken."""
    t = _GLOBAL[0]
    if t is None:
        return None
    try:
        return t.bus.emit(type_, **fields)
    except Exception:
        return None
