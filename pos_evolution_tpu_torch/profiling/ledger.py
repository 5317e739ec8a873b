"""Build-provenance ledger: which kernel sources were built, and during
which span (port of ``pos_evolution_tpu/profiling/ledger.py``).

The JAX package charges XLA compiles to the span active when they ran.
The port has no XLA compiles: its one compile step is a kernel build,
``ops/kernels.build_all`` (one ``nvcc`` a source, its wall time in
``kernels.build_seconds``), which runs at a kernel's first launch
unless the caller built it first. This module is the span side of that
charge, a thread-local **span context** the rest of the port pushes
into:

- ``profiling/phases.py`` sets the *phase* slot on every
  ``with pt.phase(name)`` enter and exit (two attribute writes);
- ``function_scope`` names the function about to launch;
- ``profiling/attribution.py``'s ``ProfiledRegion`` sets the *region*
  slot so ad-hoc profiled blocks name their builds too.

``CompileLedger.on_build`` (called through ``telemetry/torchrt.py``
when a ledger is attached) reads the context on the thread that built
and charges the build to a ``(source, function, phase)`` row. With no
function scope but a phase, the row is named ``inline:<phase>``, and
with neither but a region, the region's name, as in the JAX package.
Rows also flow into the registry as
``kernel_builds_by_provenance_total{source,function,phase}``.

Everything here is stdlib-only and never raises into the caller: the
ledger is observability, and observability must never be the reason a
run dies.
"""

from __future__ import annotations

import threading

__all__ = [
    "CompileLedger",
    "current_function",
    "current_phase",
    "current_region",
    "function_scope",
    "pop_phase",
    "push_phase",
]

_TLS = threading.local()


def _ctx():
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        ctx = _TLS.ctx = {"function": None, "phase": None, "region": None}
    return ctx


def push_phase(name: str):
    """Set the active phase; returns the previous value for ``pop_phase``."""
    ctx = _ctx()
    prev = ctx["phase"]
    ctx["phase"] = name
    return prev


def pop_phase(prev) -> None:
    _ctx()["phase"] = prev


def current_phase() -> str | None:
    return _ctx()["phase"]


def current_function() -> str | None:
    return _ctx()["function"]


def push_region(name: str):
    """Set the active profiled region; returns the previous value."""
    ctx = _ctx()
    prev = ctx["region"]
    ctx["region"] = name
    return prev


def pop_region(prev) -> None:
    _ctx()["region"] = prev


def current_region() -> str | None:
    return _ctx()["region"]


class function_scope:
    """Cheap ``with`` scope naming the function about to launch. Nested
    scopes restore the outer name on exit; exceptions propagate (the
    scope itself never raises)."""

    __slots__ = ("_prev", "name")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ctx = _ctx()
        self._prev = ctx["function"]
        ctx["function"] = self.name
        return self

    def __exit__(self, *exc):
        _ctx()["function"] = self._prev
        return False


def provenance() -> tuple[str, str]:
    """The (function, phase) a build is charged to now: an explicit
    ``function_scope``, else ``inline:<phase>`` when only a phase is
    active, else the active ``ProfiledRegion``'s name, else ``"?"``."""
    ctx = _ctx()
    phase = ctx["phase"] or "?"
    fn = ctx["function"]
    if fn is None:
        if ctx["phase"] is not None:
            fn = f"inline:{ctx['phase']}"
        else:
            fn = ctx["region"] or "?"
    return fn, phase


class CompileLedger:
    """Per-(source, function, phase) decomposition of kernel builds.

    Attach with ``telemetry.torchrt.attach_ledger(ledger)``; every build
    ``ops/kernels.build_all`` finishes then lands in :meth:`on_build`,
    charged to the span context of the thread that asked for it.
    Thread-safe; bounded by the number of sources and phases.
    """

    def __init__(self, registry=None):
        self.registry = registry
        self._lock = threading.Lock()
        # (source, function, phase) -> [count, seconds]
        self._rows: dict[tuple[str, str, str], list] = {}

    def on_build(self, source: str, seconds: float) -> None:
        fn, phase = provenance()
        with self._lock:
            row = self._rows.setdefault((source, fn, phase), [0, 0.0])
            row[0] += 1
            row[1] += float(seconds)
        reg = self.registry
        if reg is not None:
            try:
                reg.counter(
                    "kernel_builds_by_provenance_total",
                    "kernel builds by (source, function, phase)",
                ).inc(1, source=source, function=fn, phase=phase)
            except Exception:
                pass  # the ledger must never kill a run

    def rows(self) -> list[dict]:
        """Ledger rows, heaviest build time first."""
        with self._lock:
            items = [
                {"stage": "build", "source": k[0], "function": k[1], "phase": k[2],
                 "count": v[0], "seconds": round(v[1], 6)}
                for k, v in self._rows.items()
            ]
        items.sort(key=lambda r: (-r["seconds"], r["source"], r["function"]))
        return items

    def attribution(self, total: int | None = None) -> dict:
        """How many builds have a named row (a known phase or function).
        ``total`` defaults to every build the ledger saw."""
        with self._lock:
            counts = [(k, v[0]) for k, v in self._rows.items()]
        seen = sum(n for _, n in counts)
        named = sum(n for (_, fn, phase), n in counts if phase != "?" or fn != "?")
        denom = int(total) if total is not None else seen
        pct = round(100.0 * named / denom, 2) if denom else None
        return {"builds": denom, "seen": seen, "named": named, "named_pct": pct}

    def summary(self) -> dict:
        return {"rows": self.rows(), "attribution": self.attribution()}
