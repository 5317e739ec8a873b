"""Dense-driver phase profiler (port of ``pos_evolution_tpu/profiling/phases.py``).

``DenseSimulation.run_slot`` is one host loop that launches device work
(vote landing, the head query, aggregate signing and verification, the
epoch sweep) around host work (committee masks, monitors, the audit
walk). The profiler gives a per-slot phase budget that accounts for
almost all of the slot's wall time:

- **every slot** is phase-timed with ``perf_counter`` pairs. CUDA work
  is asynchronous, so an unfenced phase is charged only what it costs
  the host to launch its work, and the device time shows up in whichever
  later phase first waits on it;
- **sampled slots** (every ``sample_every``-th) also ``fence`` each
  phase: a ``torch.cuda.synchronize`` of the devices its tensors live
  on, so the sampled budget charges device time to the phase that
  launched it. CPU tensors need no fence.

Each phase is published to the span context of ``profiling/ledger.py``
while it is open, so kernel builds and transfer bytes inside it name
their phase. While ``torch.profiler`` records, each phase is also a named
host range (``utils/metrics.trace_region``), the timer on or off, so a
trace (``profiling/kineto.py``) credits every kernel to the phase that
launched it. With a registry the sampled slots feed the
``dense_phase_ms`` histogram, with a bus one ``dense_phase`` event each.
Work done off the slot loop (the checkpoint writer thread's
serialization) is charged apart by ``charge_async``, never into the
slot partition.

``NULL_TIMER`` is the disabled twin with the same interface.
"""

from __future__ import annotations

import threading
import time

import torch

from pos_evolution_tpu_torch.profiling import ledger
from pos_evolution_tpu_torch.utils.metrics import trace_region

__all__ = ["DENSE_PHASES", "NULL_TIMER", "PhaseTimer"]

# Every section of ``run_slot`` belongs to exactly one of these, so the
# budget is a partition of the slot's wall time.
DENSE_PHASES = (
    "epoch_sweep",        # _epoch_boundary: process_epoch_dense over the views
    "shuffle",            # _start_epoch: committee shuffle + assignment
    "vote_pass",          # _head: expiry window and vote buckets
    "head_descent",       # _head: head_from_buckets descent
    "vote_apply",         # _deliver_batch/_apply_batch vote landing
    "variant_tally",      # dense variant plane: per-slot tallies and gadgets
    "workload",           # riders: DAS sidecar build, verification, sampling; light clients
    "aggregate_verify",   # _verify_slot committee aggregates (K1)
    "monitors",           # dense monitor sweep over the tallies
    "host_audit",         # head_host_walk parity check
    "checkpoint_capture",    # supervision tick: device -> host gather
    "checkpoint_serialize",  # supervision tick: npz on the writer thread
    "record",             # block tree and metrics bookkeeping
)


class _Phase:
    """One timed section; re-entered phases accumulate."""

    __slots__ = ("_prev_phase", "_range", "name", "timer")

    def __init__(self, timer: PhaseTimer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self) -> _Phase:
        self._prev_phase = ledger.push_phase(self.name)
        self._range = trace_region(self.name)
        self._range.__enter__()
        self.timer._stack.append((self.name, time.perf_counter()))
        return self

    def __exit__(self, *exc) -> None:
        name, t0 = self.timer._stack.pop()
        self.timer._charge(name, time.perf_counter() - t0)
        self._range.__exit__(*exc)
        ledger.pop_phase(self._prev_phase)


class PhaseTimer:
    """Accumulating per-phase wall timer with sampled device fencing.

    >>> pt = PhaseTimer(sample_every=16, registry=reg, bus=bus)
    >>> pt.begin_slot(s)
    >>> with pt.phase("vote_pass"):
    ...     out = kernel(...)
    ...     pt.fence(out)          # synchronize at sampled slots
    >>> pt.end_slot(s)
    >>> pt.summary()["accounted_pct"]
    """

    enabled = True

    def __init__(self, sample_every: int = 16, registry=None, bus=None):
        self.sample_every = max(int(sample_every), 1)
        self.registry = registry
        self.bus = bus
        self.sampled = False
        self._stack: list[tuple[str, float]] = []
        self._slot_t0 = 0.0
        self._slot_acc: dict[str, float] = {}
        # all-slots / sampled-slots accumulators: {phase: [seconds, n]}
        self.totals: dict[str, list] = {}
        self.sampled_totals: dict[str, list] = {}
        self.slots = 0
        self.sampled_slots = 0
        self.wall_s = 0.0
        self.sampled_wall_s = 0.0
        # off-loop work overlaps the slot wall, so it is kept apart
        self._async_lock = threading.Lock()
        self.async_totals: dict[str, list] = {}
        self._hist = (registry.histogram(
            "dense_phase_ms", "per-phase slot time at sampled (fenced) slots, ms")
            if registry is not None else None)

    # -- slot lifecycle --------------------------------------------------------

    def begin_slot(self, slot: int) -> None:
        self.sampled = (slot % self.sample_every) == 0
        self._slot_acc = {}
        self._slot_t0 = time.perf_counter()

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def _charge(self, name: str, dt: float) -> None:
        self._slot_acc[name] = self._slot_acc.get(name, 0.0) + dt

    def charge_async(self, name: str, dt: float) -> None:
        """Charge work that ran off the slot loop (another thread);
        thread-safe, kept out of the slot partition."""
        with self._async_lock:
            row = self.async_totals.setdefault(name, [0.0, 0])
            row[0] += dt
            row[1] += 1

    def fence(self, *tensors) -> None:
        """At sampled slots, wait for the device work that the open
        phase launched: synchronize every CUDA device among ``tensors``
        (None entries and CPU tensors need nothing)."""
        if not self.sampled:
            return
        devices = {t.device for t in tensors
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def end_slot(self, slot: int) -> None:
        wall = time.perf_counter() - self._slot_t0
        self.slots += 1
        self.wall_s += wall
        for name, dt in self._slot_acc.items():
            row = self.totals.setdefault(name, [0.0, 0])
            row[0] += dt
            row[1] += 1
        if not self.sampled:
            return
        self.sampled_slots += 1
        self.sampled_wall_s += wall
        for name, dt in self._slot_acc.items():
            row = self.sampled_totals.setdefault(name, [0.0, 0])
            row[0] += dt
            row[1] += 1
            if self._hist is not None:
                self._hist.observe(dt, phase=name)
        if self.bus is not None:
            try:
                self.bus.emit(
                    "dense_phase", slot=slot, wall_ms=round(wall * 1e3, 4),
                    phases={n: round(dt * 1e3, 4) for n, dt in sorted(self._slot_acc.items())},
                    accounted_pct=(round(100.0 * sum(self._slot_acc.values()) / wall, 2)
                                   if wall > 0 else None))
            except Exception:
                pass  # a closed bus must not kill the slot it observed

    # -- results ---------------------------------------------------------------

    def summary(self) -> dict:
        def table(acc: dict, wall: float) -> dict:
            return {
                name: {"total_ms": round(sec * 1e3, 3), "count": n,
                       "share_pct": round(100.0 * sec / wall, 2) if wall > 0 else None}
                for name, (sec, n) in sorted(acc.items())
            }

        accounted = sum(sec for sec, _ in self.sampled_totals.values())
        with self._async_lock:
            async_phases = {name: {"total_ms": round(sec * 1e3, 3), "count": n}
                            for name, (sec, n) in sorted(self.async_totals.items())}
        return {
            "sample_every": self.sample_every,
            "slots": self.slots,
            "sampled_slots": self.sampled_slots,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "sampled_wall_ms": round(self.sampled_wall_s * 1e3, 3),
            "phases": table(self.totals, self.wall_s),
            "sampled_phases": table(self.sampled_totals, self.sampled_wall_s),
            "accounted_pct": (round(100.0 * accounted / self.sampled_wall_s, 2)
                              if self.sampled_wall_s > 0 else None),
            "async_phases": async_phases,
        }


class _NullTimer:
    """The disabled twin: identical surface, empty bodies (its phases are
    still named host ranges while a profiler records)."""

    enabled = False
    sampled = False

    def begin_slot(self, slot: int) -> None:
        pass

    def phase(self, name: str):
        return trace_region(name)     # a null context unless a profiler records

    def fence(self, *tensors) -> None:
        pass

    def charge_async(self, name: str, dt: float) -> None:
        pass

    def end_slot(self, slot: int) -> None:
        pass

    def summary(self) -> dict | None:
        return None


NULL_TIMER = _NullTimer()
