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

``NULL_TIMER`` is the disabled twin with the same interface. The JAX
package's compile-ledger spans, its metric registry and event bus, and
the off-loop charge of background checkpoint writes are not ported
here.
"""

from __future__ import annotations

import time

import torch

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
    "record",             # block tree and metrics bookkeeping
)


class _Phase:
    """One timed section; re-entered phases accumulate."""

    __slots__ = ("name", "timer")

    def __init__(self, timer: PhaseTimer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self) -> _Phase:
        self.timer._stack.append((self.name, time.perf_counter()))
        return self

    def __exit__(self, *exc) -> None:
        name, t0 = self.timer._stack.pop()
        self.timer._charge(name, time.perf_counter() - t0)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_PHASE = _NullPhase()


class PhaseTimer:
    """Accumulating per-phase wall timer with sampled device fencing.

    >>> pt = PhaseTimer(sample_every=16)
    >>> pt.begin_slot(s)
    >>> with pt.phase("vote_pass"):
    ...     out = kernel(...)
    ...     pt.fence(out)          # synchronize at sampled slots
    >>> pt.end_slot(s)
    >>> pt.summary()["accounted_pct"]
    """

    enabled = True

    def __init__(self, sample_every: int = 16):
        self.sample_every = max(int(sample_every), 1)
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

    # -- slot lifecycle --------------------------------------------------------

    def begin_slot(self, slot: int) -> None:
        self.sampled = (slot % self.sample_every) == 0
        self._slot_acc = {}
        self._slot_t0 = time.perf_counter()

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def _charge(self, name: str, dt: float) -> None:
        self._slot_acc[name] = self._slot_acc.get(name, 0.0) + dt

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

    # -- results ---------------------------------------------------------------

    def summary(self) -> dict:
        def table(acc: dict, wall: float) -> dict:
            return {
                name: {"total_ms": round(sec * 1e3, 3), "count": n,
                       "share_pct": round(100.0 * sec / wall, 2) if wall > 0 else None}
                for name, (sec, n) in sorted(acc.items())
            }

        accounted = sum(sec for sec, _ in self.sampled_totals.values())
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
        }


class _NullTimer:
    """The disabled twin: identical surface, empty bodies."""

    enabled = False
    sampled = False

    def begin_slot(self, slot: int) -> None:
        pass

    def phase(self, name: str) -> _NullPhase:
        return _NULL_PHASE

    def fence(self, *tensors) -> None:
        pass

    def end_slot(self, slot: int) -> None:
        pass

    def summary(self) -> dict | None:
        return None


NULL_TIMER = _NullTimer()
