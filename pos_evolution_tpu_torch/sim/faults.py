"""Fault plans as data (port of ``pos_evolution_tpu/sim/faults.py``).

The spec tier's half (``CrashWindow``, ``FaultPlan``, ``lossy_plan``,
``chaos_plan``; the original's ``:91-238``) decides each (message,
recipient group) delivery's fate, drop, duplicate or reorder, by a
stateless seeded hash of the message's identity, and declares crash
windows of whole view groups that ``sim/driver.Simulation`` rejoins by
checkpoint sync. The dense half (``:256-351``) expresses message loss,
delay, crash blackouts and view partitions as masks over the validator
axis: one blake2b word of (seed, key) expanded with a splitmix64
finalizer, in uint64 numpy.

Every decision is a pure function of its identity, with no RNG cursor,
so a run resumed from a checkpoint replays the same faults, and the
decisions are byte-equal to the JAX package's.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["CrashWindow", "DenseCrashWindow", "DenseFaultPlan", "FaultPlan", "chaos_plan",
           "lossy_plan", "stateless_unit", "stateless_unit_array", "stateless_word"]

# integer tags for message kinds (stable fault-decision identity)
_KIND_TAG = {"block": 0, "attestation": 1, "slashing": 2}


def stateless_word(seed: int, *key: int) -> int:
    """The 64-bit blake2b word of (seed, key): the seed of a vectorized
    draw."""
    h = hashlib.blake2b(struct.pack(f"<{len(key) + 1}q", seed, *key), digest_size=8).digest()
    return int.from_bytes(h, "little")


def stateless_unit(seed: int, *key: int) -> float:
    """Uniform [0, 1) from a hash of (seed, key): the same identity always
    draws the same number."""
    return stateless_word(seed, *key) / 2.0**64


# splitmix64 constants (Steele et al.)
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def stateless_unit_array(seed: int, *key: int, n: int) -> np.ndarray:
    """Vectorized ``stateless_unit``: uniform [0, 1) float64 per index
    0..n-1, one ``stateless_word(seed, *key)`` expanded by splitmix64."""
    base = np.uint64(stateless_word(seed, *key))
    with np.errstate(over="ignore"):
        z = base + np.arange(1, n + 1, dtype=np.uint64) * _SM_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
        z = z ^ (z >> np.uint64(31))
    return z.astype(np.float64) / 2.0**64


@dataclass(frozen=True)
class CrashWindow:
    """View group ``group`` is down for slots [crash_slot, rejoin_slot):
    it processes nothing, receives nothing (messages in flight are lost),
    and at ``rejoin_slot`` rejoins by checkpoint sync from a live peer."""

    group: int
    crash_slot: int
    rejoin_slot: int

    def __post_init__(self):
        assert self.crash_slot < self.rejoin_slot, "empty crash window"


@dataclass
class FaultPlan:
    """Composable message-fault policy; attach via ``Schedule.faults``."""

    seed: int = 0
    # Per-(message, recipient-group) probabilities, active before GST.
    drop_p: float = 0.0
    duplicate_p: float = 0.0
    reorder_p: float = 0.0
    # A reordered (or duplicated) copy lands up to this many seconds late —
    # the adversary's "target a message for delivery ... just before a
    # certain point in time" capability (pos-evolution.md:1328) expressed
    # as bounded jitter.
    reorder_max_delay: float = 4.0
    # Global stabilization time in seconds since genesis; None = faults
    # stay active for the whole run (no partial-synchrony window).
    gst: float | None = None
    crashes: tuple = ()
    # Observability: when True, every non-trivial fault decision appends a
    # dict to ``log`` (tests assert drop invariants against it). The log
    # is NOT part of simulation state: a resumed run re-records only
    # post-resume decisions.
    record_log: bool = False
    log: list = field(default_factory=list)
    # Telemetry sink (an ``EventBus`` or anything with ``.emit``): every
    # non-trivial decision also lands as a ``fault`` event carrying the
    # seeded hash inputs that decided it — (seed, kind tag, slot, src,
    # msg_id, dst) plus the drawn uniform and its threshold — so a run
    # report can attribute "why did THIS message vanish" without the live
    # plan. Like ``log``, the sink is not simulation state (the driver
    # re-attaches it on resume alongside the schedule).
    sink: object = None

    # -- stateless randomness --------------------------------------------------

    def _unit(self, *key: int) -> float:
        """Uniform [0, 1) from a hash of (seed, key): no RNG stream, no
        call-order dependence — the same message identity always draws the
        same number, before or after a checkpoint/resume."""
        return stateless_unit(self.seed, *key)

    # -- message faults --------------------------------------------------------

    def active(self, time: float) -> bool:
        """Message faults apply only before GST (pos-evolution.md:199)."""
        return self.gst is None or time < self.gst

    def delivery_offsets(self, kind: str, slot: int, src: int, msg_id: int,
                         dst_group: int, base_time: float) -> list[float]:
        """Extra delays (seconds, added to the scheduled delivery time) for
        each copy of one (message, recipient-group) delivery. ``[]`` means
        dropped; two entries mean duplicated; a single nonzero entry is a
        reorder past later-sent messages."""
        if not self.active(base_time):
            return [0.0]
        tag = _KIND_TAG.get(kind, 3)
        key = (tag, slot, src, msg_id, dst_group)
        if self.drop_p > 0.0:
            u = self._unit(0, *key)
            if u < self.drop_p:
                self._log("drop", kind, slot, src, msg_id, dst_group,
                          u=u, p=self.drop_p)
                return []
        offsets = [0.0]
        if self.reorder_p > 0.0:
            u = self._unit(1, *key)
            if u < self.reorder_p:
                offsets = [self._unit(2, *key) * self.reorder_max_delay]
                self._log("reorder", kind, slot, src, msg_id, dst_group,
                          u=u, p=self.reorder_p, delay_s=offsets[0])
        if self.duplicate_p > 0.0:
            u = self._unit(3, *key)
            if u < self.duplicate_p:
                extra = self._unit(4, *key) * self.reorder_max_delay
                offsets.append(extra)
                self._log("duplicate", kind, slot, src, msg_id, dst_group,
                          u=u, p=self.duplicate_p, delay_s=extra)
        return offsets

    def _log(self, action: str, kind: str, slot: int, src: int, msg_id: int,
             dst_group: int, u: float | None = None, p: float | None = None,
             delay_s: float | None = None) -> None:
        if self.record_log:
            self.log.append({"action": action, "kind": kind, "slot": slot,
                             "src": src, "msg_id": msg_id, "dst": dst_group})
        if self.sink is not None:
            # fault attribution: the full seeded-hash identity that decided
            # this fate, replayable via _unit(seed, tag, slot, src, msg_id,
            # dst) — enough for run_report to explain any one lost message
            ev = {"action": action, "kind": kind, "slot": slot, "src": src,
                  "msg_id": msg_id, "dst": dst_group, "seed": self.seed,
                  "tag": _KIND_TAG.get(kind, 3)}
            if u is not None:
                # unrounded: JSON round-trips doubles losslessly, and the
                # replay contract (DESIGN.md §11) is EXACT equality with
                # re-drawing this identity through _unit
                ev["u"] = u
                ev["threshold"] = p
            if delay_s is not None:
                ev["delay_s"] = round(delay_s, 6)
            self.sink.emit("fault", **ev)

    def dropped(self, kind: str | None = None) -> list[dict]:
        """Recorded drop events (requires ``record_log=True``)."""
        return [e for e in self.log if e["action"] == "drop"
                and (kind is None or e["kind"] == kind)]

    # -- crash windows ---------------------------------------------------------

    def crashed(self, group: int, slot: int) -> bool:
        """Pure function of the slot — no crash state to checkpoint."""
        return any(w.group == group and w.crash_slot <= slot < w.rejoin_slot
                   for w in self.crashes)

    def rejoins(self, group: int, slot: int) -> bool:
        """True exactly at the slot where ``group`` comes back up (and is
        not immediately re-crashed by an overlapping window)."""
        return (any(w.group == group and w.rejoin_slot == slot
                    for w in self.crashes)
                and not self.crashed(group, slot))


def lossy_plan(seed: int = 0, drop_p: float = 0.1,
               gst: float | None = None) -> FaultPlan:
    """Message loss only — the minimal ebb-and-flow adversary."""
    return FaultPlan(seed=seed, drop_p=drop_p, gst=gst)


def chaos_plan(seed: int = 0, drop_p: float = 0.05, duplicate_p: float = 0.05,
               reorder_p: float = 0.1, gst: float | None = None,
               crashes: tuple = ()) -> FaultPlan:
    """Drops + duplicates + reorders + optional crash windows."""
    return FaultPlan(seed=seed, drop_p=drop_p, duplicate_p=duplicate_p,
                     reorder_p=reorder_p, gst=gst, crashes=tuple(crashes))


# stateless_unit_array decision domains
_D_DENSE_DROP, _D_DENSE_DELAY = 20, 21


@dataclass(frozen=True)
class DenseCrashWindow:
    """Validators [lo, hi) are down for slots [crash_slot, rejoin_slot):
    they cast nothing and resume duty at ``rejoin_slot``."""

    lo: int
    hi: int
    crash_slot: int
    rejoin_slot: int

    def __post_init__(self):
        if not self.lo < self.hi:
            raise ValueError("empty validator range")
        if not self.crash_slot < self.rejoin_slot:
            raise ValueError("empty crash window")


@dataclass(frozen=True)
class DenseFaultPlan:
    """Composable fault masks for the dense driver.

    - ``drop_p`` / ``delay_p``: per-(slot, view, validator) draws; a
      dropped vote never lands, a delayed one lands at the next slot
      (before that slot's fresh votes);
    - ``gst_slot``: message faults switch off from this slot on;
    - ``crashes``: index-range blackouts (``DenseCrashWindow``);
    - ``partition``: cross-view delivery for two-view runs: ``None``,
      ``"full"`` (views never exchange traffic) or ``"delay"`` (cross-view
      blocks and votes land one slot late).
    """

    seed: int = 0
    drop_p: float = 0.0
    delay_p: float = 0.0
    gst_slot: int | None = None
    crashes: tuple = ()
    partition: str | None = None

    def __post_init__(self):
        if self.partition not in (None, "full", "delay"):
            raise ValueError(f"unknown partition {self.partition!r}")

    def active(self, slot: int) -> bool:
        """Message faults apply only before GST."""
        return self.gst_slot is None or slot < self.gst_slot

    def delivery_masks(self, slot: int, view: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(dropped, delayed) bool[n] for one (slot, view), disjoint;
        all False past GST."""
        if not self.active(slot) or (self.drop_p <= 0 and self.delay_p <= 0):
            z = np.zeros(n, dtype=bool)
            return z, z
        dropped = np.zeros(n, dtype=bool)
        delayed = np.zeros(n, dtype=bool)
        if self.drop_p > 0:
            u = stateless_unit_array(self.seed, _D_DENSE_DROP, slot, view, n=n)
            dropped = u < self.drop_p
        if self.delay_p > 0:
            u = stateless_unit_array(self.seed, _D_DENSE_DELAY, slot, view, n=n)
            delayed = (u < self.delay_p) & ~dropped
        return dropped, delayed

    def crashed_mask(self, slot: int, n: int) -> np.ndarray:
        """bool[n]: validators blacked out at ``slot``."""
        out = np.zeros(n, dtype=bool)
        for w in self.crashes:
            if w.crash_slot <= slot < w.rejoin_slot:
                out[w.lo:min(w.hi, n)] = True
        return out

    def describe(self) -> dict:
        """Config fingerprint for dense checkpoints."""
        return {
            "kind": type(self).__name__, "seed": self.seed,
            "drop_p": self.drop_p, "delay_p": self.delay_p,
            "gst_slot": self.gst_slot, "partition": self.partition,
            "crashes": [{"lo": w.lo, "hi": w.hi, "crash_slot": w.crash_slot,
                         "rejoin_slot": w.rejoin_slot} for w in self.crashes],
        }

    @classmethod
    def from_config(cls, d: dict | None) -> DenseFaultPlan | None:
        if d is None:
            return None
        return cls(seed=d.get("seed", 0), drop_p=d.get("drop_p", 0.0),
                   delay_p=d.get("delay_p", 0.0), gst_slot=d.get("gst_slot"),
                   partition=d.get("partition"),
                   crashes=tuple(DenseCrashWindow(w["lo"], w["hi"], w["crash_slot"],
                                                  w["rejoin_slot"])
                                 for w in d.get("crashes", ())))
