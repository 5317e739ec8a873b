"""Dense fault plans: message loss, delay, crash blackouts and view
partitions as masks over the validator axis (port of the dense half of
``pos_evolution_tpu/sim/faults.py``: ``:40-90`` and ``:256-351``).

Every per-(slot, view, validator) decision is a pure function of its
identity: one blake2b word of (seed, key) expanded over the validator
axis with a splitmix64 finalizer, in uint64 numpy. No RNG cursor, so a
run resumed from a checkpoint replays the same faults, and the masks
are byte-equal to the JAX package's. The spec-tier ``FaultPlan`` is not
ported here.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["DenseCrashWindow", "DenseFaultPlan", "stateless_unit", "stateless_unit_array",
           "stateless_word"]


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
