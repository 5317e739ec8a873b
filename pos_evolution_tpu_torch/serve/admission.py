"""Admission control, brownout, and the backing-store circuit breaker.

The overload posture of the serving tier, in one sentence: **never let
work the tier cannot finish in time consume the capacity of work it
can** — and say so honestly.

Three cooperating pieces, all host-side, all clock-injectable so tests
never sleep:

- ``AdmissionQueue`` — a priority-tiered bounded queue whose bound is
  *deadline-derived*: at offer time the projected queue wait (depth ahead
  of the request x EMA service time / workers) is compared against the
  request's remaining deadline budget; a request that would time out in
  the queue is rejected NOW with ``retry_after`` = the projected wait,
  which is exactly when retrying could succeed. Rejecting at the door
  costs microseconds; timing out in the queue costs a worker slot and
  still fails the client.
- ``BrownoutController`` — graceful degradation under sustained
  overload: when the INTERACTIVE tier's observed queue delay climbs past
  the enter threshold, bulk sampling traffic is shed outright until the
  delay falls below the exit threshold for several consecutive
  observations (hysteresis — flapping in and out of brownout is worse
  than either state). Head/finality/update traffic is never browned out:
  it is the tier's reason to exist and the ISSUE's goodput criterion.
- ``CircuitBreaker`` — the classic closed/open/half-open machine around
  the backing store: consecutive failures trip it open, clients get
  honest ``unavailable`` + retry-after for the cooldown, then ONE
  half-open probe decides between closing and re-opening. A broken
  backing store served at full concurrency is a retry storm amplifier.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["ServiceEstimator", "AdmissionQueue", "BrownoutController",
           "CircuitBreaker"]


class ServiceEstimator:
    """Thread-safe EMA of observed service (and queue-wait) seconds."""

    def __init__(self, initial_s: float = 0.002, alpha: float = 0.1):
        self._lock = threading.Lock()
        self.alpha = float(alpha)
        self._ema = float(initial_s)
        self.observations = 0

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ema += self.alpha * (float(seconds) - self._ema)
            self.observations += 1

    @property
    def ema_s(self) -> float:
        with self._lock:
            return self._ema


class AdmissionQueue:
    """Bounded two-tier (interactive / bulk) admission queue.

    ``offer`` either admits (returns None) or returns the shed verdict
    ``{"reason": ..., "retry_after_ms": ...}``. ``take`` blocks workers,
    draining interactive strictly before bulk.
    """

    def __init__(self, workers: int, max_depth: int = 512,
                 admit_factor: float = 0.8,
                 estimator: ServiceEstimator | None = None,
                 clock=time.monotonic):
        self.workers = max(int(workers), 1)
        self.max_depth = int(max_depth)
        # fraction of the remaining deadline the projected wait may eat
        # before admission becomes dishonest (the service itself and the
        # response write need the rest)
        self.admit_factor = float(admit_factor)
        self.estimator = estimator or ServiceEstimator()
        self.clock = clock
        self._cond = threading.Condition()
        self._tiers: tuple[deque, deque] = (deque(), deque())
        self._closed = False
        self.admitted = 0
        self.shed = {"deadline": 0, "depth": 0, "brownout": 0,
                     "draining": 0}

    def depth(self, tier: int | None = None) -> int:
        with self._cond:
            if tier is None:
                return sum(len(q) for q in self._tiers)
            return len(self._tiers[tier])

    def projected_wait_s(self, tier: int) -> float:
        """Seconds a request admitted NOW to ``tier`` expects to queue:
        everything that will be served before it, over the worker pool.
        Bulk waits behind the whole interactive backlog (strict
        priority); interactive waits only behind its own tier."""
        with self._cond:
            ahead = len(self._tiers[0]) + (len(self._tiers[1])
                                           if tier == 1 else 0)
        return ahead * self.estimator.ema_s / self.workers

    def offer(self, item, tier: int, budget_s: float,
              brownout: bool = False) -> dict | None:
        """Admit ``item`` or return the shed verdict. ``budget_s`` is the
        request's remaining deadline budget at offer time."""
        wait_s = self.projected_wait_s(tier)
        if brownout and tier == 1:
            verdict = {"reason": "brownout",
                       "retry_after_ms": max(wait_s, self.estimator.ema_s
                                             * self.workers) * 1e3}
        elif wait_s > max(budget_s, 0.0) * self.admit_factor:
            verdict = {"reason": "deadline",
                       "retry_after_ms": wait_s * 1e3}
        else:
            with self._cond:
                if len(self._tiers[tier]) >= self.max_depth:
                    verdict = {"reason": "depth",
                               "retry_after_ms": wait_s * 1e3}
                else:
                    self._tiers[tier].append(item)
                    self.admitted += 1
                    self._cond.notify()
                    return None
        with self._cond:  # shed counts feed the report: no lost updates
            self.shed[verdict["reason"]] += 1
        verdict["retry_after_ms"] = round(
            max(verdict["retry_after_ms"], 1.0), 3)
        return verdict

    def take(self, timeout: float | None = None):
        """Pop the next item (interactive first); None on close/timeout."""
        with self._cond:
            deadline = (self.clock() + timeout) if timeout is not None \
                else None
            while not self._closed:
                for q in self._tiers:
                    if q:
                        return q.popleft()
                remaining = None
                if deadline is not None:
                    remaining = deadline - self.clock()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)
            return None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list:
        """Every still-queued item, after ``close()`` — the honest-drain
        path: a stopping front answers each with ``shed`` + retry-after
        instead of letting admitted work vanish silently."""
        with self._cond:
            assert self._closed, "drain() is for closed queues"
            items = [item for q in self._tiers for item in q]
            for q in self._tiers:
                q.clear()
            self.shed["draining"] += len(items)
            return items


class BrownoutController:
    """Hysteresis state machine shedding BULK before interactive.

    Feed it the interactive tier's observed queue waits; read
    ``active`` at offer time. Enter is immediate (overload hurts now),
    exit needs ``exit_streak`` consecutive calm observations.
    """

    def __init__(self, enter_wait_s: float = 0.05,
                 exit_wait_s: float = 0.01, exit_streak: int = 16,
                 clock=time.monotonic):
        assert exit_wait_s <= enter_wait_s
        self.enter_wait_s = float(enter_wait_s)
        self.exit_wait_s = float(exit_wait_s)
        self.exit_streak = int(exit_streak)
        self.clock = clock
        self._lock = threading.Lock()
        self.active = False
        self._calm = 0
        self.transitions: list[dict] = []

    def observe_interactive_wait(self, wait_s: float) -> bool:
        """Record one interactive queue wait; returns the (possibly
        updated) brownout state."""
        with self._lock:
            if not self.active:
                if wait_s > self.enter_wait_s:
                    self.active = True
                    self._calm = 0
                    self.transitions.append(
                        {"state": "brownout", "t": self.clock(),
                         "wait_ms": round(wait_s * 1e3, 3)})
            else:
                if wait_s < self.exit_wait_s:
                    self._calm += 1
                    if self._calm >= self.exit_streak:
                        self.active = False
                        self.transitions.append(
                            {"state": "normal", "t": self.clock(),
                             "wait_ms": round(wait_s * 1e3, 3)})
                else:
                    self._calm = 0
            return self.active


class CircuitBreaker:
    """closed -> (N consecutive failures) -> open -> (cooldown) ->
    half-open -> one probe -> closed | open."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 cooldown_s: float = 1.0, clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.transitions: list[dict] = []

    def _set(self, state: str) -> None:
        self.state = state
        self.transitions.append({"state": state, "t": self.clock()})

    def allow(self) -> tuple[bool, float]:
        """(admit?, retry_after_s when not). In half-open exactly one
        caller gets the probe slot; the rest are refused until the probe
        reports."""
        with self._lock:
            if self.state == self.OPEN:
                remaining = self._opened_at + self.cooldown_s - self.clock()
                if remaining > 0:
                    return False, remaining
                self._set(self.HALF_OPEN)
                self._probing = False
            if self.state == self.HALF_OPEN:
                if self._probing:
                    return False, self.cooldown_s
                self._probing = True
            return True, 0.0

    def abandon(self) -> None:
        """The caller who held an admission (possibly THE half-open
        probe slot) finished without a verdict on the backing store —
        e.g. its deadline expired before the backing access ran. Free
        the probe slot; leaving it held would wedge the breaker in
        half-open forever (nothing admitted, so no verdict can ever
        arrive)."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self.state != self.CLOSED:
                self._set(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self.state == self.HALF_OPEN:
                self._opened_at = self.clock()
                self._set(self.OPEN)
                return
            self._failures += 1
            if (self.state == self.CLOSED
                    and self._failures >= self.failure_threshold):
                self._opened_at = self.clock()
                self._set(self.OPEN)
