"""The supervision core: child-liveness policy, shared by every parent.

``resilience/supervisor.py`` (one child, run-to-completion) and
``serve/workers.py`` (a pool of long-lived serving processes) watch
children the same three ways — crash (waitpid), hang (a heartbeat file
that stops advancing), resource leak (RSS past a cap) — and answer
failures the same way (capped deterministic backoff, streak reset on
progress, loud refusal when the failure is systematic). This module IS
that shared policy, extracted so the two parents cannot drift:

- ``backoff_delay`` — the capped exponential with deterministic jitter
  (seeded per attempt: reproducible in tests, decorrelated in a fleet);
- ``heartbeat_age`` — the hang clock: how long since the child last
  proved liveness, honoring the attempt boundary (a beat left by a
  PREVIOUS incarnation is not this child's liveness — until this
  attempt beats, age is measured from its own launch);
- ``rss_kb`` — the leak sense, read from ``/proc/<pid>/status`` (0 when
  unreadable: a child we cannot measure is not thereby a leaker);
- ``RetryPolicy`` — the failure-streak state machine: ``record_failure``
  returns the backoff delay for the next attempt or ``None`` when the
  budget is exhausted (the caller refuses loudly), and progress between
  failures restarts the streak so a long run is not doomed by N
  spread-out crashes.
"""

from __future__ import annotations

import os
import random

from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat

__all__ = ["backoff_delay", "heartbeat_age", "rss_kb", "RetryPolicy"]


def backoff_delay(failures: int, base_s: float, cap_s: float,
                  jitter: float, seed: int) -> float:
    """Capped exponential backoff with deterministic jitter: attempt k
    after ``failures`` consecutive failures sleeps
    ``min(cap, base * 2**(failures-1)) * (1 + jitter * u)`` with
    ``u ~ U[0, 1)`` drawn from ``Random(seed, failures)``."""
    if failures <= 0:
        return 0.0
    u = random.Random((int(seed) << 16) ^ int(failures)).random()
    return min(cap_s, base_s * 2 ** (failures - 1)) * (1.0 + jitter * u)


def heartbeat_age(heartbeat_path: str | None, t0_unix: float,
                  started_s: float) -> float | None:
    """Seconds since the watched child last proved liveness, or None
    when no heartbeat is configured (the caller then has no hang sense).

    The attempt boundary rule (shared by ``supervise`` and the worker
    pool): a beat whose payload predates this attempt's launch
    (``t0_unix``) belongs to a previous incarnation, so the age is
    ``started_s`` — time since THIS child launched — not the stale
    file's age."""
    if heartbeat_path is None:
        return None
    hb = read_heartbeat(heartbeat_path)
    stale = hb is None or hb["payload"].get("unix", 0) < t0_unix
    return started_s if stale else hb["age_s"]


def rss_kb(pid: int) -> int:
    """Resident set size of ``pid`` in kB from ``/proc/<pid>/status``,
    0 when unreadable (dead pid, non-Linux): an unmeasurable child must
    never read as a leaker."""
    try:
        with open(f"/proc/{int(pid)}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


class RetryPolicy:
    """Failure-streak accounting + backoff schedule for one supervised
    child (or one worker slot — each slot owns its own policy).

    ``record_failure(progress=...)`` bumps the streak and returns the
    backoff delay before the next attempt, or ``None`` when
    ``max_failures`` consecutive failures are reached — the caller must
    then refuse loudly instead of thrashing. ``progress`` is any
    monotonic achievement marker (the heartbeat's slot, a request
    counter): when it advances past the best any attempt reached, the
    streak restarts at 1 — the failure is environmental, not systematic.
    """

    def __init__(self, max_failures: int = 3, backoff_s: float = 1.0,
                 backoff_cap_s: float = 30.0, jitter: float = 0.25,
                 seed: int = 0):
        self.max_failures = int(max_failures)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.failures = 0
        self.total_failures = 0
        self.best_progress = None
        self.backoff_total_s = 0.0

    def record_failure(self, progress=None) -> float | None:
        """One failed attempt. Returns the delay to sleep before the
        next attempt, or None when the retry budget is exhausted."""
        self.failures += 1
        self.total_failures += 1
        if progress is not None and (self.best_progress is None
                                     or progress > self.best_progress):
            if self.best_progress is not None:
                # advancing between failures = flaky environment, not a
                # systematic fault; restart the streak
                self.failures = 1
            self.best_progress = progress
        if self.failures >= self.max_failures:
            return None
        delay = backoff_delay(self.failures, self.backoff_s,
                              self.backoff_cap_s, self.jitter, self.seed)
        self.backoff_total_s += delay
        return delay

    def record_success(self) -> None:
        """A healthy attempt completed (or a worker proved sustained
        liveness): the streak is over."""
        self.failures = 0

    @property
    def exhausted(self) -> bool:
        return self.failures >= self.max_failures
