"""Supervised auto-resume: run a child process until it finishes, or
until its failures exhaust the retry budget (DESIGN.md §18).

``supervise`` is the parent half of the self-healing contract. The
child half is any entry point that (a) autocheckpoints through
``CheckpointManager``, (b) beats a ``utils/watchdog.Heartbeat`` file
from inside its run loop, and (c) resumes from the latest *valid*
checkpoint when restarted (``resume_latest``). The parent then only
needs three senses:

- **crash**: the child exits nonzero (or dies to a signal — an OOM
  kill and a SIGKILL look identical from here, which is the point);
- **hang**: the heartbeat file stops advancing for ``hang_timeout_s``.
  This extends the watchdog's SIGALRM honesty note: an alarm cannot
  interrupt native code, but a *parent* watching a file's age can kill
  a child stuck inside an XLA compile loop just fine;
- **success**: exit 0.

Between failures the parent sleeps a capped exponential backoff with
deterministic jitter (seeded per attempt — reproducible in tests, still
decorrelated across a fleet). After ``max_failures`` consecutive
failures it REFUSES loudly (``SupervisorGaveUp``) instead of thrashing:
by then the failure is systematic, and retry N+1 only burns quota.

Every decision is emitted as a ``supervisor_*`` telemetry event
(append-mode ``EventBus`` when ``events_path`` is given, the global
sink otherwise) so ``scripts/run_report.py`` can reconstruct the
interruption/retry/goodput story offline.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

# the crash/hang/backoff POLICY lives in supervision.py, shared with the
# serving tier's WorkerPool (serve/workers.py) — this module is the
# one-child, run-to-completion parent built on it
from pos_evolution_tpu_torch.resilience.supervision import (
    RetryPolicy,
    backoff_delay,
    heartbeat_age,
)
from pos_evolution_tpu_torch.utils.watchdog import read_heartbeat

__all__ = ["SupervisorGaveUp", "backoff_delay", "supervise"]


class SupervisorGaveUp(RuntimeError):
    """The retry budget is exhausted; the failure is systematic."""


def _emit(bus, type_: str, **fields) -> None:
    if bus is not None:
        bus.emit(type_, **fields)
    else:
        from pos_evolution_tpu_torch.telemetry import emit_global
        emit_global(type_, **fields)


def supervise(build_argv, *, heartbeat_path: str | None = None,
              hang_timeout_s: float | None = None, max_failures: int = 3,
              backoff_s: float = 1.0, backoff_cap_s: float = 30.0,
              jitter: float = 0.25, seed: int = 0, env: dict | None = None,
              poll_s: float = 0.2, events_bus=None,
              on_attempt=None) -> dict:
    """Run ``build_argv(attempt) -> list[str]`` as a child process until
    one attempt exits 0; crash/hang attempts are retried from whatever
    the child's checkpoint store holds. Returns a summary dict::

        {"ok": True, "attempts": N,
         "interruptions": [{"attempt", "reason", "exit_code",
                            "wall_s", "last_heartbeat": {...}}, ...],
         "total_wall_s": ..., "backoff_s": ...}

    Raises ``SupervisorGaveUp`` after ``max_failures`` consecutive
    failed attempts (the summary rides on the exception as ``.summary``
    for the postmortem). ``on_attempt(attempt)`` is a test hook called
    before each launch.
    """
    t_start = time.perf_counter()
    interruptions: list[dict] = []
    policy = RetryPolicy(max_failures=max_failures, backoff_s=backoff_s,
                         backoff_cap_s=backoff_cap_s, jitter=jitter,
                         seed=seed)
    attempt = 0
    while True:
        if on_attempt is not None:
            on_attempt(attempt)
        argv = build_argv(attempt)
        _emit(events_bus, "supervisor_attempt", attempt=attempt,
              argv=[os.path.basename(argv[0])] + list(argv[1:]))
        t0 = time.perf_counter()
        t0_unix = time.time()
        proc = subprocess.Popen(argv, env=env)
        reason = None
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if heartbeat_path is not None and hang_timeout_s:
                # attempt-boundary rule (supervision.heartbeat_age): a
                # beat from a PREVIOUS attempt is not this child's
                # liveness — until this attempt beats, age is measured
                # from its own launch instead of the stale file
                age = heartbeat_age(heartbeat_path, t0_unix,
                                    time.perf_counter() - t0)
                if age > hang_timeout_s:
                    # no SIGTERM courtesy: a hung child may be wedged in
                    # native code and ignore it; the checkpoint store is
                    # crash-safe by construction, so SIGKILL is honest
                    proc.kill()
                    proc.wait()
                    rc = -signal.SIGKILL
                    reason = "hang"
                    break
            time.sleep(poll_s)
        wall = time.perf_counter() - t0
        if rc == 0:
            summary = {"ok": True, "attempts": attempt + 1,
                       "interruptions": interruptions,
                       "final_wall_s": round(wall, 3),
                       "backoff_s": round(policy.backoff_total_s, 3),
                       "total_wall_s": round(
                           time.perf_counter() - t_start, 3)}
            _emit(events_bus, "supervisor_done", **{
                k: v for k, v in summary.items() if k != "interruptions"},
                n_interruptions=len(interruptions))
            return summary
        hb = (read_heartbeat(heartbeat_path)
              if heartbeat_path is not None else None)
        hb_slot = ((hb or {}).get("payload") or {}).get("slot")
        delay = policy.record_failure(progress=hb_slot)
        record = {"attempt": attempt, "reason": reason or "crash",
                  "exit_code": rc, "wall_s": round(wall, 3),
                  "last_heartbeat": (hb or {}).get("payload")}
        interruptions.append(record)
        _emit(events_bus, "supervisor_interruption", **record)
        if delay is None:
            summary = {"ok": False, "attempts": attempt + 1,
                       "interruptions": interruptions,
                       "backoff_s": round(policy.backoff_total_s, 3),
                       "total_wall_s": round(
                           time.perf_counter() - t_start, 3)}
            _emit(events_bus, "supervisor_gaveup", attempts=attempt + 1,
                  consecutive_failures=policy.failures)
            err = SupervisorGaveUp(
                f"{policy.failures} consecutive failed attempts (last: "
                f"{record['reason']}, exit {rc}) — refusing to thrash; "
                f"inspect the checkpoint store and the child log")
            err.summary = summary
            raise err
        _emit(events_bus, "supervisor_backoff", failures=policy.failures,
              delay_s=round(delay, 3))
        print(f"# supervisor: attempt {attempt} {record['reason']} "
              f"(exit {rc}); retrying in {delay:.2f}s "
              f"[{policy.failures}/{max_failures} failures]",
              file=sys.stderr)
        time.sleep(delay)
        attempt += 1
