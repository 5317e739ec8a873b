"""Supervised execution with commit-on-arrival partial results.

Long device benches die in ways an in-process try/except cannot always
catch (the round-5 casualty: an LLVM compile OOM killed config #3 chunk 4
and took every completed chunk's number with it). The watchdog's answer is
twofold:

- **commit-on-arrival**: every completed step's result is atomically
  written to a JSON file *immediately*, so whatever kills the process
  later cannot un-measure what already finished;
- **supervision**: each step runs under an optional wall-clock timeout
  (SIGALRM, main-thread only) with bounded retries + exponential backoff;
  a step that still fails is recorded as an *incident* in the same JSON
  and the harness moves on — benches exit 0 with partial results instead
  of dying with none.

Timeout honesty: SIGALRM handlers run between Python bytecodes, so the
timeout interrupts host-side Python hangs but NOT a hang inside native
code (an XLA/LLVM compile loop never yields to the handler until it
returns). For that class of death — OOM kills included — the defense is
commit-on-arrival plus an *external* supervisor (the shell's `timeout`,
a CI step limit): whatever kills the process, the JSON survives.

JSON format (documented in BUILD_NOTES.md):

    {"tag": "...", "started_unix": ..., "updated_unix": ...,
     "completed": {"<step>": <result>, ...},
     "incidents": [{"step", "attempt", "error", "elapsed_s", "unix"}, ...]}
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time


class WatchdogTimeout(Exception):
    """A supervised step exceeded its wall-clock budget."""


# -- run-loop heartbeats (ISSUE 10) --------------------------------------------
#
# The SIGALRM supervision above wraps bench STEPS; a long simulation run
# needs liveness visible from OUTSIDE the process (a hang inside native
# code never returns to any in-process handler, and an OOM-killed
# process answers nothing). The heartbeat is the watchdog's file-based
# leg: the run loop beats once per slot, and the resilience supervisor
# (pos_evolution_tpu/resilience/supervisor.py) kills + resumes a child
# whose heartbeat file stops advancing.

class Heartbeat:
    """Atomic single-file heartbeat: each ``beat`` replaces the file
    with ``{"unix": <now>, ...fields}`` via write + rename, so a reader
    never sees a torn payload and the previous beat survives a kill
    mid-write (the same posture as ``Watchdog.commit``)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self.beats = 0

    def beat(self, **fields) -> None:
        payload = {"unix": round(time.time(), 3), "pid": os.getpid(),
                   **fields}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        os.replace(tmp, self.path)
        self.beats += 1


def read_heartbeat(path: str) -> dict | None:
    """``{"age_s": <seconds since the last beat>, "payload": {...}}``,
    or None when the file does not exist yet (a child that has not
    reached its run loop is not hung — the supervisor falls back to
    time-since-launch). A torn/unparseable file reads as None too: the
    writer is atomic, so that means no beat has landed."""
    try:
        with open(os.fspath(path)) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return {"age_s": max(time.time() - float(payload.get("unix", 0.0)), 0.0),
            "payload": payload}


def _can_arm(timeout_s) -> bool:
    """Whether a step timeout can actually be armed here: a timeout was
    requested, the platform has SIGALRM, we are on the main thread, and
    no OUTER supervision timer is already running (a nested Watchdog —
    bench_all's config3b step calls bench_config3_real.run(), which has
    its own — must defer to the enclosing timer, not clobber it)."""
    return (bool(timeout_s) and hasattr(signal, "SIGALRM")
            and threading.current_thread() is threading.main_thread()
            and signal.getitimer(signal.ITIMER_REAL)[0] == 0)


def _call_with_timeout(fn, args, kwargs, timeout_s):
    """Run ``fn`` under SIGALRM. Falls back to an unsupervised call when
    no timeout is requested, off the main thread, on platforms without
    SIGALRM, or under an enclosing timer — supervision degrades, it never
    blocks the work."""
    if not _can_arm(timeout_s):
        return fn(*args, **kwargs)

    def _alarm(signum, frame):
        raise WatchdogTimeout(f"step exceeded {timeout_s}s")

    old_handler = signal.signal(signal.SIGALRM, _alarm)
    signal.setitimer(signal.ITIMER_REAL, timeout_s)
    try:
        return fn(*args, **kwargs)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)


class Watchdog:
    """Commit-on-arrival step runner for bench harnesses.

    ``path=None`` keeps everything in memory (tests, ad-hoc runs); with a
    path every state change lands on disk via atomic rename, so a crash at
    ANY point leaves a parseable JSON of what completed before it."""

    def __init__(self, path: str | None = None, tag: str = "",
                 timeout_s: float | None = None, retries: int = 0,
                 backoff_s: float = 1.0):
        self.path = path
        self.tag = tag
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.completed: dict[str, object] = {}
        self.incidents: list[dict] = []
        self._started = time.time()
        # NO commit here: the previous run's partial file is exactly the
        # evidence commit-on-arrival exists to preserve — clobbering it
        # with an empty summary before this run completes anything would
        # re-lose it on a retry that dies early. First write happens at
        # the first step completion or incident.

    @classmethod
    def from_env(cls, tag: str, default_path: str,
                 timeout_s: float | None = None) -> "Watchdog":
        """The bench harnesses' shared env contract in one place:
        ``POS_BENCH_PARTIAL`` overrides the partial-results path and
        ``POS_BENCH_STEP_TIMEOUT`` (seconds; 0/unset = off) arms the
        per-step timeout unless the caller passes an explicit one."""
        if timeout_s is None:
            timeout_s = float(os.environ.get("POS_BENCH_STEP_TIMEOUT",
                                             "0")) or None
        return cls(path=os.environ.get("POS_BENCH_PARTIAL", default_path),
                   tag=tag, timeout_s=timeout_s)

    # -- steps -----------------------------------------------------------------

    def step(self, name: str, fn, *args, timeout_s: float | None = None,
             retries: int | None = None, default=None, **kwargs):
        """Run one supervised step. On success the result is recorded
        under ``name`` and committed. On failure (exception or timeout)
        the attempt is retried up to ``retries`` times with exponential
        backoff; if all attempts fail the incident is recorded, committed,
        and ``default`` is returned — the caller keeps going."""
        timeout = self.timeout_s if timeout_s is None else timeout_s
        attempts = (self.retries if retries is None else retries) + 1
        for attempt in range(attempts):
            t0 = time.time()
            armed = _can_arm(timeout)
            try:
                value = _call_with_timeout(fn, args, kwargs, timeout)
            except Exception as e:
                if isinstance(e, WatchdogTimeout) and not armed:
                    raise   # an ENCLOSING supervisor's alarm, not ours —
                            # let it unwind to the step that owns it
                incident = {
                    "step": name,
                    "attempt": attempt,
                    "error": f"{type(e).__name__}: {e}"[:400],
                    "elapsed_s": round(time.time() - t0, 3),
                    "unix": round(time.time(), 3),
                }
                self.incidents.append(incident)
                self.commit()
                from pos_evolution_tpu_torch.telemetry import emit_global
                emit_global("watchdog_incident", tag=self.tag,
                            retries_left=attempts - attempt - 1, **incident)
                if attempt + 1 < attempts:
                    time.sleep(self.backoff_s * 2 ** attempt)
                continue
            self.completed[name] = value
            self.commit()
            return value
        return default

    def failed(self, name: str) -> bool:
        return name not in self.completed and any(
            i["step"] == name for i in self.incidents)

    # -- persistence -----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "tag": self.tag,
            "started_unix": round(self._started, 3),
            "updated_unix": round(time.time(), 3),
            "completed": self.completed,
            "incidents": self.incidents,
        }

    def commit(self) -> None:
        """Atomically persist the current summary (write + rename, so a
        kill mid-commit leaves the previous consistent file in place)."""
        if self.path is None:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.summary(), f, indent=1, default=repr)
            f.write("\n")
        os.replace(tmp, self.path)
