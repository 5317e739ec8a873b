"""Serving chaos mode: seeded failure injection for the RPC tier.

The serving twin of ``scripts/chaos_fuzz.py``'s network chaos — every
injection is a pure function of (seed, occasion), so a chaos run is
replayable, and every injection maps to a real operational failure:

- **worker stalls** — a worker thread sleeps mid-request (GC pause, a
  page fault storm, a noisy neighbor): the queue backs up, admission
  control must shed honestly and hedged retries must route around it;
- **cache wipes at block boundaries** — the proof-path LRU is cleared
  exactly when a new view publishes (process restart, cache eviction
  storm): the very next sampling wave is all-miss, the single-flight
  stampede case;
- **burst windows** — 10x arrival-rate multipliers for the load
  generator (a viral moment);
- **slow-loris clients** — connections that dribble a frame
  byte-by-byte and never finish: they must only ever cost the server
  their own connection reader, never a worker slot;
- **backing faults** — a window where every backing-store access raises
  (disk dies, downstream store partition): the circuit breaker must
  trip, answer ``unavailable`` honestly, and probe its way closed again.

The acceptance bar under ALL of this: throughput may degrade, latency
may spike, requests may be shed — but every proof actually served still
verifies and every rejection is honest.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time

__all__ = ["FdExhaustSwarm", "ServeChaos", "SlowLorisSwarm"]


def _unit(seed: int, *parts) -> float:
    """Deterministic [0, 1) draw from (seed, parts) — the
    ``sim/faults.stateless_unit`` posture for serving chaos."""
    h = hashlib.sha256(
        b"serve-chaos" + seed.to_bytes(8, "little", signed=True)
        + "/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") / float(1 << 64)


class ServeChaos:
    """Seeded chaos schedule consulted by ``ServeFront`` at its hooks."""

    def __init__(self, seed: int = 0, stall_prob: float = 0.0,
                 stall_s: float = 0.05, wipe_prob: float = 0.0,
                 backing_fault_until: float | None = None,
                 clock=time.monotonic):
        self.seed = int(seed)
        self.stall_prob = float(stall_prob)
        self._stall_s = float(stall_s)
        self.wipe_prob = float(wipe_prob)
        # wall window (monotonic) during which backing access raises —
        # armed with ``fail_backing_for``
        self._backing_fault_until = backing_fault_until
        self.clock = clock
        self._stall_n = 0
        self._stall_windows: dict[int, list[tuple[float, float]]] = {}
        # process-level kill schedule: [fire_at, worker_id, fired]
        self._kill_sched: list[list] = []
        self._lock = threading.Lock()
        self.log: list[dict] = []

    # -- worker stalls ---------------------------------------------------------

    def arm_stalls(self, start: float, duration_s: float, n_stalls: int,
                   stall_s: float, workers: int) -> list[dict]:
        """Seeded wall-clock stall WINDOWS: worker w freezes for
        ``stall_s`` starting at a seeded offset inside [start, start +
        duration). Windows, not per-request draws — a per-request
        probability scales the injected damage with the arrival rate,
        which turns a 10x burst into a total outage instead of the
        'one worker went away for a while' failure it models."""
        planned = []
        for k in range(n_stalls):
            w = int(_unit(self.seed, "stall-worker", k) * workers)
            lo = start + _unit(self.seed, "stall-at", k) * max(
                duration_s - stall_s, 0.0)
            with self._lock:
                self._stall_windows.setdefault(w, []).append(
                    (lo, lo + stall_s))
            planned.append({"kind": "worker_stall_armed", "worker": w,
                            "at_s": round(lo - start, 3),
                            "stall_s": stall_s})
        with self._lock:
            self.log.extend(planned)
        return planned

    def stall_s(self, worker_id: int) -> float:
        """Seconds this worker must stall before its next request
        (0 almost always): the remainder of an armed window it is
        inside, or a seeded per-request draw when ``stall_prob`` is set
        (unit-test convenience)."""
        now = self.clock()
        with self._lock:
            for lo, hi in self._stall_windows.get(worker_id, ()):
                if lo <= now < hi:
                    self.log.append({"kind": "worker_stall",
                                     "worker": worker_id,
                                     "stall_s": round(hi - now, 4)})
                    return hi - now
        if self.stall_prob <= 0:
            return 0.0
        with self._lock:
            n = self._stall_n
            self._stall_n += 1
        if _unit(self.seed, "stall", worker_id, n) < self.stall_prob:
            with self._lock:
                self.log.append({"kind": "worker_stall",
                                 "worker": worker_id,
                                 "stall_s": self._stall_s})
            return self._stall_s
        return 0.0

    # -- process-level injections (the multi-process plane) --------------------

    def arm_worker_kills(self, start: float, duration_s: float,
                         n_kills: int, workers: int) -> list[dict]:
        """Seeded SIGKILL schedule against worker PROCESSES: kill k
        fires at a seeded offset inside [start, start + duration)
        against a seeded worker id. The pool's watch loop polls
        ``worker_kills_due`` and delivers the signal — chaos plans,
        the supervisor executes, so the kill shows up in the SAME
        interruption accounting as a real crash."""
        planned = []
        # seeded permutation, so n_kills <= workers hits DISTINCT
        # workers — the scenario bar is 'N live workers killed', which
        # a with-replacement draw can silently under-deliver
        order = sorted(range(workers),
                       key=lambda w: _unit(self.seed, "kill-order", w))
        with self._lock:
            for k in range(n_kills):
                w = order[k % workers]
                at = start + (0.15 + 0.7 * _unit(
                    self.seed, "kill-at", k)) * duration_s
                self._kill_sched.append([at, w, False])
                planned.append({"kind": "worker_kill_armed", "worker": w,
                                "at_s": round(at - start, 3)})
            self.log.extend(planned)
        return planned

    def worker_kills_due(self) -> list[int]:
        """Worker ids whose kill time has passed, each returned exactly
        once (the consumer SIGKILLs them)."""
        now = self.clock()
        due = []
        with self._lock:
            for item in self._kill_sched:
                if not item[2] and now >= item[0]:
                    item[2] = True
                    due.append(item[1])
                    self.log.append({"kind": "worker_kill_fired",
                                     "worker": item[1]})
        return due

    def wedge_windows(self, start_unix: float, duration_s: float,
                      n_wedges: int, wedge_s: float,
                      workers: int) -> dict[int, list[tuple[float, float]]]:
        """Seeded heartbeat-wedge windows in UNIX time, keyed by worker
        id — embedded into spawn specs (``spec["chaos"]["wedge_windows"]``)
        so the worker itself skips beats inside its window while still
        serving: the liveness lie the pool's hang detector must catch.
        Unix (not monotonic) time because the window crosses a process
        boundary; monotonic clocks do not agree across processes."""
        out: dict[int, list[tuple[float, float]]] = {}
        # draw wedge targets from the TAIL of the kill-order
        # permutation: kills + wedges <= workers then hit DISJOINT
        # workers, so each injection's detection path is exercised on
        # its own victim
        order = sorted(range(workers),
                       key=lambda w: _unit(self.seed, "kill-order", w))
        for k in range(n_wedges):
            w = order[workers - 1 - (k % workers)]
            lo = start_unix + _unit(self.seed, "wedge-at", k) * max(
                duration_s - wedge_s, 0.0)
            out.setdefault(w, []).append((lo, lo + wedge_s))
        with self._lock:
            self.log.append({"kind": "wedge_windows",
                             "workers": sorted(out)})
        return out

    # -- cache wipes on publish ------------------------------------------------

    def on_publish(self, front, view, version: int) -> None:
        """Block-boundary hook: seeded proof-cache wipe — the new block's
        first sampling wave then misses EVERYTHING at once."""
        if self.wipe_prob > 0 and _unit(self.seed, "wipe",
                                        version) < self.wipe_prob:
            front.das.proof_cache.clear()
            with self._lock:
                self.log.append({"kind": "cache_wipe", "version": version,
                                 "slot": int(view.slot)})

    # -- backing-store faults --------------------------------------------------

    def fail_backing_for(self, seconds: float) -> None:
        self._backing_fault_until = self.clock() + float(seconds)
        with self._lock:
            self.log.append({"kind": "backing_fault_window",
                             "seconds": float(seconds)})

    def maybe_backing_fault(self) -> None:
        until = self._backing_fault_until
        if until is not None and self.clock() < until:
            raise RuntimeError("chaos: backing store unavailable")

    # -- load-side helpers -----------------------------------------------------

    def burst_windows(self, duration_s: float, n_bursts: int = 1,
                      mult: float = 10.0,
                      width_frac: float = 0.1) -> tuple:
        """Seeded (t_lo, t_hi, mult) windows for the load generator."""
        out = []
        width = duration_s * width_frac
        for k in range(n_bursts):
            lo = _unit(self.seed, "burst", k) * (duration_s - width)
            out.append((lo, lo + width, mult))
        with self._lock:
            self.log.append({"kind": "burst_windows", "windows": out})
        return tuple(out)

    def summary(self) -> dict:
        with self._lock:
            log = list(self.log)
        kinds: dict[str, int] = {}
        for e in log:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        return {"seed": self.seed, "injections": kinds,
                "log_tail": log[-10:]}


class SlowLorisSwarm:
    """N connections that dribble one frame forever (until stopped).

    Each loris sends a valid length prefix claiming a large frame, then
    one byte every ``dribble_s`` — the attack that pins naive
    thread-per-request servers. The server's mid-frame read timeout must
    close these while real traffic keeps flowing.
    """

    def __init__(self, addr, n: int = 8, dribble_s: float = 0.5):
        self.addr = (addr[0], int(addr[1]))
        self.n = int(n)
        self.dribble_s = float(dribble_s)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.connected = 0
        self.closed_by_server = 0
        self._lock = threading.Lock()

    def _loris(self, k: int) -> None:
        try:
            sock = socket.create_connection(self.addr, timeout=2.0)
        except OSError:
            return
        with self._lock:
            self.connected += 1
        try:
            sock.sendall(struct.pack(">I", 1 << 20))  # promise 1 MiB...
            while not self._stop.is_set():
                sock.sendall(b"x")  # ...deliver a byte at a time
                if self._stop.wait(self.dribble_s):
                    break
        except OSError:
            with self._lock:
                self.closed_by_server += 1
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def start(self) -> None:
        for k in range(self.n):
            t = threading.Thread(target=self._loris, args=(k,),
                                 name=f"slow-loris-{k}", daemon=True)
            t.start()
            # start() runs once on the owning thread; the loris threads
            # never touch _threads
            self._threads.append(t)  # pev: ignore[PEV101]

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3.0)


class FdExhaustSwarm:
    """N connections opened at once and held idle — the fd/conn-slot
    exhaustion window. The server's ``max_connections`` cap must refuse
    the overflow at accept (``conn_rejected``) while ALREADY-established
    traffic keeps flowing; when the swarm releases, capacity returns.
    Nothing is ever sent, so no worker slot is ever at risk — only
    accept-side resources are under attack."""

    def __init__(self, addr, n: int = 256, hold_s: float = 2.0):
        self.addr = (addr[0], int(addr[1]))
        self.n = int(n)
        self.hold_s = float(hold_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.connected = 0
        self.refused = 0

    def _run(self) -> None:
        socks = []
        connected = refused = 0
        for _ in range(self.n):
            if self._stop.is_set():
                break
            try:
                socks.append(socket.create_connection(self.addr,
                                                      timeout=1.0))
                connected += 1
            # not a swallow: the refusal IS the datum this swarm exists
            # to count (the server shedding accepts under fd pressure)
            except OSError:  # pev: ignore[PEV005]
                refused += 1
        self.connected, self.refused = connected, refused
        self._stop.wait(self.hold_s)
        for s in socks:
            try:
                s.close()
            # closing an already-dead socket during teardown
            except OSError:  # pev: ignore[PEV005]
                pass

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="fd-exhaust", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
