"""Single-flight: concurrent cache misses for one key build ONCE.

The stampede the serving tier must survive: a new block is published,
every sampling client's next request misses the proof-path cache for the
same (block, blob), and — without suppression — each concurrent requester
re-runs the same backing-scheme branch build. ``SingleFlight.do`` lets
the FIRST caller per key run the build while every concurrent caller
blocks on the leader's result (value or exception, shared either way).

The flight entry is removed once the leader finishes, so a LATER call
with the same key builds again — single-flight is stampede suppression,
not a cache; pair it with one (the leader's job is to populate it).

Lives in ``utils/`` (not ``serve/``) on purpose: ``das/server.py`` needs
it too, and ``serve/`` already imports from ``das/`` — this is the
neutral ground that keeps the dependency one-directional.
"""

from __future__ import annotations

import threading
import time

__all__ = ["SingleFlight", "ProcessFlight"]


class _Flight:
    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error: BaseException | None = None


class SingleFlight:
    """Per-key call deduplication for concurrent builders."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}
        # leaders actually ran the build; waits piggybacked on one
        self.leads = 0
        self.waits = 0

    def do(self, key, fn):
        """Run ``fn()`` once per concurrent set of callers of ``key``;
        every caller gets the leader's result (or its exception)."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
                self.leads += 1
            else:
                leader = False
                self.waits += 1
        if leader:
            try:
                flight.value = fn()
            except BaseException as e:  # share failures too: every
                flight.error = e        # waiter must see the same verdict
                raise
            finally:
                flight.done.set()
                with self._lock:
                    self._flights.pop(key, None)
        else:
            flight.done.wait()
            if flight.error is not None:
                raise flight.error
        return flight.value


class ProcessFlight:
    """Single-flight across PROCESSES: thread dedupe in front of a
    cross-process build lease (``serve/shm.ShmViewBoard``'s lease
    table + proof spools).

    The two-layer shape mirrors the cache story (one per-process LRU,
    one shared build): within a process, concurrent callers of one key
    collapse through a plain ``SingleFlight``; the surviving caller then
    claims the key's lease in the shared segment. Exactly one process
    per concurrent set becomes the **leader** and runs ``fn()`` (the
    real backing build); every other process **waits** on the lease's
    4-byte state word and absorbs the leader's spooled result instead
    of rebuilding — which is what keeps the global build count at one
    per (block, blob) however many processes stampede.

    Failure posture: a leader that dies mid-build (SIGKILL included)
    never wedges waiters — the lease's owner pid goes dead, the next
    claimant takes the build over. A waiter that outlives
    ``timeout_s`` falls back to building locally: duplicate work over
    a wedged request, correctness over dedupe.
    """

    def __init__(self, board, poll_s: float = 0.002,
                 timeout_s: float = 10.0):
        self.board = board
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self._local = SingleFlight()
        self.leads = 0          # builds this process actually ran
        self.cross_waits = 0    # builds absorbed from another process
        self.takeovers = 0      # dead-leader leases taken over
        self.fallbacks = 0      # waits that timed out into local builds
    # DasServer passes the cache-absorb callback only to flights that
    # can return another process's build
    wants_absorb = True

    @property
    def waits(self) -> int:
        return self._local.waits + self.cross_waits

    def _lead(self, fn, digest, slot):
        self.leads += 1
        try:
            built = fn()
        except BaseException:
            # free the lease: the NEXT miss elects a fresh leader
            # instead of waiting on this failure
            self.board.lease_abort(slot, digest)
            raise
        if slot >= 0:
            self.board.spool_write(digest, built)
            self.board.lease_done(slot, digest)
        return built

    def do(self, key, fn, absorb=None):
        """Run ``fn()`` once per concurrent set of callers of ``key``
        ACROSS processes. ``absorb(built)`` is called (when given) on a
        result that arrived from another process's spool, so the caller
        can populate its per-process cache without counting a build."""
        from pos_evolution_tpu_torch.serve.shm import (
            LEASE_BUILDING,
            LEASE_DONE,
            lease_digest,
        )

        def _cross():
            digest = lease_digest(key)
            deadline = time.monotonic() + self.timeout_s
            while True:
                role, slot = self.board.lease_acquire(digest)
                if role == "lead":
                    return self._lead(fn, digest, slot)
                if role == "done":
                    built = self.board.spool_read(digest)
                    if built is None:
                        # spool GC'd under a stale DONE lease: build
                        # locally rather than loop on a ghost
                        return self._lead(fn, digest, -1)
                    self.cross_waits += 1
                    if absorb is not None:
                        absorb(built)
                    return built
                # role == "wait": poll the lease's state word
                while True:
                    state, pid = self.board.lease_state(slot, digest)
                    if state == LEASE_DONE:
                        break
                    if state != LEASE_BUILDING \
                            or not self.board._alive(pid):
                        self.takeovers += 1
                        break  # freed or dead leader: re-acquire
                    if time.monotonic() > deadline:
                        self.fallbacks += 1
                        return self._lead(fn, digest, -1)
                    time.sleep(self.poll_s)
                if state == LEASE_DONE:
                    built = self.board.spool_read(digest)
                    if built is not None:
                        self.cross_waits += 1
                        if absorb is not None:
                            absorb(built)
                        return built
                # fell out without a result: re-acquire (takeover path)

        return self._local.do(key, _cross)
