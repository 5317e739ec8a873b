"""Shared-memory view publication: serialize once, serve from N processes.

The multi-process serving plane's data seam (DESIGN.md §19, ROADMAP
item 3): the driver serializes each immutable ``ServeView`` exactly once
into a ``multiprocessing.shared_memory`` segment and publishes it with an
atomic generation bump; worker processes attach read-only and decode at
most once per generation — never a pickle per request, never a copy per
worker beyond the one decode. One segment carries three regions:

- **view payload** behind a *seqlock*: the writer bumps the generation
  counter to an odd value, writes the payload, bumps it even; a reader
  copies the payload and retries if the generation moved (or was odd)
  under it. Readers never block the writer and a torn read is
  detectable, not servable;
- **health board**: one slot per serving front (pid, seen generation,
  brownout flag, queue depth, request count, beat time) — single writer
  per slot, so fronts and the load balancer read each other's health
  without locks and brownout decisions can coordinate across processes;
- **lease table**: per-(block, blob) cross-process build leases — the
  process-level half of single-flight. A leader claims the lease (table
  mutations serialize through an ``fcntl`` lock file — kernel-released
  on death, so a SIGKILLed leader can never wedge the table), builds the
  blob's proofs once, spools them into a named side segment, and marks
  the lease done; waiters poll the 4-byte state word and attach the
  spool instead of re-running the backing build. Dead-leader takeover is
  pid-liveness at claim time.

The spool segments are GC'd two ways: a claimer that recycles a lease
slot unlinks the previous digest's spool, and the board OWNER unlinks
every live spool at ``close(unlink=True)`` — bounded residue, no
cross-process refcounting.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import struct
import threading
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np

from pos_evolution_tpu_torch.serve.state import ServeView

__all__ = ["ShmSidecar", "ShmViewBoard", "encode_view", "decode_view",
           "lease_digest"]

_MAGIC = b"PEVSHM1\x00"
_HEADER = struct.Struct("<8sQQQQ16x")       # magic, gen, payload_len,
                                            # n_fronts, n_lease_slots
_HEALTH = struct.Struct("<QQQQQdQ8x")       # pid, generation, brownout,
                                            # depth, requests, unix, shed
_LEASE = struct.Struct("<16sIId")           # digest, state, owner_pid, unix
LEASE_FREE, LEASE_BUILDING, LEASE_DONE = 0, 1, 2


_track_lock = threading.Lock()


def _open_shm(name: str | None = None, create: bool = False,
              size: int = 0) -> shared_memory.SharedMemory:
    """``SharedMemory`` WITHOUT resource-tracker registration.

    The 3.10 tracker registers every open (create AND attach,
    bpo-38119) and unlinks everything it knows at process exit — which
    would tear the board out from under every sibling when one worker
    exits cleanly. Unregistering after the fact is racy across the
    pool's shared tracker process (its name set is flat, so interleaved
    attach/untrack from two workers double-removes and the tracker
    spews KeyErrors at shutdown). Suppressing registration at
    construction sends the tracker nothing at all; lifetime is owned
    explicitly — the creating process unlinks at ``close``."""
    with _track_lock:
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name, create=create,
                                              size=size)
        finally:
            resource_tracker.register = orig


def _unlink_shm(shm) -> None:
    """``unlink`` for a segment opened via ``_open_shm``: 3.10's
    ``unlink()`` unconditionally unregisters from the tracker, which —
    since we never registered — makes the tracker process spew
    KeyErrors at shutdown. Suppress the unregister the same way."""
    with _track_lock:
        orig = resource_tracker.unregister
        resource_tracker.unregister = lambda *a, **k: None
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        finally:
            resource_tracker.unregister = orig


class ShmSidecar:
    """The decoded view's sidecar stand-in: exactly the two attributes
    the serving handlers touch (``.cells`` grid, ``.commitment``)."""

    __slots__ = ("cells", "commitment")

    def __init__(self, cells: np.ndarray, commitment: bytes):
        self.cells = cells
        self.commitment = commitment


def encode_view(view: ServeView) -> bytes:
    """One flat buffer: 4-byte meta length + JSON meta + raw blobs
    (update bytes, then each sidecar's cell grid + commitment in meta
    order). Scalars ride the JSON; bulk bytes are raw slices — decode
    is a handful of ``np.frombuffer`` copies, not a pickle walk."""
    blobs: list[bytes] = []
    meta_cars = []
    update = view.update_ssz or b""
    blobs.append(update)
    for root, cars in view.sidecars.items():
        entry = {"root": root.hex(), "cars": []}
        for car in cars:
            grid = np.ascontiguousarray(car.cells, dtype=np.uint8)
            entry["cars"].append({"shape": list(grid.shape)})
            blobs.append(grid.tobytes())
            blobs.append(bytes(car.commitment))
        meta_cars.append(entry)
    meta = {
        "slot": int(view.slot),
        "head_root": view.head_root.hex(),
        "head_slot": int(view.head_slot),
        "justified_epoch": int(view.justified_epoch),
        "justified_root": view.justified_root.hex(),
        "finalized_epoch": int(view.finalized_epoch),
        "finalized_root": view.finalized_root.hex(),
        "update_len": len(update),
        "update_root": (view.update_root.hex()
                        if view.update_root else None),
        "n_cells": int(view.n_cells),
        "sidecars": meta_cars,
    }
    mb = json.dumps(meta, separators=(",", ":")).encode()
    return struct.pack("<I", len(mb)) + mb + b"".join(blobs)


def decode_view(buf: bytes) -> ServeView:
    (mlen,) = struct.unpack_from("<I", buf, 0)
    meta = json.loads(buf[4:4 + mlen])
    off = 4 + mlen
    update = bytes(buf[off:off + meta["update_len"]]) or None
    off += meta["update_len"]
    sidecars: dict = {}
    for entry in meta["sidecars"]:
        cars = []
        for car in entry["cars"]:
            n, w = car["shape"]
            grid = np.frombuffer(buf, dtype=np.uint8, count=n * w,
                                 offset=off).reshape(n, w).copy()
            off += n * w
            commitment = bytes(buf[off:off + 32])
            off += 32
            cars.append(ShmSidecar(grid, commitment))
        sidecars[bytes.fromhex(entry["root"])] = cars
    return ServeView(
        slot=meta["slot"],
        head_root=bytes.fromhex(meta["head_root"]),
        head_slot=meta["head_slot"],
        justified_epoch=meta["justified_epoch"],
        justified_root=bytes.fromhex(meta["justified_root"]),
        finalized_epoch=meta["finalized_epoch"],
        finalized_root=bytes.fromhex(meta["finalized_root"]),
        update_ssz=update,
        update_root=(bytes.fromhex(meta["update_root"])
                     if meta["update_root"] else None),
        sidecars=sidecars,
        n_cells=meta["n_cells"],
    )


def lease_digest(key) -> bytes:
    """16-byte stable digest of a lease key tuple (e.g. ``("blob_proofs",
    block_root, blob)``) — the lease table's identity."""
    h = hashlib.sha256()
    for part in key:
        p = part if isinstance(part, bytes) else str(part).encode()
        h.update(struct.pack("<I", len(p)))
        h.update(p)
    return h.digest()[:16]


class ShmViewBoard:
    """One shared segment: seqlock'd view payload + health board +
    lease table. ``create`` on the owner (publisher / pool) side,
    ``attach`` in every worker."""

    def __init__(self, shm, lock_path: str, owner: bool,
                 n_fronts: int, n_lease_slots: int, capacity: int):
        self._shm = shm
        self._buf = shm.buf
        self.name = shm.name
        self.lock_path = lock_path
        self.owner = owner
        self.n_fronts = n_fronts
        self.n_lease_slots = n_lease_slots
        self.capacity = capacity
        self._health_off = _HEADER.size
        self._lease_off = self._health_off + n_fronts * _HEALTH.size
        self._payload_off = self._lease_off + n_lease_slots * _LEASE.size
        self._gen_cache = -1
        self._view_cache: ServeView | None = None
        self._lock_fd: int | None = None
        # flock excludes other open files only, not the threads sharing
        # this one: they take this lock first, which also keeps two first
        # callers from each opening the lock file (the lock held through
        # one descriptor, released through the other, never released)
        self._tlock = threading.Lock()
        self.publishes = 0
        self.read_retries = 0

    # -- lifecycle -------------------------------------------------------------

    @classmethod
    def create(cls, lock_path: str, capacity: int = 1 << 20,
               n_fronts: int = 16, n_lease_slots: int = 128,
               name: str | None = None) -> "ShmViewBoard":
        size = (_HEADER.size + n_fronts * _HEALTH.size
                + n_lease_slots * _LEASE.size + capacity)
        shm = _open_shm(name=name, create=True, size=size)
        shm.buf[:size] = b"\x00" * size
        _HEADER.pack_into(shm.buf, 0, _MAGIC, 0, 0, n_fronts,
                          n_lease_slots)
        # the lock file backs fcntl.flock for lease-table mutations;
        # created by the owner so workers can open it read-write
        with open(lock_path, "w") as f:
            f.write(shm.name + "\n")
        return cls(shm, lock_path, owner=True, n_fronts=n_fronts,
                   n_lease_slots=n_lease_slots, capacity=capacity)

    @classmethod
    def attach(cls, name: str, lock_path: str) -> "ShmViewBoard":
        shm = _open_shm(name=name)
        magic, _gen, _plen, n_fronts, n_lease = _HEADER.unpack_from(
            shm.buf, 0)
        assert magic == _MAGIC, f"not a ShmViewBoard segment: {name}"
        capacity = (shm.size - _HEADER.size - n_fronts * _HEALTH.size
                    - n_lease * _LEASE.size)
        return cls(shm, lock_path, owner=False, n_fronts=int(n_fronts),
                   n_lease_slots=int(n_lease), capacity=int(capacity))

    def close(self, unlink: bool | None = None) -> None:
        unlink = self.owner if unlink is None else unlink
        if unlink:
            self.gc_spools()
        if self._lock_fd is not None:
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = None
        # drop every exported view of the buffer before closing the
        # mmap, or SharedMemory.close raises BufferError
        self._buf = None
        self._view_cache = None
        try:
            self._shm.close()
        except BufferError:
            pass
        if unlink:
            _unlink_shm(self._shm)

    # -- seqlock'd view payload ------------------------------------------------

    def _gen(self) -> int:
        return struct.unpack_from("<Q", self._buf, 8)[0]

    def _set_gen(self, g: int) -> None:
        struct.pack_into("<Q", self._buf, 8, g)

    def publish(self, view: ServeView) -> int:
        """Serialize ONCE, publish by generation bump. Returns the new
        (even) generation. Owner-side only — one writer by contract."""
        payload = encode_view(view)
        if len(payload) > self.capacity:
            raise ValueError(
                f"encoded view ({len(payload)} B) exceeds the board's "
                f"payload capacity ({self.capacity} B)")
        g = self._gen()
        self._set_gen(g + 1)            # odd: writer in the payload
        struct.pack_into("<Q", self._buf, 16, len(payload))
        self._buf[self._payload_off:self._payload_off + len(payload)] = \
            payload
        self._set_gen(g + 2)            # even: consistent again
        self.publishes += 1
        return g + 2

    def generation(self) -> int:
        """The current published generation (0 = nothing published)."""
        return self._gen()

    def current(self) -> tuple[int, ServeView | None]:
        """(generation, view) — decoded at most once per generation per
        attached process; seqlock retry on a concurrent publish."""
        for _ in range(1000):
            g1 = self._gen()
            if g1 == 0:
                return 0, None
            if g1 == self._gen_cache:
                return g1, self._view_cache
            if g1 & 1:
                self.read_retries += 1
                time.sleep(0.0002)
                continue
            (plen,) = struct.unpack_from("<Q", self._buf, 16)
            payload = bytes(
                self._buf[self._payload_off:self._payload_off + plen])
            if self._gen() != g1:
                self.read_retries += 1
                continue
            view = decode_view(payload)
            self._gen_cache, self._view_cache = g1, view
            return g1, view
        raise RuntimeError("seqlock read never stabilized — is the "
                           "publisher wedged mid-write?")

    # -- health board ----------------------------------------------------------

    def write_health(self, front_id: int, generation: int = 0,
                     brownout: bool = False, depth: int = 0,
                     requests: int = 0, shed: int = 0) -> None:
        """Publish one front's health into its own slot (single writer
        per slot — torn reads are tolerable staleness, not corruption)."""
        assert 0 <= front_id < self.n_fronts
        _HEALTH.pack_into(self._buf,
                          self._health_off + front_id * _HEALTH.size,
                          os.getpid(), int(generation), int(brownout),
                          int(depth), int(requests), time.time(),
                          int(shed))

    def clear_health(self, front_id: int) -> None:
        """Tombstone a slot: the SUPERVISOR calls this the instant it
        sees a worker die, so routing reacts immediately instead of
        waiting out heartbeat staleness (a dead front kept 'live' for
        STALE_S is a window of connection refusals)."""
        assert 0 <= front_id < self.n_fronts
        _HEALTH.pack_into(self._buf,
                          self._health_off + front_id * _HEALTH.size,
                          0, 0, 0, 0, 0, 0.0, 0)

    def read_health(self) -> list[dict]:
        """Every occupied health slot, as dicts with ``age_s``."""
        now = time.time()
        out = []
        for i in range(self.n_fronts):
            pid, gen, brown, depth, req, unix, shed = _HEALTH.unpack_from(
                self._buf, self._health_off + i * _HEALTH.size)
            if pid == 0:
                continue
            out.append({"front": i, "pid": int(pid),
                        "generation": int(gen),
                        "brownout": bool(brown), "depth": int(depth),
                        "requests": int(req), "shed": int(shed),
                        "age_s": max(now - unix, 0.0)})
        return out

    def brownout_fraction(self) -> float:
        """Fraction of live fronts currently browned out — the
        cross-front overload signal (a front whose siblings are all
        shedding should not wait for its own queue to prove it)."""
        rows = [r for r in self.read_health() if r["age_s"] < 5.0]
        if not rows:
            return 0.0
        return sum(1 for r in rows if r["brownout"]) / len(rows)

    # -- lease table (cross-process single-flight) -----------------------------

    def _flock(self):
        self._tlock.acquire()
        try:
            if self._lock_fd is None:
                self._lock_fd = os.open(self.lock_path, os.O_RDWR)
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX)
        except BaseException:
            self._tlock.release()
            raise
        return self._lock_fd

    def _funlock(self) -> None:
        try:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)
        finally:
            self._tlock.release()

    def _lease_slot(self, i: int) -> tuple[bytes, int, int, float]:
        return _LEASE.unpack_from(self._buf,
                                  self._lease_off + i * _LEASE.size)

    def _write_lease(self, i: int, digest: bytes, state: int,
                     pid: int) -> None:
        _LEASE.pack_into(self._buf, self._lease_off + i * _LEASE.size,
                         digest, state, pid, time.time())

    @staticmethod
    def _alive(pid: int) -> bool:
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        return True

    def spool_name(self, digest: bytes) -> str:
        return f"{self.name}_sp_{digest.hex()[:12]}"

    def lease_acquire(self, digest: bytes) -> tuple[str, int]:
        """(role, slot): role is ``"lead"`` (this process must build),
        ``"wait"`` (a live leader is building — poll the slot), or
        ``"done"`` (the spool already holds the build). A lease whose
        owner died mid-build is taken over by the claimant — the
        fcntl file lock serializes the table walk, and the kernel
        releases it however the holder dies."""
        me = os.getpid()
        self._flock()
        try:
            free = None
            for i in range(self.n_lease_slots):
                d, state, pid, _unix = self._lease_slot(i)
                if state != LEASE_FREE and d == digest:
                    if state == LEASE_DONE:
                        return "done", i
                    if self._alive(pid):
                        return "wait", i
                    # dead leader: take the build over
                    self._write_lease(i, digest, LEASE_BUILDING, me)
                    return "lead", i
                if free is None and state == LEASE_FREE:
                    free = i
            if free is None:
                # table full: recycle the stalest DONE slot (its spool
                # is garbage for the current head anyway); unlink that
                # digest's spool so the name can be reborn later
                oldest, oldest_unix = None, float("inf")
                for i in range(self.n_lease_slots):
                    d, state, pid, unix = self._lease_slot(i)
                    if state == LEASE_DONE and unix < oldest_unix:
                        oldest, oldest_unix = i, unix
                if oldest is None:
                    # every slot mid-build (pathological): behave as a
                    # lone builder rather than deadlock the table
                    return "lead", -1
                d, _s, _p, _u = self._lease_slot(oldest)
                self._unlink_spool(d)
                free = oldest
            self._write_lease(free, digest, LEASE_BUILDING, me)
            return "lead", free
        finally:
            self._funlock()

    def lease_state(self, slot: int, digest: bytes) -> tuple[int, int]:
        """(state, owner_pid) of ``slot`` if it still holds ``digest``
        (LEASE_FREE otherwise) — the waiters' lock-free poll."""
        if slot < 0:
            return LEASE_FREE, 0
        d, state, pid, _unix = self._lease_slot(slot)
        if d != digest:
            return LEASE_FREE, 0
        return state, pid

    def lease_done(self, slot: int, digest: bytes) -> None:
        if slot < 0:
            return
        self._flock()
        try:
            self._write_lease(slot, digest, LEASE_DONE, os.getpid())
        finally:
            self._funlock()

    def lease_abort(self, slot: int, digest: bytes) -> None:
        """The leader's build failed: free the lease so the next miss
        elects a fresh leader instead of waiting on a corpse."""
        if slot < 0:
            return
        self._flock()
        try:
            d, state, pid, _unix = self._lease_slot(slot)
            if d == digest and pid == os.getpid():
                self._write_lease(slot, b"\x00" * 16, LEASE_FREE, 0)
        finally:
            self._funlock()

    # -- proof spools ----------------------------------------------------------

    def spool_write(self, digest: bytes, built: dict) -> None:
        """Serialize one blob's built proofs ({cell: (cell_bytes,
        branch)}) into the digest's named segment, so waiters populate
        their per-process LRU without re-running the backing build."""
        n = len(built)
        cells = np.stack([np.asarray(built[c][0], dtype=np.uint8)
                          for c in range(n)])
        branches = np.stack([np.asarray(built[c][1], dtype=np.uint8)
                             for c in range(n)])
        header = struct.pack("<QQQQ", n, cells.shape[1],
                             branches.shape[1], branches.shape[2])
        payload = header + cells.tobytes() + branches.tobytes()
        try:
            sp = _open_shm(name=self.spool_name(digest),
                           create=True, size=len(payload))
        except FileExistsError:
            # a recycled lease slot's spool name resurrected before its
            # unlink — overwrite in place (sizes match by construction
            # for one grid geometry; if not, unlink and recreate)
            sp = _open_shm(name=self.spool_name(digest))
            if sp.size < len(payload):
                sp.close()
                _unlink_shm(_open_shm(name=self.spool_name(digest)))
                sp = _open_shm(name=self.spool_name(digest),
                               create=True, size=len(payload))
        sp.buf[:len(payload)] = payload
        sp.close()

    def spool_read(self, digest: bytes) -> dict | None:
        """Decode the digest's spool into {cell: (cell_bytes, branch)}
        (copies — the caller's LRU owns the arrays), or None when the
        spool vanished (treat as a fresh miss)."""
        try:
            sp = _open_shm(name=self.spool_name(digest))
        except FileNotFoundError:
            return None
        try:
            n, w, depth, sib = struct.unpack_from("<QQQQ", sp.buf, 0)
            off = 32
            cells = np.frombuffer(sp.buf, dtype=np.uint8, count=n * w,
                                  offset=off).reshape(n, w).copy()
            off += n * w
            branches = np.frombuffer(
                sp.buf, dtype=np.uint8, count=n * depth * sib,
                offset=off).reshape(n, depth, sib).copy()
            return {c: (cells[c], branches[c]) for c in range(int(n))}
        finally:
            sp.close()

    def _unlink_spool(self, digest: bytes) -> None:
        try:
            sp = _open_shm(name=self.spool_name(digest))
        except FileNotFoundError:
            return
        sp.close()
        _unlink_shm(sp)

    def gc_spools(self) -> int:
        """Unlink every non-free lease's spool (owner-side, at close)."""
        n = 0
        for i in range(self.n_lease_slots):
            d, state, _pid, _unix = self._lease_slot(i)
            if state != LEASE_FREE:
                self._unlink_spool(d)
                n += 1
        return n
