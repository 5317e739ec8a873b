"""Preemption-tolerant checkpoint store (port of
``pos_evolution_tpu/resilience/manager.py``: the same layout, manifest,
atomic protocol, retention, quarantine and async writer).

A checkpoint here is a *directory* of payload files plus a
``manifest.json`` carrying a per-file sha256, the byte counts, and the
run's configuration fingerprint. Three invariants make it safe to kill
the writer at ANY instruction:

- **atomicity**: every step is staged under ``.tmp-step_N-<pid>``,
  every file fsync'd, then the directory renamed into place — a crash
  mid-write leaves only a tmp directory that the next manager sweep
  removes; a visible ``step_N`` directory is always complete;
- **verifiability**: ``load``/``validate`` recompute every file's
  sha256 against the manifest and check the fingerprint, so a torn,
  bit-flipped, or doctored checkpoint is *refused with a reason*, never
  half-loaded;
- **quarantine, not deletion**: a checkpoint that fails validation (or
  that an ``IntegrityGuard`` implicates) is renamed under
  ``quarantine/`` — evidence for the postmortem — and ``latest_valid``
  rolls past it to the newest step that still verifies.

**Async mode** is what keeps autocheckpointing out of the epoch loop's
critical path: ``save`` hands the payload (bytes, or a zero-arg
callable that produces them — the dense driver's gather-then-compress
split) to a single background writer thread and returns. Staleness is
bounded by construction: the queue holds at most ONE pending step, so
a caller checkpointing faster than the disk blocks on the *previous*
save — at any crash instant, at most one interval plus one in-flight
step is lost. The time the caller actually spent blocked
(``blocked_s``) vs the work the thread absorbed (``background_s``) is
tracked in ``stats()`` so the overlap is measured, not assumed.

The ``"merkle"`` digest hashes on a device: the manager's ``backend``
(a backend object; the drivers pass their own), or the saving thread's
backend when it has none. The writer thread gets the backend object the
caller pinned at ``save``, never a name that it would resolve anew. On
a CUDA device every level goes through kernel K2, and a build or launch
failure raises, when written and when validated: it is never taken for
a corrupt step, and the digest never falls back to ``"sha256"``.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
import time
from contextlib import nullcontext

MANIFEST_VERSION = 1
_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointCorruption(Exception):
    """A checkpoint failed validation (torn file, checksum mismatch,
    missing manifest, or a configuration fingerprint that does not match
    the run trying to load it)."""


class FingerprintMismatch(CheckpointCorruption):
    """The checkpoint is internally consistent but belongs to a
    different run shape. Refused, but NOT quarantined: the bytes are
    somebody's good checkpoint, just not this run's."""


def _sha256(data: bytes, backend=None) -> str:
    return hashlib.sha256(data).hexdigest()


def _merkle_hex(data: bytes, backend) -> str:
    """Merkle payload digest (``ops/merkle_device.DIGEST_ALGO``): the
    device-portable checksum, 32-byte chunks merkleized on ``backend``'s
    device (K2 on CUDA, its plain version on the CPU), byte length mixed
    in. Validation recomputes on the loading manager's device: the same
    hex on every device, and the JAX package's."""
    from pos_evolution_tpu_torch.ops.merkle_device import digest_bytes
    return digest_bytes(data, backend.device).hex()


_DIGESTS = {"sha256": _sha256, "merkle": _merkle_hex}


def _timed_digest(algo: str, data: bytes, backend) -> tuple[str, dict]:
    """``(hex, record)``: one payload's digest, with its ms and, for the
    merkle digest, the kernel launches this thread made for it."""
    if algo == "merkle":
        from pos_evolution_tpu_torch.ops.kernels import thread_launches
        counting = thread_launches()
    else:
        counting = nullcontext({})
    t0 = time.perf_counter()
    with counting as counted:
        hexd = _DIGESTS[algo](data, backend)
    return hexd, {"bytes": len(data), "digest": algo,
                  "digest_ms": round((time.perf_counter() - t0) * 1e3, 3),
                  "digest_launches": dict(counted)}


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


class CheckpointManager:
    """Durable step store under ``dir``; see the module docstring for
    the atomicity / verifiability / quarantine contract.

    ``fingerprint`` (any JSON-able dict) is stamped into every manifest
    and re-checked on load: a checkpoint from a different run shape
    (validator count, variant, config) must refuse loudly rather than
    resume a subtly different simulation. ``retain`` keeps the newest N
    steps (quarantined steps never count against retention).
    """

    def __init__(self, dir: str | os.PathLike, retain: int = 3,
                 async_mode: bool = False,
                 fingerprint: dict | None = None,
                 digest: str = "sha256", backend=None):
        if digest not in _DIGESTS:
            raise ValueError(f"unknown checkpoint digest {digest!r}; "
                             f"one of {sorted(_DIGESTS)}")
        self.dir = os.fspath(dir)
        self.retain = int(retain)
        self.async_mode = bool(async_mode)
        self.fingerprint = fingerprint
        self.digest = digest
        self.backend = backend
        os.makedirs(self.dir, exist_ok=True)
        self._sweep_tmp()
        self._stats = {"saves": 0, "bytes": 0, "blocked_s": 0.0,
                       "background_s": 0.0, "gc_removed": 0,
                       "quarantined": 0}
        # one record a payload file written / validated by this manager:
        # bytes, digest ms and the digest's kernel launches by name
        self.step_log: list[dict] = []
        self.verify_log: list[dict] = []
        # the writer thread (background_s/saves/bytes) and the caller
        # thread (blocked_s, stats() reads) share this dict
        self._stats_lock = threading.Lock()
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._worker_error: BaseException | None = None
        if self.async_mode:
            self._queue = queue.Queue(maxsize=1)
            self._worker = threading.Thread(target=self._drain_loop,
                                            name="ckpt-writer", daemon=True)
            self._worker.start()

    def _pinned_backend(self):
        """The backend a merkle digest hashes on: the manager's, else this
        thread's (resolved now, on the caller's thread)."""
        if self.backend is not None:
            return self.backend
        from pos_evolution_tpu_torch.backend import get_backend
        return get_backend()

    # -- paths -----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        """Visible (non-quarantined) step numbers, oldest first."""
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _sweep_tmp(self) -> None:
        """Recover from a writer killed mid-save: an ``.old-`` directory
        is a displaced previous copy of a re-saved step — restore it if
        the kill landed before the new copy's rename (the step must
        never be lost to a re-save), drop it otherwise. ``.tmp-``
        staging directories are plain hygiene (invisible to ``steps``)."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith(".old-"):
                final = os.path.join(self.dir, name.split("-", 2)[1])
                if not os.path.isdir(final):
                    os.replace(path, final)
                else:
                    shutil.rmtree(path, ignore_errors=True)
            elif name.startswith(".tmp-"):
                shutil.rmtree(path, ignore_errors=True)

    # -- write -----------------------------------------------------------------

    def save(self, step: int, payloads, wait: bool = False) -> None:
        """Persist one step. ``payloads`` is ``bytes``, a zero-arg
        callable returning bytes, or a ``{filename: bytes-or-callable}``
        dict. Callables run on the writer thread in async mode — that is
        the overlap: the caller gathers cheap host state, the thread
        pays for serialization/compression. In sync mode (or with
        ``wait=True``) the call returns only once the step is on disk.
        """
        if not isinstance(payloads, dict):
            payloads = {"payload.bin": payloads}
        # the digest's device is pinned at GATHER time: the writer thread
        # hashes on the backend object the *caller* pinned, even though
        # the bytes materialize on the background thread
        backend = self._pinned_backend() if self.digest == "merkle" else None
        t0 = time.perf_counter()
        if self._queue is None:
            self._write_step(step, payloads, backend)
        else:
            self._raise_worker_error()
            self._queue.put((step, payloads, backend))  # blocks if in flight
            if wait:
                self._queue.join()
                self._raise_worker_error()
        with self._stats_lock:
            self._stats["blocked_s"] += time.perf_counter() - t0

    def _drain_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, payloads, backend = item
            t0 = time.perf_counter()
            try:
                from pos_evolution_tpu_torch.backend import use_backend
                # thread-local: the caller's backend object, as pinned
                with use_backend(backend) if backend is not None else nullcontext():
                    self._write_step(step, payloads, backend)
            except BaseException as e:  # surfaced on the next save/drain
                self._worker_error = e
            finally:
                with self._stats_lock:
                    self._stats["background_s"] += time.perf_counter() - t0
                self._queue.task_done()

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise RuntimeError(
                f"background checkpoint write failed: {err!r}") from err

    def _write_step(self, step: int, payloads: dict, backend=None) -> None:
        t_write = time.perf_counter()
        tmp = os.path.join(self.dir, f".tmp-step_{step:08d}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        files = {}
        records = []
        total = 0
        for name, data in payloads.items():
            if callable(data):
                data = data()
            _fsync_write(os.path.join(tmp, name), data)
            hexd, rec = _timed_digest(self.digest, data, backend)
            files[name] = {self.digest: hexd, "bytes": len(data)}
            records.append({"step": int(step), "file": name, **rec})
            total += len(data)
        manifest = {"v": MANIFEST_VERSION, "step": int(step),
                    "fingerprint": self.fingerprint, "files": files}
        _fsync_write(os.path.join(tmp, "manifest.json"),
                     json.dumps(manifest, sort_keys=True, indent=1).encode())
        final = self._step_dir(step)
        displaced = None
        if os.path.isdir(final):
            # same step re-saved: the durable copy must survive a kill
            # at ANY instruction, so displace it aside (restored by
            # ``_sweep_tmp`` if we die before the new copy's rename —
            # an rmtree-then-rename would lose BOTH in that window)
            displaced = os.path.join(self.dir,
                                     f".old-step_{step:08d}-{os.getpid()}")
            os.replace(final, displaced)
        os.replace(tmp, final)
        # the rename must itself be durable before the step is trusted
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        if displaced is not None:
            shutil.rmtree(displaced, ignore_errors=True)
        with self._stats_lock:
            self._stats["saves"] += 1
            self._stats["bytes"] += total
            write_ms = round((time.perf_counter() - t_write) * 1e3, 3)
            self.step_log += [dict(r, write_ms=write_ms) for r in records]
        self.gc()

    def drain(self) -> None:
        """Block until every queued async save is durable."""
        if self._queue is not None:
            self._queue.join()
            self._raise_worker_error()

    def close(self) -> None:
        if self._queue is not None:
            self._queue.join()
            self._queue.put(None)
            self._queue.join()
            self._worker.join(timeout=10)
            self._queue = None
        self._raise_worker_error()

    # -- validate / load -------------------------------------------------------

    def validate(self, step: int) -> dict:
        """Full verification of one step; returns its manifest or raises
        ``CheckpointCorruption`` naming exactly what failed."""
        manifest, _ = self._verify(step, keep_payloads=False)
        return manifest

    def _verify(self, step: int, keep_payloads: bool):
        """One read per payload file serves both the checksum and (when
        ``keep_payloads``) the returned bytes — ``load`` must not pay
        the resume I/O twice on registry-scale checkpoints."""
        d = self._step_dir(step)
        mpath = os.path.join(d, "manifest.json")
        try:
            with open(mpath, "rb") as fh:
                manifest = json.loads(fh.read().decode())
        except FileNotFoundError:
            raise CheckpointCorruption(
                f"step {step}: no manifest at {mpath}") from None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruption(
                f"step {step}: manifest unparseable ({e})") from None
        if manifest.get("v") != MANIFEST_VERSION:
            raise CheckpointCorruption(
                f"step {step}: unknown manifest version {manifest.get('v')!r}")
        payloads: dict[str, bytes] = {}
        for name, meta in manifest.get("files", {}).items():
            fpath = os.path.join(d, name)
            try:
                with open(fpath, "rb") as fh:
                    data = fh.read()
            except FileNotFoundError:
                raise CheckpointCorruption(
                    f"step {step}: payload file {name!r} missing") from None
            if len(data) != meta["bytes"]:
                raise CheckpointCorruption(
                    f"step {step}: {name!r} truncated "
                    f"({len(data)} of {meta['bytes']} bytes)")
            # the manifest entry names its own algorithm, so a store can
            # hold (and validate) steps written under either digest
            algo = next((a for a in _DIGESTS if a in meta), None)
            if algo is None:
                raise CheckpointCorruption(
                    f"step {step}: {name!r} carries no known digest "
                    f"(expected one of {sorted(_DIGESTS)})")
            backend = self._pinned_backend() if algo == "merkle" else None
            hexd, rec = _timed_digest(algo, data, backend)
            with self._stats_lock:
                self.verify_log.append({"step": int(step), "file": name, **rec})
            if hexd != meta[algo]:
                raise CheckpointCorruption(
                    f"step {step}: {name!r} {algo} checksum mismatch "
                    f"(bit flip or doctored manifest)")
            if keep_payloads:
                payloads[name] = data
        fp = manifest.get("fingerprint")
        if (self.fingerprint is not None and fp is not None
                and fp != self.fingerprint):
            raise FingerprintMismatch(
                f"step {step}: fingerprint mismatch — checkpoint from "
                f"{fp}, this run is {self.fingerprint}")
        return manifest, payloads

    def load(self, step: int) -> dict[str, bytes]:
        """Validated read of one step's payload files."""
        _manifest, payloads = self._verify(step, keep_payloads=True)
        return payloads

    def latest_valid(self, quarantine_bad: bool = True):
        """``(step, payloads)`` for the newest step that passes full
        validation, rolling past (and by default quarantining) any that
        fail; ``None`` when no valid checkpoint exists."""
        for step in reversed(self.steps()):
            try:
                return step, self.load(step)
            except CheckpointCorruption as e:
                from pos_evolution_tpu_torch.telemetry import emit_global
                emit_global("checkpoint_rejected", step=step,
                            reason=str(e)[:300])
                if quarantine_bad and not isinstance(e, FingerprintMismatch):
                    self.quarantine(step, reason=str(e))
        return None

    def quarantine(self, step: int, reason: str = "") -> str:
        """Move a bad step out of the visible sequence, keeping it as
        evidence. Returns the quarantine path."""
        qdir = os.path.join(self.dir, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, f"step_{step:08d}")
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qdir, f"step_{step:08d}.{n}")
        os.replace(self._step_dir(step), dst)
        try:
            _fsync_write(os.path.join(dst, "QUARANTINE_REASON.txt"),
                         (reason or "unspecified").encode())
        except OSError:
            pass  # the move is the record; the note is best-effort
        with self._stats_lock:
            self._stats["quarantined"] += 1
        from pos_evolution_tpu_torch.telemetry import emit_global
        emit_global("checkpoint_quarantined", step=step,
                    reason=(reason or "")[:300], path=dst)
        return dst

    # -- retention -------------------------------------------------------------

    def gc(self) -> int:
        """Drop the oldest steps beyond ``retain``; returns how many."""
        steps = self.steps()
        removed = 0
        for step in steps[:max(len(steps) - self.retain, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            removed += 1
        with self._stats_lock:
            self._stats["gc_removed"] += removed
        return removed

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["blocked_s"] = round(s["blocked_s"], 6)
        s["background_s"] = round(s["background_s"], 6)
        return s
