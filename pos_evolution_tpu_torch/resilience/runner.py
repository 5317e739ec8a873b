"""The per-slot supervision hook both drivers share (port of
``pos_evolution_tpu/resilience/runner.py``).

``RunSupervision`` is what a driver's ``autocheckpoint=`` knob
constructs: one object owning the ``CheckpointManager``, the optional
``Heartbeat`` and ``IntegrityGuard``, and the telemetry emissions, with
a single ``tick(driver, slot, capture)`` called at the end of every
slot. The drivers differ only in their ``capture``:

- ``sim/driver.Simulation`` serializes on the caller thread (the
  stores are live mutable Python objects — a background serializer
  would race the next slot's handlers) and overlaps only the
  fsync+rename;
- ``sim/dense_driver.DenseSimulation`` gathers its device columns to
  host synchronously (cheap) and hands the npz compression — the
  expensive part — to the manager's writer thread as a callable.

Order inside a tick matters: heartbeat first (liveness must not wait on
an audit), integrity audit second (a poisoned state must not be
*checkpointed*), checkpoint last.

The port's change: the driver hands its backend object (the spec
driver's own; the dense driver's on its device), and ``digest="auto"``
takes ``"merkle"`` when that backend's device is CUDA (K2 hashes the
payloads) and ``"sha256"`` otherwise. It never reads a backend's name.
"""

from __future__ import annotations

import time

from pos_evolution_tpu_torch.resilience.guard import IntegrityError, IntegrityGuard
from pos_evolution_tpu_torch.resilience.manager import CheckpointManager


def run_fingerprint(kind: str, cfg_obj=None) -> dict:
    """Manifest fingerprint for a driver kind: the ACTIVE config (or an
    explicit ``Config`` — the dense driver carries its own). Mesh shape
    / device count are deliberately absent: resuming onto a degraded
    mesh is a supported path, a different protocol config is not."""
    from pos_evolution_tpu_torch.config import cfg
    from pos_evolution_tpu_torch.resilience import fingerprint_config
    return {"kind": kind,
            "cfg": fingerprint_config(cfg() if cfg_obj is None else cfg_obj)}


class RunSupervision:
    """Owns the resilience side-objects of one supervised run."""

    def __init__(self, spec, kind: str, telemetry=None, cfg_obj=None, backend=None):
        from pos_evolution_tpu_torch.resilience import AutoCheckpoint
        self.cfg = AutoCheckpoint.of(spec)
        digest = self.cfg.digest
        if digest == "auto":
            # merkle digests pay off where K2 takes them (a CUDA device);
            # on the CPU they are ~2x the hashing of a linear sha256
            if backend is None:
                from pos_evolution_tpu_torch.backend import get_backend
                backend = get_backend()
            digest = "merkle" if backend.device.type == "cuda" else "sha256"
        self.manager = CheckpointManager(
            self.cfg.dir, retain=self.cfg.retain,
            async_mode=self.cfg.async_mode,
            fingerprint=run_fingerprint(kind, cfg_obj),
            digest=digest, backend=backend)
        self.heartbeat = None
        if self.cfg.heartbeat:
            from pos_evolution_tpu_torch.utils.watchdog import Heartbeat
            self.heartbeat = Heartbeat(self.cfg.heartbeat)
        self.guard = (IntegrityGuard(self.cfg.guard_every)
                      if self.cfg.guard_every else None)
        self.telemetry = telemetry
        self.saves = 0
        # one record a checkpoint the loop took: its step, the ms the loop
        # was blocked, and the capture's own record (``driver.last_capture``)
        self.tick_log: list[dict] = []
        # main-thread seconds spent in IN-LOOP saves only (the final
        # wait-for-durability save is end-of-run cost, not epoch-loop
        # overhead — the <10% budget is about the loop)
        self.loop_blocked_s = 0.0

    def _emit(self, type_: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.bus.emit(type_, **fields)
        else:
            from pos_evolution_tpu_torch.telemetry import emit_global
            emit_global(type_, **fields)

    def tick(self, driver, slot: int, capture) -> None:
        """End-of-slot hook. ``capture()`` returns the payload for
        ``CheckpointManager.save`` (bytes, or a callable for
        serialize-in-background captures)."""
        if self.heartbeat is not None:
            self.heartbeat.beat(slot=slot)
        if self.guard is not None and self.guard.due(slot):
            findings = self.guard.check(driver)
            if findings:
                self._integrity_failure(slot, findings)
        if slot > 0 and slot % self.cfg.every_n_slots == 0:
            t0 = time.perf_counter()
            self.manager.save(slot, capture())
            blocked_s = time.perf_counter() - t0
            self.loop_blocked_s += blocked_s
            self.saves += 1
            self.tick_log.append({"step": slot, "blocked_ms": round(blocked_s * 1e3, 3),
                                  **getattr(driver, "last_capture", {})})
            self._emit("checkpoint_saved", slot=slot, step=slot,
                       async_mode=self.cfg.async_mode,
                       blocked_ms=round(blocked_s * 1e3, 3))

    def _integrity_failure(self, slot: int, findings: list[str]) -> None:
        """Corruption detected mid-run: record it, pull the NEWEST
        checkpoint out of the resume path (a checksum cannot see
        semantic rot — the step written closest to the detection is
        suspect), and die loudly so the supervisor rolls back to the
        last good step and replays."""
        self._emit("integrity_violation", slot=slot, findings=findings)
        self.manager.drain()  # an in-flight suspect step must land first
        steps = self.manager.steps()
        if steps:
            self.manager.quarantine(
                steps[-1],
                reason=f"integrity findings at slot {slot}: "
                       + "; ".join(findings)[:400])
        raise IntegrityError(findings)

    def finish(self, final_slot: int, capture) -> dict:
        """End-of-run: take one final checkpoint (the result must be as
        durable as any mid-run state), drain the writer, and return the
        manager's overhead stats for the goodput report."""
        self.manager.save(final_slot, capture(), wait=True)
        self.saves += 1
        self.manager.drain()
        stats = self.manager.stats()
        stats["loop_blocked_s"] = round(self.loop_blocked_s, 6)
        self._emit("checkpoint_final", slot=final_slot, **stats)
        return stats
