"""Run supervision: self-healing long runs (port of
``pos_evolution_tpu/resilience/__init__.py``).

Four legs, one contract:

- ``CheckpointManager`` (``manager.py``): atomic, checksummed,
  retention-managed checkpoint steps with an async writer so the epoch
  loop never blocks on serialization;
- ``supervise`` (``supervisor.py``): parent-process crash/hang
  detection over ``utils/watchdog.Heartbeat`` files, resume with capped
  jittered backoff, loud refusal after N consecutive failures;
- ``IntegrityGuard`` (``guard.py``): the deep spec-walk / column-scan
  oracles as a *recovery trigger* — quarantine the suspect checkpoint,
  roll back, replay;
- goodput accounting: every decision lands on the telemetry bus as
  ``checkpoint_*`` / ``supervisor_*`` / ``integrity_violation`` events,
  folded into ``scripts/run_report.py``'s "Resilience" section.

Both drivers opt in with ``autocheckpoint=(every_n_slots, dir)`` (or
the ``AutoCheckpoint`` record for the full knob set); a restarted
process calls ``resume_latest``. ``scripts/resilient_run.py`` is the
CLI that ties the halves together; the port's is ``python -m
pos_evolution_tpu_torch.resilient_run``.

``state_digest`` hashes a dense run's registry-scale columns where they
lie: through kernel K2 on the card, its plain version with
``sim.plain`` or on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

from pos_evolution_tpu_torch.resilience.guard import (
    IntegrityError,
    IntegrityGuard,
    scan_columns,
)
from pos_evolution_tpu_torch.resilience.manager import (
    CheckpointCorruption,
    CheckpointManager,
    FingerprintMismatch,
)
from pos_evolution_tpu_torch.resilience.runner import RunSupervision
from pos_evolution_tpu_torch.resilience.supervision import (
    RetryPolicy,
    heartbeat_age,
    rss_kb,
)
from pos_evolution_tpu_torch.resilience.supervisor import (
    SupervisorGaveUp,
    backoff_delay,
    supervise,
)

__all__ = [
    "AutoCheckpoint", "CheckpointManager", "CheckpointCorruption",
    "FingerprintMismatch", "IntegrityGuard", "IntegrityError",
    "RetryPolicy", "RunSupervision", "SupervisorGaveUp", "backoff_delay",
    "fingerprint_config", "heartbeat_age", "replayed_slots_from_events",
    "rss_kb", "scan_columns", "state_digest", "supervise",
]


def replayed_slots_from_events(events) -> int:
    """Slots re-executed because interruptions rolled the run back to a
    checkpoint: for each ``supervisor_interruption`` whose last
    heartbeat reached slot H, the next ``run_resumed`` at slot R costs
    ``max(H - R, 0)`` replayed slots. THE one implementation — the
    bench emission (``scripts/resilient_run.py``) and the offline
    report (``scripts/run_report.py``) must never disagree on it."""
    replayed = 0
    last_hb = None
    for ev in events:
        t = ev.get("type")
        if t == "supervisor_interruption":
            last_hb = (ev.get("last_heartbeat") or {}).get("slot")
        elif t == "run_resumed" and last_hb is not None:
            replayed += max(last_hb - ev.get("slot", last_hb), 0)
            last_hb = None
    return replayed


@dataclass
class AutoCheckpoint:
    """The drivers' ``autocheckpoint=`` knob, normalized. Accepted
    spellings at the driver: an ``AutoCheckpoint``, an
    ``(every_n_slots, dir)`` tuple, or a dict of these fields.

    ``async_mode`` keeps serialization off the run loop (bounded
    staleness: at most one interval plus one in-flight step is lost on
    a kill). ``guard_every`` arms an ``IntegrityGuard`` audit every N
    slots (0 = off). ``heartbeat`` names a ``utils/watchdog.Heartbeat``
    file beaten once per slot for the supervisor's hang detection.
    ``digest`` picks the payload checksum: ``"auto"`` (default) resolves
    at supervision construction to the ``"merkle"`` digest
    (``ops/merkle_device.DIGEST_ALGO``, K2 on the card) when the driver's
    device is CUDA, and to plain ``"sha256"`` otherwise (on the CPU the
    merkle digest is ~2x the hashing for nothing). Explicit
    ``"merkle"``/``"sha256"`` are honored as given."""

    every_n_slots: int
    dir: str
    retain: int = 3
    async_mode: bool = True
    guard_every: int = 0
    heartbeat: str | None = None
    digest: str = "auto"

    @classmethod
    def of(cls, spec) -> "AutoCheckpoint":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        every, dir_ = spec
        return cls(every_n_slots=int(every), dir=os.fspath(dir_))


def fingerprint_config(cfg) -> str:
    """Stable hash of an active ``config.Config`` for checkpoint
    manifests — mesh shape and device count are deliberately NOT part
    of it (resume-across-mesh-shapes is a supported degraded path)."""
    import dataclasses
    blob = json.dumps(
        {k: (v.hex() if isinstance(v, bytes) else v)
         for k, v in dataclasses.asdict(cfg).items()},
        sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def state_digest(sim) -> str:
    """Mesh-independent digest of a driver's full simulation state —
    the bit-identity witness the kill-resume tests and the CI twin
    compare. Two runs with equal digests hold identical stores/columns,
    metrics, and slot cursors, whatever mesh (or interruption history)
    produced them."""
    h = hashlib.sha256()
    if hasattr(sim, "head_host_walk"):  # DenseSimulation
        # registry-scale columns go through the merkle payload digest
        # where they lie (K2 on the card) and only the 32-byte column
        # digests feed the scalar accumulator: the same witness whichever
        # path hashed the columns
        from pos_evolution_tpu_torch.ops.merkle_device import digest_bytes
        for col in (*sim.registry, sim.msg_block, sim.msg_epoch):
            h.update(digest_bytes(col[: sim.n], plain=sim.plain))
        meta = {"slot": sim.slot, "roots": [r.hex() for r in sim.roots],
                "parents": sim.parents, "block_slots": sim.block_slots,
                "bits": [bool(b) for b in sim.bits],
                "prev_just": list(sim.prev_just),
                "cur_just": list(sim.cur_just),
                "finalized": list(sim.finalized),
                "metrics": sim.metrics}
        h.update(json.dumps(meta, sort_keys=True).encode())
        return h.hexdigest()
    from pos_evolution_tpu_torch.backend import use_backend
    from pos_evolution_tpu_torch.utils.snapshot import save_store
    with use_backend(sim.backend):
        for g in sim.groups:
            h.update(save_store(g.store))
    h.update(json.dumps({"slot": sim.slot, "metrics": sim.metrics},
                        sort_keys=True, default=repr).encode())
    return h.hexdigest()
