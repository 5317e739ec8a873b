"""Self-healing long runs: supervised, autocheckpointed, resumable (port
of ``scripts/resilient_run.py``).

One entry point, two roles:

- **parent** (default): launches itself as a ``--child`` process under
  ``resilience.supervise``: crash detection by exit code, hang detection
  by heartbeat-file age, resume with capped jittered backoff, a loud
  refusal after ``--max-failures`` consecutive failures. After success it
  folds the interruptions, retries and overhead into one emission
  (printed, and written to ``--json``) and a ``goodput`` telemetry event;
- **child**: beats the heartbeat before it imports torch, builds (or
  ``resume_latest``-resumes) the requested driver on ``--device`` with
  ``autocheckpoint=`` armed (atomic checksummed steps every ``--every``
  slots, the async writer, per-slot heartbeats, optional integrity
  audits), runs to the target, takes a final checkpoint, and writes
  ``result.json`` (slot, state digest, overhead, and this attempt's
  checkpoint records and kernel launches) atomically.

Failure injection: ``--crash-at-slot N`` SIGKILLs the child the first
time slot N completes (a marker file, which also records the kill's
time, keeps the resumed attempt from crashing again).

Bit-identity contract: the final ``state_digest`` of a killed and
resumed run equals an uninterrupted run's.

Not ported here: ``--sharded`` and ``--degraded-sharded`` (a device mesh,
ROADMAP Queue 1 item 3) and ``--history`` (the bench history, item 7b)
raise.

Usage (``--device cpu`` runs the plain versions on the CPU; the default
is the card):
    python -m pos_evolution_tpu_torch.resilient_run --validators 64 --epochs 3 \\
        --ckpt-dir DIR [--dense] [--every 8] [--crash-at-slot 14] \\
        [--events events.jsonl] [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validators", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--ckpt-dir", required=True,
                    help="CheckpointManager store (also heartbeat + result.json)")
    ap.add_argument("--every", type=int, default=8,
                    help="autocheckpoint interval in slots")
    ap.add_argument("--retain", type=int, default=3)
    ap.add_argument("--sync", action="store_true",
                    help="synchronous checkpoint writes (default: async writer thread)")
    ap.add_argument("--guard-every", type=int, default=0,
                    help="IntegrityGuard audit interval in slots (0=off)")
    ap.add_argument("--dense", action="store_true",
                    help="drive sim/dense_driver.DenseSimulation instead of the "
                         "spec-level Simulation")
    ap.add_argument("--sharded", default=None,
                    help="a device mesh: not ported (ROADMAP Queue 1 item 3)")
    ap.add_argument("--degraded-sharded", default=None,
                    help="a smaller mesh for resumed attempts: not ported (item 3)")
    ap.add_argument("--config", choices=("minimal", "mainnet"), default="minimal")
    ap.add_argument("--crash-at-slot", type=int, default=None,
                    help="SIGKILL the child once after this slot completes "
                         "(failure injection)")
    ap.add_argument("--hang-timeout", type=float, default=300.0)
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", default=None,
                    help="append-mode telemetry JSONL shared by the supervisor and "
                         "every attempt")
    ap.add_argument("--json", default=None, help="write the emission here")
    ap.add_argument("--history", default=None,
                    help="the bench history: not ported (ROADMAP Queue 1 item 7b)")
    ap.add_argument("--device", default="cuda",
                    help="the run's device (cuda, or cpu for the plain versions)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return ap


def _refuse_unported(args) -> None:
    for flag, value, item in (("--sharded", args.sharded, "item 3, the multi-GPU mode"),
                              ("--degraded-sharded", args.degraded_sharded,
                               "item 3, the multi-GPU mode"),
                              ("--history", args.history, "item 7b, the profiling tooling")):
        if value:
            raise SystemExit(f"resilient_run: {flag} is not ported yet "
                             f"(ROADMAP Queue 1 {item})")


# -- child ---------------------------------------------------------------------

def _heartbeat_path(args) -> str:
    return os.path.join(args.ckpt_dir, "heartbeat.json")


def _crash_marker(args) -> str:
    return os.path.join(args.ckpt_dir, "crash_injected")


def _maybe_crash(args, slot: int) -> None:
    if args.crash_at_slot is None or slot != args.crash_at_slot:
        return
    marker = _crash_marker(args)
    if os.path.exists(marker):
        return  # already crashed once; the resumed attempt runs through
    with open(marker, "w") as fh:
        fh.write(f"SIGKILL after slot {slot} at {time.time():.6f}\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.kill(os.getpid(), signal.SIGKILL)


def _kill_unix(args) -> float | None:
    """When the injected kill happened (the marker's time), or None."""
    try:
        with open(_crash_marker(args)) as fh:
            return float(fh.read().split(" at ")[1])
    except (OSError, IndexError, ValueError):
        return None


def _autocheckpoint_spec(args) -> dict:
    return {"every_n_slots": args.every, "dir": args.ckpt_dir,
            "retain": args.retain, "async_mode": not args.sync,
            "guard_every": args.guard_every, "heartbeat": _heartbeat_path(args)}


def _refuse_unless_virgin_store(args) -> None:
    """Called when ``resume_latest`` found nothing valid. A store that
    never held a checkpoint may start fresh; a store with refused
    (fingerprint mismatch) or quarantined steps must not be silently
    restarted from genesis as a run that exits 0."""
    from pos_evolution_tpu_torch.resilience import CheckpointManager
    remnants = []
    if os.path.isdir(args.ckpt_dir):
        steps = CheckpointManager(args.ckpt_dir).steps()
        if steps:
            remnants.append(f"{len(steps)} refused step(s) {steps}")
        qdir = os.path.join(args.ckpt_dir, "quarantine")
        if os.path.isdir(qdir) and os.listdir(qdir):
            remnants.append(f"{len(os.listdir(qdir))} quarantined step(s)")
    if remnants:
        raise SystemExit(
            f"resilient_run: checkpoint store {args.ckpt_dir!r} holds "
            f"{' and '.join(remnants)} but nothing resumable — refusing to restart "
            f"from genesis as if nothing happened; inspect the store (wrong --config? "
            f"corrupted disk?)")
    print("# child: no checkpoints yet — starting fresh", file=sys.stderr)


def run_child(args) -> int:
    # liveness first: the supervisor's hang clock must not run through
    # the imports and the build
    from pos_evolution_tpu_torch.utils.watchdog import Heartbeat
    Heartbeat(_heartbeat_path(args)).beat(stage="start")
    import torch

    from pos_evolution_tpu_torch.config import mainnet_config, minimal_config, use_config
    from pos_evolution_tpu_torch.device import resolve_device
    from pos_evolution_tpu_torch.ops import kernels
    from pos_evolution_tpu_torch.resilience import state_digest
    from pos_evolution_tpu_torch.telemetry import Telemetry
    dev = resolve_device(args.device)
    cfg_obj = minimal_config() if args.config == "minimal" else mainnet_config()
    telemetry = Telemetry.to_file(args.events, append=True) if args.events else None
    if telemetry is not None:
        # bus-less emitters (the manager's quarantine and reject, the
        # dense driver's supervision) reach the same log
        telemetry.install_global()
    spec = _autocheckpoint_spec(args)
    t0 = time.perf_counter()
    kernels.reset_launches()
    with use_config(cfg_obj):
        if args.dense:
            sim, target, resume = _build_dense(args, cfg_obj, spec, dev)
        else:
            sim, target, resume = _build_spec(args, spec, telemetry, dev)
        Heartbeat(_heartbeat_path(args)).beat(stage="built", slot=sim.slot)
        first_slot_unix = None
        # the dense driver's slot counts run slots, the spec driver's the next slot
        last = target if args.dense else target + 1
        while sim.slot < last:
            sim.run_slot()
            if first_slot_unix is None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                first_slot_unix = time.time()
            _maybe_crash(args, sim.slot)
        stats = sim.finish_autocheckpoint()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run_wall = time.perf_counter() - t0
        kill_unix = _kill_unix(args)
        if resume is not None and kill_unix is not None and first_slot_unix is not None:
            resume["kill_to_first_slot_s"] = round(first_slot_unix - kill_unix, 3)
        sup = sim.supervision
        result = {
            "driver": "dense" if args.dense else "sim",
            "n_validators": args.validators,
            "slot": sim.slot,
            "finalized_epoch": sim.finalized[0] if args.dense else sim.finalized_epoch(),
            "state_digest": state_digest(sim),
            "run_wall_s": round(run_wall, 3),
            "checkpoint": stats,
            "resumed_on_degraded_mesh": None,
            "device": str(dev),
            "digest": sup.manager.digest,
            "resume": resume,
            "checkpoint_ticks": sup.tick_log,
            "checkpoint_writes": sup.manager.step_log,
            "final_capture": getattr(sim, "last_capture", {}),
            "launches": {k: v for k, v in kernels.launches.items() if v},
        }
    from pos_evolution_tpu_torch.utils.snapshot import atomic_write_bytes
    atomic_write_bytes(os.path.join(args.ckpt_dir, "result.json"),
                       (json.dumps(result, indent=1, sort_keys=True) + "\n").encode())
    if telemetry is not None:
        telemetry.bus.emit("run_segment", wall_s=result["run_wall_s"], final_slot=sim.slot)
        telemetry.close()
    print(json.dumps(result, indent=1, sort_keys=True))
    return 0


def _resumed(load, args, dev):
    """``load()`` (a ``resume_latest``) timed, with the K2 launches of its
    digest re-check; None (and the store checked) when nothing is valid."""
    from pos_evolution_tpu_torch.ops import kernels
    k2 = kernels.launches["merkle_level"]
    t0 = time.perf_counter()
    try:
        sim = load()
    except FileNotFoundError:
        _refuse_unless_virgin_store(args)
        return None, None
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    print(f"# child: resumed at slot {sim.slot}", file=sys.stderr)
    return sim, {"slot": sim.slot, "load_s": round(time.perf_counter() - t0, 3),
                 "k2_launches": kernels.launches["merkle_level"] - k2,
                 "verify": sim.resumed_from["verify"]}


def _build_spec(args, spec, telemetry, dev):
    from pos_evolution_tpu_torch.config import cfg as active_cfg
    from pos_evolution_tpu_torch.sim.driver import Simulation
    sim, resume = _resumed(lambda: Simulation.resume_latest(
        args.ckpt_dir, telemetry=telemetry, autocheckpoint=spec, device=dev), args, dev)
    if sim is None:
        sim = Simulation(args.validators, telemetry=telemetry, autocheckpoint=spec,
                         device=dev)
    return sim, args.epochs * active_cfg().slots_per_epoch, resume


def _build_dense(args, cfg_obj, spec, dev):
    from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation
    sim, resume = _resumed(lambda: DenseSimulation.resume_latest(
        args.ckpt_dir, device=dev, autocheckpoint=spec), args, dev)
    if sim is None:
        sim = DenseSimulation(args.validators, cfg=cfg_obj, device=dev,
                              verify_aggregates=False, check_walk_every=8,
                              autocheckpoint=spec)
    return sim, args.epochs * cfg_obj.slots_per_epoch, resume


# -- parent --------------------------------------------------------------------

class _AppendBus:
    """Emit supervisor events into the shared JSONL without holding the
    file open across a child's lifetime: each emission reopens in append
    mode, so the seq ordinal continues past everything the child wrote."""

    def __init__(self, path: str | None):
        self.path = path

    def emit(self, type_: str, **fields) -> None:
        if self.path is None:
            return
        from pos_evolution_tpu_torch.telemetry.events import EventBus
        bus = EventBus(self.path, keep_in_memory=False, append=True)
        bus.emit(type_, **fields)
        bus.close()


def _replayed_slots(events_path: str | None) -> int:
    if not events_path or not os.path.exists(events_path):
        return 0
    from pos_evolution_tpu_torch.resilience import replayed_slots_from_events
    from pos_evolution_tpu_torch.telemetry import read_jsonl
    return replayed_slots_from_events(read_jsonl(events_path))


def run_parent(args, argv: list[str]) -> int:
    from pos_evolution_tpu_torch.resilience import SupervisorGaveUp, supervise
    os.makedirs(args.ckpt_dir, exist_ok=True)
    bus = _AppendBus(args.events)

    def build_argv(attempt: int) -> list[str]:
        # the parsed invocation, not sys.argv: a programmatic main([...])
        # caller supervises the child it asked for
        return [sys.executable, "-m", "pos_evolution_tpu_torch.resilient_run", "--child",
                *argv]

    # the child imports this package from the same tree as the parent
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    try:
        summary = supervise(
            build_argv, heartbeat_path=_heartbeat_path(args),
            hang_timeout_s=args.hang_timeout, max_failures=args.max_failures,
            backoff_s=args.backoff, seed=args.seed, env=env, events_bus=bus)
    except SupervisorGaveUp as e:
        print(f"resilient_run: GAVE UP — {e}", file=sys.stderr)
        print(json.dumps(e.summary, indent=1))
        return 1

    with open(os.path.join(args.ckpt_dir, "result.json")) as fh:
        result = json.load(fh)
    ckpt = result.get("checkpoint") or {}
    run_wall = max(result.get("run_wall_s") or 0.0, 1e-9)
    replayed = _replayed_slots(args.events)
    final_slot = result["slot"]
    emission = {
        "metric": "resilient_run",
        "driver": result["driver"],
        "n_validators": args.validators,
        "epochs": args.epochs,
        "sharded": None,
        "attempts": summary["attempts"],
        "interruptions": len(summary["interruptions"]),
        "interruption_reasons": sorted({i["reason"] for i in summary["interruptions"]}),
        "replayed_slots": replayed,
        "final_slot": final_slot,
        "goodput_pct": round(100.0 * final_slot / max(final_slot + replayed, 1), 2),
        "ckpt_saves": ckpt.get("saves", 0),
        "ckpt_bytes": ckpt.get("bytes", 0),
        "ckpt_blocked_s": ckpt.get("loop_blocked_s", 0.0),
        "ckpt_background_s": ckpt.get("background_s", 0.0),
        "ckpt_overhead_pct": round(100.0 * ckpt.get("loop_blocked_s", 0.0) / run_wall, 3),
        "run_wall_s": result["run_wall_s"],
        "total_wall_s": summary["total_wall_s"],
        "resumed_on_degraded_mesh": None,
        "state_digest": result["state_digest"],
        "finalized_epoch": result["finalized_epoch"],
        "counts": {"attempts": summary["attempts"],
                   "interruptions": len(summary["interruptions"]),
                   "replayed_slots": replayed,
                   "ckpt_saves": ckpt.get("saves", 0)},
    }
    bus.emit("goodput", **{k: v for k, v in emission.items() if k != "metric"})
    print(json.dumps(emission, indent=1, sort_keys=True))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(emission, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if not args.child:
        from pos_evolution_tpu_torch.device import resolve_device
        resolve_device(args.device)   # no CUDA and no --device cpu: raise here
    if args.child:
        return run_child(args)
    return run_parent(args, argv)


if __name__ == "__main__":
    sys.exit(main())
