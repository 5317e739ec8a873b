"""``--doctor``: the analyzer's own CI negative (port of
``pos_evolution_tpu/analysis/doctor.py``: the same zoo and the same
``EXPECTED`` counts, its three JAX forms in their torch forms).

A synthesized source file contains exactly one instance of every bug
class the pass exists to catch — each one a distilled copy of a bug this
repo actually shipped and reviewed out (a compiled object built per
call, an unlocked shared counter, a clock in a seeded decision, a
host sync per iteration, a CUDA-only call on the CPU path). Running the
analyzer over it must produce **exactly** the expected ``PEV###`` codes:

- produced exactly as expected -> exit ``DOCTOR_FINDINGS`` (1): the
  analyzer works, and the doctored file fails the lint, which is the
  CI-negative contract (CI asserts ``rc == 1``);
- nothing found -> exit 0: a clean pass on a file full of bugs means the
  analyzer is broken, and CI's ``rc == 1`` assert fails loudly;
- wrong set found -> exit ``DOCTOR_MISMATCH`` (2) with a diff.
"""

from __future__ import annotations

from .engine import AnalysisConfig, analyze_source

DOCTOR_OK_NONE = 0        # found nothing: analyzer broken
DOCTOR_FINDINGS = 1       # found exactly the expected set
DOCTOR_MISMATCH = 2       # found the wrong set: analyzer broken differently

DOCTOR_RELPATH = "doctor_synthetic.py"

# One bug per class. Never imported or executed — parsed only.
DOCTOR_SOURCE = '''\
"""Synthesized bug zoo for the static-analysis doctor (never executed)."""
import multiprocessing
import threading
import time

import torch


def scale_batch(xs):
    # a compiled object built per call compiles per call
    fn = torch.compile(lambda v: v * 2)
    return fn(xs)


staging = torch.empty(1024, dtype=torch.int64).pin_memory()


def drop_decision(seed, slot):
    # a wall clock inside a seeded stateless decision
    return time.time() % 2.0 < 1.0


def drain_batches(batches):
    total = 0.0
    for b in batches:
        total += torch.sum(b).item()
    return total


def collect(item, acc=[]):
    acc.append(item)
    return acc


class PumpWorker:
    def __init__(self, work):
        self.work = work
        self.thread = threading.Thread(target=self._pump_loop, daemon=True)

    def _pump_loop(self):
        while True:
            try:
                self.work()
            except Exception:
                continue


_pump_registry_lock = threading.Lock()


def pump_child(work):
    # a parent-created lock referenced on the child side
    with _pump_registry_lock:
        work()


def launch_pump(work):
    # fork-start in a module that also runs threads
    ctx = multiprocessing.get_context("fork")
    return ctx.Process(target=pump_child, args=(work,))


class SharedCounters:
    """A locked class with an unlocked read-modify-write."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {}
        self.generation = 0

    def inc(self, key):
        self.counts[key] = self.counts.get(key, 0) + 1

    def snapshot(self):
        with self._lock:
            return dict(self.counts), self.generation

    def reset(self):
        self.generation = 0
'''

EXPECTED = {
    "PEV001": 1,   # scale_batch's per-call torch.compile
    "PEV002": 1,   # time.time in drop_decision
    "PEV003": 1,   # .item() in drain_batches' loop
    "PEV004": 1,   # staging's pin_memory without a CPU-path guard
    "PEV005": 1,   # PumpWorker._pump_loop swallows silently
    "PEV006": 1,   # collect's mutable default
    "PEV007": 2,   # launch_pump's fork context + pump_child's lock
    "PEV101": 1,   # SharedCounters.inc: the unlocked counter
    "PEV102": 1,   # SharedCounters.reset: blind store, locked elsewhere
}


def doctor_config() -> AnalysisConfig:
    """Every scope active on the synthesized file, so one file exercises
    every rule."""
    return AnalysisConfig(
        stateless_strict=(DOCTOR_RELPATH,),
        stateless_decision=(),
        hot_modules=(DOCTOR_RELPATH,),
        threaded_modules=(DOCTOR_RELPATH,),
    )


def run_doctor(out=print) -> int:
    result = analyze_source(DOCTOR_SOURCE, DOCTOR_RELPATH, doctor_config())
    got: dict[str, int] = {}
    for f in result.findings:
        got[f.code] = got.get(f.code, 0) + 1
    for f in result.findings:
        out(f"{f.location()}: {f.code} {f.message}")
    expected = {c: n for c, n in EXPECTED.items() if n}
    if not result.findings:
        out("DOCTOR BROKEN: clean pass on the doctored file — the "
            "analyzer found none of the synthesized bugs")
        return DOCTOR_OK_NONE
    if got != expected:
        out(f"DOCTOR MISMATCH: expected {expected} got {got}")
        return DOCTOR_MISMATCH
    out(f"doctor: all {sum(expected.values())} expected findings across "
        f"{len(expected)} codes produced — the doctored file fails the "
        f"lint, as it must")
    return DOCTOR_FINDINGS
