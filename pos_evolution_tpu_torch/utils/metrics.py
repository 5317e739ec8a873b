"""Observability: per-handler tracing + structured per-slot metrics
(port of ``pos_evolution_tpu/utils/metrics.py``; its ``jax.profiler``
regions ``device_trace`` and ``trace_region`` are ROADMAP Queue 1 item 7b).

- ``HandlerTimer``: wall-clock tracing of ``on_block`` / ``on_attestation``
  / ``get_head`` with percentile summaries — the north-star fork-choice p50
  metric comes from here.
- ``SlotLog``: the structured per-slot record mirroring the quantities the
  spec itself tracks in state (justification bits pos-evolution.md:364,
  participation flags :361-362, equivocator set :897).
- ``StoreInvariantChecker``: the concurrency-adjacent contract of
  pos-evolution.md:1041 (failed handlers must not modify the store),
  enforced by snapshot/compare around handler calls — the framework's
  "race detector" analogue (the handlers are the only mutation sites).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class HandlerTimer:
    """Collects wall-clock samples per named handler."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def wrapped(*a, **kw):
            with self.track(name):
                return fn(*a, **kw)
        return wrapped

    def percentile(self, name: str, q: float) -> float:
        """The q-th percentile of ``name``'s samples in SECONDS (NaN when
        empty) — the one accessor every consumer (benches, the profiling
        exporters, ``summary()`` itself) derives p50/p95 from, instead of
        re-implementing percentile math over raw sample lists."""
        xs = self.samples.get(name, [])
        return float(np.percentile(xs, q)) if xs else float("nan")

    def reset(self) -> None:
        """Drop all samples — benches call this after warm-up/compile
        iterations so measured percentiles cover only the steady state."""
        self.samples.clear()

    def summary(self) -> dict:
        # an empty sample list (a handler registered but never hit, or a
        # summary taken right after reset()) is NaN/0, never a crash
        return {
            name: {
                "count": len(xs),
                "p50_ms": round(self.percentile(name, 50) * 1e3, 4),
                "p95_ms": round(self.percentile(name, 95) * 1e3, 4),
                "total_s": round(float(np.sum(xs)), 4) if xs else 0.0,
            }
            for name, xs in self.samples.items()
        }


def slot_record(store, slot: int, head: bytes | None = None) -> dict:
    """Structured per-slot log entry (SURVEY.md §5 metrics).

    ``head`` lets a caller that already ran the head query (the sim
    driver, whose accelerated path answers from the device-resident
    store) pass it in instead of paying a second spec walk."""
    if head is None:
        from pos_evolution_tpu_torch.specs.forkchoice import get_head
        head = get_head(store)
    head_state = store.block_states[head]
    n = len(head_state.validators)
    participation = (
        float((head_state.current_epoch_participation > 0).sum()) / n if n else 0.0)
    return {
        "slot": slot,
        "head_root": head.hex()[:16],
        "head_slot": int(store.blocks[head].slot),
        "justified_epoch": int(store.justified_checkpoint.epoch),
        "finalized_epoch": int(store.finalized_checkpoint.epoch),
        "justification_bits": head_state.justification_bits.astype(int).tolist(),
        "participation": round(participation, 4),
        "n_blocks": len(store.blocks),
        "n_latest_messages": len(store.latest_messages),
        "equivocators": len(store.equivocating_indices),
    }


def light_client_lag_record(lc_store, slot: int, full_head_slot: int,
                            full_finalized_epoch: int) -> dict:
    """Per-slot lag of a light client behind the full node it follows:
    ``head_lag`` in slots (full head vs optimistic header) and
    ``finality_lag`` in epochs (full finalized epoch vs the epoch of the
    client's finalized header). The structured complement of ``slot_record``
    for the thin-client side of the sync protocol."""
    from pos_evolution_tpu_torch.config import cfg
    spe = cfg().slots_per_epoch
    head_slot = int(lc_store.optimistic_header.slot)
    # A checkpoint's block can sit BEFORE its epoch boundary (skipped
    # boundary slot), so round the block slot UP to the epoch it anchors —
    # floor division would report a phantom one-epoch lag. Force-updated
    # headers are arbitrary mid-epoch attested headers, for which the
    # rounding over-credits by at most one epoch; clamp at zero so the lag
    # never goes negative in exactly those lossy scenarios.
    finalized_epoch = (int(lc_store.finalized_header.slot) + spe - 1) // spe
    return {
        "slot": int(slot),
        "lc_head_slot": head_slot,
        "lc_finalized_slot": int(lc_store.finalized_header.slot),
        "head_lag": int(full_head_slot) - head_slot,
        "finality_lag": max(int(full_finalized_epoch) - finalized_epoch, 0),
    }


class StoreInvariantChecker:
    """Wraps fork-choice handlers; on handler exception, verifies the store
    is unchanged (pos-evolution.md:1041) and re-raises."""

    def __init__(self, store):
        self.store = store
        self.violations: list[str] = []

    def _fingerprint(self):
        s = self.store
        return (
            s.time,
            tuple(sorted(s.blocks.keys())),
            tuple(sorted((v, m.epoch, m.root) for v, m in s.latest_messages.items())),
            (int(s.justified_checkpoint.epoch), bytes(s.justified_checkpoint.root)),
            (int(s.finalized_checkpoint.epoch), bytes(s.finalized_checkpoint.root)),
            (int(s.best_justified_checkpoint.epoch),
             bytes(s.best_justified_checkpoint.root)),
            bytes(s.proposer_boost_root),
            frozenset(s.equivocating_indices),
            tuple(sorted(s.checkpoint_states.keys())),
        )

    def call(self, handler, *args, **kwargs):
        before = self._fingerprint()
        try:
            return handler(self.store, *args, **kwargs)
        except AssertionError:
            if getattr(handler, "commits_prefix", False):
                # batch handlers (forkchoice.on_block_batch) document
                # prefix-commit semantics: a mid-run reject leaves every
                # earlier item fully committed — each through the same
                # per-item asserts the atomic handler enforces — so a
                # changed store here is the contract, not a torn write.
                raise
            after = self._fingerprint()
            if before != after:
                self.violations.append(
                    f"{getattr(handler, '__name__', handler)} mutated the store "
                    f"on a failed call")
            raise


def percentile_ms(xs, q: float) -> float:
    """q-th percentile of a raw sample list in SECONDS, reported in
    MILLISECONDS (NaN when empty) — the free-function twin of
    ``HandlerTimer.percentile`` for consumers that hold their own
    sample lists (the serving tier's latency reservoirs), so percentile
    math isn't re-implemented with subtly different interpolation at
    every call site."""
    if not xs:
        return float("nan")
    return round(float(np.percentile(xs, q)) * 1e3, 4)
