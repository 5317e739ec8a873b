"""The published serving view: what the RPC front reads, atomically.

The driver mutates its fork-choice stores freely on its own thread; the
serving workers must never see a half-updated store. The seam is a
**published immutable snapshot**: at the end of each slot the driver
builds a ``ServeView`` (head/finality scalars, the current best
light-client update pre-serialized, and the DAS window's sidecars) and
swaps it into ``ServingState`` — one reference assignment, atomic under
the GIL, no locks on the read path. Handlers grab ``current()`` once per
request and work off that view even if a new one lands mid-request
(serving a just-superseded head is normal distributed-systems staleness;
serving a torn one would be a correctness bug).

Publishing is also the serving tier's **block boundary**: new head root
means every proof-path cache key changes, which is exactly the stampede
moment the single-flight machinery (and the chaos mode's cache wipe)
exercises. ``on_publish`` listeners hook that moment.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

__all__ = ["ServeView", "ServingState"]


@dataclass(frozen=True)
class ServeView:
    """Immutable per-slot snapshot served by ``ServeFront``."""

    slot: int
    head_root: bytes
    head_slot: int
    justified_epoch: int
    justified_root: bytes
    finalized_epoch: int
    finalized_root: bytes
    # pre-serialized best update (ssz bytes) + its hash_tree_root, so
    # serving never touches live containers and clients can check the
    # served bytes against the root the head endpoint advertises
    update_ssz: bytes | None = None
    update_root: bytes | None = None
    # DAS window: {block_root: [sidecar, ...]} — each sidecar exposes
    # ``.cells`` (n_cells, cell_bytes) and ``.commitment`` (32 bytes)
    sidecars: dict = field(default_factory=dict)
    n_cells: int = 0
    # the cell-commitment scheme serving this window ("merkle"/"kzg"):
    # remote clients pick das_cells vs das_aggregate from this
    scheme: str = "merkle"

    def head_summary(self) -> dict:
        return {
            "slot": int(self.slot),
            "head_root": self.head_root.hex(),
            "head_slot": int(self.head_slot),
            "update_root": (self.update_root.hex()
                            if self.update_root else None),
            "das_roots": [r.hex() for r in self.sidecars],
            # grid geometry per served root, so a REMOTE load generator
            # can discover its bulk targets from this one endpoint
            # (serve/loadgen.discover_targets) instead of in-process
            # introspection (ISSUE 13 / ROADMAP item 3 remainder)
            "n_cells": int(self.n_cells),
            "scheme": self.scheme,
            "das_blobs": {r.hex(): len(cars)
                          for r, cars in self.sidecars.items()},
        }

    def finality_summary(self) -> dict:
        return {
            "justified_epoch": int(self.justified_epoch),
            "justified_root": self.justified_root.hex(),
            "finalized_epoch": int(self.finalized_epoch),
            "finalized_root": self.finalized_root.hex(),
        }


class ServingState:
    """Atomic view holder + publish listeners (+ optional history for
    replaying a recorded run against a live front)."""

    def __init__(self, keep_history: bool = False):
        self._view: ServeView | None = None
        self._lock = threading.Lock()
        self._listeners: list = []
        self.version = 0
        self.keep_history = keep_history
        self.views: list[ServeView] = []

    def publish(self, view: ServeView) -> int:
        with self._lock:
            self._view = view
            self.version += 1
            version = self.version
            if self.keep_history:
                self.views.append(view)
            listeners = list(self._listeners)
        for fn in listeners:
            fn(view, version)
        return version

    def current(self) -> ServeView | None:
        return self._view  # one ref read — atomic, lock-free

    def on_publish(self, fn) -> None:
        with self._lock:
            self._listeners.append(fn)
