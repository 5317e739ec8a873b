"""Online property monitors for the dense driver (port of
``pos_evolution_tpu/sim/dense_monitors.py``, host numpy as there).

The monitors read the per-slot origination masks (bool[N] vote batches,
before the fault masks), accumulate the implicated double voters as one
boolean column, and price it with the driver's ``stake_of``:

- ``DenseAccountableSafetyMonitor``: conflicting finalized (or
  same-epoch justified) checkpoints across views with evidence of at
  least 1/3 of genesis stake are an ``accountable_fault``; with less, a
  ``protocol_violation``.
- ``DenseVariantSafetyMonitor``: the same rule at slot granularity for
  the per-slot variants (SSF finalizations, Goldfish/RLMD
  confirmations).
- ``DenseFinalityLivenessMonitor``: post-GST, with under 1/3
  controlled, finality may trail the current epoch by at most
  ``bound_epochs``; disarmed, with its reason, when the preconditions
  cannot hold.
- ``DenseForkChoiceParityMonitor``: the device head equals the host
  walk on every view.

Violations land on ``DenseSimulation.monitor_violations``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DenseMonitor", "DenseAccountableSafetyMonitor",
    "DenseVariantSafetyMonitor", "DenseFinalityLivenessMonitor",
    "DenseForkChoiceParityMonitor",
    "default_dense_monitors", "dense_monitor_from_config",
]


class DenseMonitor:
    """Base monitor: observes origination masks, checks once per slot."""

    name = "monitor"

    def bind(self, sim) -> None:
        self.sim = sim

    def describe(self) -> dict:
        return {"kind": type(self).__name__}

    def on_votes(self, sim, slot: int, originated: list) -> None:
        """``originated``: [(view, VoteBatch), ...] — pre-fault masks."""

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        return []

    # checkpoint support (mirrors the adversary contract)
    def state_meta(self) -> dict:
        return {}

    def state_arrays(self) -> dict:
        return {}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        pass


class DenseAccountableSafetyMonitor(DenseMonitor):
    """Safety auditor over the double-vote evidence column."""

    name = "accountable_safety"

    def bind(self, sim) -> None:
        super().bind(sim)
        self.implicated = np.zeros(sim.n, dtype=bool)
        self._reported: set = set()

    # -- observation -----------------------------------------------------------

    def on_votes(self, sim, slot: int, originated: list) -> None:
        """The FFG double-vote rule, vectorized: two origination masks
        with the same target epoch and different target blocks overlap
        only on equivocators — their intersection joins the evidence
        column. O(batches^2) mask ANDs per slot with batches <= a
        handful, each AND one O(N) vector op."""
        for i in range(len(originated)):
            for j in range(i + 1, len(originated)):
                (_, a), (_, b) = originated[i], originated[j]
                if a.epoch == b.epoch and a.block != b.block:
                    both = a.mask & b.mask
                    if both.any():
                        self.implicated |= both

    # -- per-slot check --------------------------------------------------------

    def _conflicting(self, sim, ca: tuple, cb: tuple) -> bool:
        (ea, ia), (eb, ib) = ca, cb
        if ea == 0 or eb == 0:
            return False        # genesis conflicts with nothing
        if ea == eb:
            return ia != ib
        lo, hi = (ia, ib) if ea < eb else (ib, ia)
        # ancestry over the shared block tree — the driver's own walk
        return not sim._descends(hi, lo)

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        out = []
        views = sim.views
        for i in range(len(views)):
            for j in range(i + 1, len(views)):
                vi, vj = views[i], views[j]
                pairs = [("finalized", vi.finalized, vj.finalized),
                         ("justified", vi.cur_just, vj.cur_just)]
                for label, ca, cb in pairs:
                    # conflicting *justified* checkpoints are slashable
                    # only at the SAME epoch (2/3 + 2/3 overlap) —
                    # exactly the spec monitor's rule
                    if label == "justified" and ca[0] != cb[0]:
                        continue
                    if not self._conflicting(sim, ca, cb):
                        continue
                    key = (label, i, j, ca[0], ca[1], cb[0], cb[1])
                    if key in self._reported:
                        continue
                    self._reported.add(key)
                    stake = sim.stake_of(self.implicated)
                    total = sim.total_stake
                    accountable = 3 * stake >= total
                    out.append({
                        "monitor": self.name,
                        "kind": ("accountable_fault" if accountable
                                 else "protocol_violation"),
                        "checkpoint": label,
                        "groups": [i, j],
                        "epochs": [int(ca[0]), int(cb[0])],
                        "roots": [sim.roots[ca[1]].hex()[:16],
                                  sim.roots[cb[1]].hex()[:16]],
                        "evidence_size": int(self.implicated.sum()),
                        "slashable_stake": int(stake),
                        "total_stake": int(total),
                        "detail": (
                            f"conflicting {label} checkpoints between "
                            f"views {i}/{j}; double-vote evidence covers "
                            f"{stake}/{total} stake"
                            + ("" if accountable else
                               " — BELOW the 1/3 accountable-safety"
                               " bound")),
                    })
        return out

    def state_meta(self) -> dict:
        return {"reported": [list(k) for k in sorted(self._reported)]}

    def state_arrays(self) -> dict:
        return {"implicated": self.implicated}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.implicated = np.asarray(arrays["implicated"], dtype=bool).copy()
        self._reported = {tuple(k) for k in meta.get("reported", [])}


class DenseVariantSafetyMonitor(DenseMonitor):
    """Judges each variant by ITS OWN finality rule: the FFG
    monitor above prices conflicting epoch checkpoints, but the per-slot
    variants decide at slot granularity — SSF finalizes in-slot, the
    expiry variants confirm per slot. This monitor reads the variant's
    per-view decision state (``fin_log`` / ``conf_idx``) and prices
    conflicts with the same double-vote evidence column, now keyed by
    SLOT (two votes cast the same slot for different blocks — exactly
    the per-slot equivocation the SSF slashing conditions name):

    - conflicting per-view SSF finalizations at the same slot with
      evidence >= 1/3 stake -> ``accountable_double_finality`` (the
      theorem holding at slot granularity); with less evidence ->
      ``protocol_violation`` (what the doctored negative forges);
    - cross-view Goldfish/RLMD confirmations where neither confirmed
      block descends from the other -> ``confirmation_divergence``
      (expected under a partition: confirmation is synchrony-dependent,
      pos-evolution.md:1573 — the monitor names it, the matrix expects
      it).

    Inert under Gasper (no per-slot decision state to read)."""

    name = "variant_safety"

    def bind(self, sim) -> None:
        super().bind(sim)
        self.implicated = np.zeros(sim.n, dtype=bool)
        self._reported: set = set()

    def on_votes(self, sim, slot: int, originated: list) -> None:
        for i in range(len(originated)):
            for j in range(i + 1, len(originated)):
                (_, a), (_, b) = originated[i], originated[j]
                sa = slot if a.slot is None else a.slot
                sb = slot if b.slot is None else b.slot
                if sa == sb and a.block != b.block:
                    both = a.mask & b.mask
                    if both.any():
                        self.implicated |= both

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        variant = sim.variant
        out = []
        fin_log = getattr(variant, "fin_log", None)
        if fin_log is not None:
            # SSF: any same-slot, different-block pair across views
            for i in range(sim.n_groups):
                for j in range(i + 1, sim.n_groups):
                    for s_i, b_i in fin_log[i]:
                        for s_j, b_j in fin_log[j]:
                            if s_i != s_j or b_i == b_j:
                                continue
                            key = ("fin", i, j, s_i, b_i, b_j)
                            if key in self._reported:
                                continue
                            self._reported.add(key)
                            stake = sim.stake_of(self.implicated)
                            total = sim.total_stake
                            accountable = 3 * stake >= total
                            out.append({
                                "monitor": self.name,
                                "kind": ("accountable_double_finality"
                                         if accountable
                                         else "protocol_violation"),
                                "rule": variant.name,
                                "groups": [i, j],
                                "decision_slot": int(s_i),
                                "roots": [sim.roots[b_i].hex()[:16],
                                          sim.roots[b_j].hex()[:16]],
                                "evidence_size":
                                    int(self.implicated.sum()),
                                "slashable_stake": int(stake),
                                "total_stake": int(total),
                                "detail": (
                                    f"views {i}/{j} finalized conflicting "
                                    f"blocks at slot {s_i} under "
                                    f"{variant.name}; per-slot double-vote "
                                    f"evidence covers {stake}/{total} stake"
                                    + ("" if accountable else
                                       " — BELOW the 1/3 bound")),
                            })
        conf = getattr(variant, "conf_idx", None)
        if conf is not None:
            for i in range(sim.n_groups):
                for j in range(i + 1, sim.n_groups):
                    a, b = conf[i], conf[j]
                    if a == b or sim._descends(a, b) \
                            or sim._descends(b, a):
                        continue
                    key = ("conf", i, j, a, b)
                    if key in self._reported:
                        continue
                    self._reported.add(key)
                    out.append({
                        "monitor": self.name,
                        "kind": "confirmation_divergence",
                        "rule": variant.name,
                        "groups": [i, j],
                        "roots": [sim.roots[a].hex()[:16],
                                  sim.roots[b].hex()[:16]],
                        "detail": (
                            f"views {i}/{j} confirmed diverging blocks "
                            f"under {variant.name} (confirmation is "
                            f"synchrony-dependent — expected under a "
                            f"partition, never under clean conditions)"),
                    })
        return out

    def state_meta(self) -> dict:
        return {"reported": [list(k) for k in sorted(self._reported)]}

    def state_arrays(self) -> dict:
        return {"implicated": self.implicated}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.implicated = np.asarray(arrays["implicated"],
                                     dtype=bool).copy()
        self._reported = {tuple(k) for k in meta.get("reported", [])}


class DenseFinalityLivenessMonitor(DenseMonitor):
    """Plausible-liveness auditor; disarmed (loudly, in ``describe``)
    when the theorem's preconditions cannot hold."""

    name = "finality_liveness"

    def __init__(self, bound_epochs: int = 4,
                 armed_after_epoch: int | None = None):
        self.bound_epochs = int(bound_epochs)
        self.armed_after_epoch = armed_after_epoch
        self.disarmed_reason: str | None = None
        self._worst_lag = 0

    def describe(self) -> dict:
        return {"kind": type(self).__name__,
                "bound_epochs": self.bound_epochs,
                "armed_after_epoch": self.armed_after_epoch,
                "disarmed": self.disarmed_reason}

    def bind(self, sim) -> None:
        super().bind(sim)
        n_controlled = int(sim.controlled_any.sum())
        if 3 * n_controlled >= sim.n:
            self.disarmed_reason = (f"{n_controlled}/{sim.n} controlled "
                                    f">= 1/3: liveness not guaranteed")
            return
        plan = sim.fault_plan
        if self.armed_after_epoch is not None:
            return
        armed = 0
        if plan is not None:
            if plan.partition == "full":
                self.disarmed_reason = \
                    "fully partitioned network: no synchrony to rely on"
                return
            if (plan.drop_p or plan.delay_p) and plan.gst_slot is None:
                self.disarmed_reason = \
                    "message faults with no GST: no synchrony to rely on"
                return
            if plan.gst_slot is not None:
                armed = max(armed, -(-int(plan.gst_slot) // sim.S))
            for w in plan.crashes:
                armed = max(armed, -(-w.rejoin_slot // sim.S))
        self.armed_after_epoch = armed

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        if self.disarmed_reason is not None:
            return []
        epoch = slot // sim.S
        if epoch < (self.armed_after_epoch or 0) + self.bound_epochs:
            return []
        best = max(v.finalized[0] for v in sim.views)
        lag = epoch - best
        if lag <= self.bound_epochs or lag <= self._worst_lag:
            return []   # report once per lag level, not per stalled slot
        self._worst_lag = lag
        return [{
            "monitor": self.name,
            "kind": "liveness_violation",
            "epoch": int(epoch),
            "best_finalized_epoch": int(best),
            "lag_epochs": int(lag),
            "bound_epochs": self.bound_epochs,
            "armed_after_epoch": self.armed_after_epoch,
            "detail": (f"finality lag {lag} epochs > bound "
                       f"{self.bound_epochs} at epoch {epoch} "
                       f"(post-GST, < 1/3 controlled)"),
        }]

    def state_meta(self) -> dict:
        return {"worst_lag": self._worst_lag,
                "armed_after_epoch": self.armed_after_epoch,
                "disarmed": self.disarmed_reason}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self._worst_lag = int(meta.get("worst_lag", 0))
        self.armed_after_epoch = meta.get("armed_after_epoch")
        self.disarmed_reason = meta.get("disarmed")


class DenseForkChoiceParityMonitor(DenseMonitor):
    """Device/host-walk head parity per view, under attack traffic."""

    name = "forkchoice_parity"

    def __init__(self, every: int = 1):
        self.every = int(every)

    def describe(self) -> dict:
        return {"kind": type(self).__name__, "every": self.every}

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        if self.every <= 0 or slot % self.every != 0:
            return []
        out = []
        for g in range(sim.n_groups):
            # a fresh POST-vote device head query (the proposed block is
            # not the head when an attack reorgs mid-slot) vs the
            # independent host walk over the gathered table
            device = sim.roots[sim._head(g)]
            walk = sim.head_host_walk(g)
            if device != walk:
                out.append({
                    "monitor": self.name,
                    "kind": "parity_violation",
                    "group": g,
                    "slot": int(slot),
                    "device_head": device.hex()[:16],
                    "spec_head": walk.hex()[:16],
                    "detail": (f"view {g} device head diverged from the "
                               f"host spec-walk at slot {slot}"),
                })
        return out


def default_dense_monitors(bound_epochs: int = 4,
                           parity_every: int = 1) -> list[DenseMonitor]:
    """The full dense audit stack (dense chaos fuzzing default)."""
    return [DenseAccountableSafetyMonitor(),
            DenseFinalityLivenessMonitor(bound_epochs=bound_epochs),
            DenseForkChoiceParityMonitor(every=parity_every),
            DenseVariantSafetyMonitor()]


_MONITORS = {
    "DenseAccountableSafetyMonitor": DenseAccountableSafetyMonitor,
    "DenseVariantSafetyMonitor": DenseVariantSafetyMonitor,
    "DenseFinalityLivenessMonitor": DenseFinalityLivenessMonitor,
    "DenseForkChoiceParityMonitor": DenseForkChoiceParityMonitor,
}


def dense_monitor_from_config(d: dict) -> DenseMonitor:
    """Rebuild a monitor from its ``describe()`` dict."""
    kind = d["kind"]
    cls = _MONITORS.get(kind)
    if cls is None:
        raise ValueError(f"unknown dense monitor kind {kind!r}")
    if kind == "DenseFinalityLivenessMonitor":
        return cls(bound_epochs=d.get("bound_epochs", 4),
                   armed_after_epoch=d.get("armed_after_epoch"))
    if kind == "DenseForkChoiceParityMonitor":
        return cls(every=d.get("every", 1))
    return cls()
