"""Dense protocol variants (port of ``pos_evolution_tpu/sim/dense_variants.py``).

Each variant is a small policy object the dense driver consults:

- **expiry window** (Goldfish eta=1, RLMD eta=4, SSF eta=4): the head
  query drops votes stamped outside the window (``expiry_kernel``)
  before the unchanged vote-weights pass (pos-evolution.md:1585);
- **per-slot confirmation / SSF gadget**: ``on_slot_end`` tallies the
  slot's full-participation votes (``slot_vote_tally``) and, for SSF,
  the acknowledgments (``slot_ack_tally``), both on the
  ``ops/variant_tally`` host oracles over the view's columns read back
  from the device;
- **view-merge** (pos-evolution.md:1560): one merged vote target per
  slot and proposals revealed across views in-slot, unless the network
  is fully partitioned;
- **proposer boost**: ``boost_percent`` of one slot's share of the
  total stake, in the device descent and in the host walk alike.

``describe()`` rides the dense checkpoint, and ``DenseSimulation.resume``
refuses a resume under another variant when asked to.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.convert import to_numpy
from pos_evolution_tpu_torch.ops.variant_tally import link_tally_host, windowed_vote_tally_host

__all__ = [
    "DenseProtocolVariant",
    "DenseGasper",
    "DenseGoldfish",
    "DenseRlmd",
    "DenseSsf",
    "DENSE_VARIANTS",
    "dense_variant_from_config",
    "dense_rider_from_config",
    "expiry_kernel",
    "slot_vote_tally",
    "slot_ack_tally",
    "variant_tally_parity",
]


# --- tally plumbing -----------------------------------------------------------


def _columns(sim, g: int):
    """View ``g``'s (msg_block, msg_slot, effective_balance) as numpy."""
    view = sim.views[g]
    return (to_numpy(view.msg_block)[: sim.n], to_numpy(view.msg_slot)[: sim.n],
            to_numpy(view.registry.effective_balance)[: sim.n])


def slot_vote_tally(sim, g: int, slot: int) -> np.ndarray:
    """int64[capacity]: per-block stake of view ``g``'s latest head votes
    stamped exactly ``slot`` (the justification support of the per-slot
    gadgets), by the ``ops/variant_tally`` host oracle."""
    mb, ms, eb = _columns(sim, g)
    return windowed_vote_tally_host(mb, ms, eb, np.ones(sim.n, dtype=bool), slot, slot,
                                    sim.capacity)


def slot_ack_tally(sim, g: int, slot: int) -> np.ndarray:
    """int64[capacity]: the acknowledgment tally (pos-evolution.md:1646):
    the slot-stamped head votes as ack ids, summed per block by the
    link-tally oracle."""
    mb, ms, eb = _columns(sim, g)
    return link_tally_host(np.where(ms == slot, mb, -1), eb, np.ones(sim.n, dtype=bool),
                           sim.capacity)


def variant_tally_parity(sim, g: int, slot: int) -> bool:
    """The windowed tally against its host oracle. On a single device
    ``slot_vote_tally`` is the oracle itself, so this holds trivially; it
    binds once a sharded tally exists."""
    return bool(np.array_equal(slot_vote_tally(sim, g, slot), windowed_vote_tally_host(
        *_columns(sim, g), np.ones(sim.n, dtype=bool), slot, slot, sim.capacity)))


def expiry_kernel(msg_block: torch.Tensor, msg_slot: torch.Tensor, lo: int,
                  hi: int) -> torch.Tensor:
    """The message table with votes stamped outside ``[lo, hi]`` set to
    -1 (no vote), on the table's device."""
    live = (msg_slot >= lo) & (msg_slot <= hi)
    return torch.where(live, msg_block, -1)


# --- the variant policy objects -----------------------------------------------


class DenseProtocolVariant:
    """Base policy = dense Gasper: committee duty, LMD (no expiry), FFG
    finality from the driver's epoch machinery, optional proposer boost.

    The driver consults exactly these hooks:

    - ``window(at_slot)``     -> expiry window for the head query (None
      = LMD), applied identically in the device descent and the
      host-walk oracle;
    - ``anchor(g)``           -> descent-start override (None = the
      view's FFG-justified index);
    - ``admit(vote_slot, at)``-> landing-time staleness gate (RLMD);
    - ``on_slot_end``         -> the per-slot tallies/gadgets, charged
      to the ``variant_tally`` phase;
    - ``describe()``          -> the checkpoint fingerprint;
    - ``doctor()``            -> forged fault for monitor negatives.
    """

    name = "gasper"
    full_participation = False   # duty = slot committee
    view_merge = False
    eta: int | None = None       # expiry window in slots (None = LMD)
    kappa: int | None = None     # confirmation depth
    fast_confirm: tuple[int, int] | None = None  # (num, den) threshold

    def __init__(self, boost_percent: int = 0):
        self.boost_percent = int(boost_percent)
        self.sim = None
        self.decisions: list[dict] = []

    def bind(self, sim) -> None:
        self.sim = sim

    def describe(self) -> dict:
        return {"kind": self.name, "boost_percent": self.boost_percent}

    def window(self, at_slot: int) -> tuple[int, int] | None:
        if self.eta is None:
            return None
        return (max(at_slot - self.eta, 0), at_slot - 1)

    def admit(self, vote_slot: int, at_slot: int) -> bool:
        return True

    def anchor(self, g: int) -> int | None:
        return None

    def latest_decision(self, sim, g: int) -> tuple[int, int] | None:
        """(slot, block index) of the view's newest finality-grade
        decision — what the dense light clients follow. Gasper's is the
        FFG-finalized checkpoint (epoch granularity)."""
        e, idx = sim.views[g].finalized
        if e == 0 and idx == 0:
            return None
        return (int(e) * sim.S, int(idx))

    def on_slot_end(self, sim, slot: int, targets) -> None:
        return None

    def doctor(self, sim, slot: int) -> bool:
        return False

    def summary_fields(self, sim) -> dict:
        """Variant-specific run-summary block (empty for Gasper, whose
        finality already lives in the driver's FFG fields)."""
        return {}

    def state_meta(self) -> dict:
        return {"decisions": [dict(d) for d in self.decisions]}

    def restore_state(self, meta: dict) -> None:
        self.decisions = [dict(d) for d in meta.get("decisions", [])]

    def _log(self, sim, g: int, slot: int, rule: str, idx: int,
             weight: int | None = None) -> None:
        d = {"slot": int(slot), "view": int(g), "rule": rule,
             "idx": int(idx), "root": sim.roots[idx].hex()[:16]}
        if weight is not None:
            d["weight"] = int(weight)
        self.decisions.append(d)

    def _doctor_pair(self, sim, slot: int) -> tuple[int, int] | None:
        """Two freshly forged sibling blocks for the negative controls
        (deterministic roots, visible everywhere)."""
        if sim.n_groups < 2:
            return None
        a = sim.adversary_block(0, slot, tag=(b"doctor", 0))
        b = sim.adversary_block(0, slot, tag=(b"doctor", 1))
        return a, b


class DenseGasper(DenseProtocolVariant):
    """Dense Gasper: committee LMD-GHOST
    + epoch FFG, with the proposer-boost knob the ex-ante matrix cells
    flip (``boost_percent=0`` reproduces the reorg, 40 defends)."""

    name = "gasper"


class _DenseExpiryVariant(DenseProtocolVariant):
    """Shared Goldfish/RLMD machinery: full-participation per-slot
    voting, view-merge, expiry-windowed heads, fast (3/4) + kappa-deep
    confirmation anchoring the descent."""

    full_participation = True
    view_merge = True
    kappa = 4
    fast_confirm = (3, 4)

    def bind(self, sim) -> None:
        super().bind(sim)
        self.conf_idx = [0] * sim.n_groups

    def describe(self) -> dict:
        d = super().describe()
        d.update(eta=self.eta, kappa=self.kappa,
                 fast_confirm=list(self.fast_confirm))
        return d

    def anchor(self, g: int) -> int:
        return self.conf_idx[g]

    def latest_decision(self, sim, g: int) -> tuple[int, int] | None:
        for d in reversed(self.decisions):
            if d["view"] == g:
                return (d["slot"], d["idx"])
        return None

    def on_slot_end(self, sim, slot: int, targets) -> None:
        num, den = self.fast_confirm
        for g in range(sim.n_groups):
            tgt = int(targets[g])
            w = int(slot_vote_tally(sim, g, slot)[tgt])
            if w * den >= sim.total_stake * num:
                cand, rule = tgt, "fast_confirm"
            else:
                # kappa-deep: the chain kappa blocks above the slot's
                # target has survived kappa rounds of voting
                cand, rule = tgt, "kappa_confirm"
                for _ in range(self.kappa):
                    if cand <= 0:
                        break
                    cand = sim.parents[cand]
                cand = max(cand, 0)
            if cand != self.conf_idx[g] and sim._descends(
                    cand, self.conf_idx[g]):
                self.conf_idx[g] = cand
                self._log(sim, g, slot, rule, cand, w)

    def doctor(self, sim, slot: int) -> bool:
        pair = self._doctor_pair(sim, slot)
        if pair is None:
            return False
        a, b = pair
        self.conf_idx[0], self.conf_idx[1] = a, b
        self._log(sim, 0, slot, "fast_confirm", a)
        self._log(sim, 1, slot, "fast_confirm", b)
        return True

    def summary_fields(self, sim) -> dict:
        return {"confirmed_idx": [int(x) for x in self.conf_idx],
                "confirmed_roots": [sim.roots[x].hex()[:16]
                                    for x in self.conf_idx]}

    def state_meta(self) -> dict:
        m = super().state_meta()
        m["conf_idx"] = [int(x) for x in self.conf_idx]
        return m

    def restore_state(self, meta: dict) -> None:
        super().restore_state(meta)
        if "conf_idx" in meta:
            self.conf_idx = [int(x) for x in meta["conf_idx"]]


class DenseGoldfish(_DenseExpiryVariant):
    """Goldfish at the array level: eta=1 (only the previous slot's
    votes weigh — GHOST-Eph, pos-evolution.md:1549), view-merge, full
    participation. Vote banking dies by construction: a banked vote is
    expired before it can sway anything."""

    name = "goldfish"
    eta = 1


class DenseRlmd(_DenseExpiryVariant):
    """RLMD-GHOST: expiry window eta slots plus the landing-time
    staleness gate — a vote originated before ``at_slot - 1`` is not
    merged into the view at all (pos-evolution.md:1596), so a withheld
    release of old votes lands nothing."""

    name = "rlmd"
    eta = 4

    def admit(self, vote_slot: int, at_slot: int) -> bool:
        return vote_slot >= at_slot - 1


class DenseSsf(DenseProtocolVariant):
    """The per-slot SSF gadget over the dense columns: justification
    support = this slot's windowed tally at the view's target, the
    acknowledgment tally finalizes in-slot (pos-evolution.md:1624-1650,
    the vote-then-ack round collapsed onto the honest schedule where
    acks equal votes). Justified anchors the descent; conflicting
    per-view finalizations are the accountable-safety evidence the
    dense variant monitor prices at exactly the double-voting third."""

    name = "ssf"
    full_participation = True
    view_merge = True
    eta = 4

    def bind(self, sim) -> None:
        super().bind(sim)
        self.just = [[0, 0] for _ in range(sim.n_groups)]  # [slot, idx]
        self.fin = [[0, 0] for _ in range(sim.n_groups)]
        self.fin_log: list[list[list[int]]] = [
            [] for _ in range(sim.n_groups)]

    def describe(self) -> dict:
        d = super().describe()
        d["eta"] = self.eta
        return d

    def anchor(self, g: int) -> int:
        return self.just[g][1]

    def latest_decision(self, sim, g: int) -> tuple[int, int] | None:
        s, idx = self.fin[g]
        if s == 0 and idx == 0:
            return None
        return (int(s), int(idx))

    def on_slot_end(self, sim, slot: int, targets) -> None:
        for g in range(sim.n_groups):
            tgt = int(targets[g])
            if not sim._descends(tgt, self.just[g][1]):
                continue
            support = int(slot_vote_tally(sim, g, slot)[tgt])
            if 3 * support < 2 * sim.total_stake:
                continue
            self.just[g] = [slot, tgt]
            self._log(sim, g, slot, "justify", tgt, support)
            ack = int(slot_ack_tally(sim, g, slot)[tgt])
            if 3 * ack >= 2 * sim.total_stake:
                self.fin[g] = [slot, tgt]
                self.fin_log[g].append([slot, tgt])
                self._log(sim, g, slot, "finalize", tgt, ack)

    def doctor(self, sim, slot: int) -> bool:
        pair = self._doctor_pair(sim, slot)
        if pair is None:
            return False
        a, b = pair
        self.fin[0], self.fin[1] = [slot, a], [slot, b]
        self.fin_log[0].append([slot, a])
        self.fin_log[1].append([slot, b])
        self._log(sim, 0, slot, "finalize", a)
        self._log(sim, 1, slot, "finalize", b)
        return True

    def summary_fields(self, sim) -> dict:
        return {"justified": [list(x) for x in self.just],
                "finalized": [list(x) for x in self.fin],
                "finalizations": [len(lg) for lg in self.fin_log]}

    def state_meta(self) -> dict:
        m = super().state_meta()
        m.update(just=[list(x) for x in self.just],
                 fin=[list(x) for x in self.fin],
                 fin_log=[[list(e) for e in lg] for lg in self.fin_log])
        return m

    def restore_state(self, meta: dict) -> None:
        super().restore_state(meta)
        if "just" in meta:
            self.just = [[int(a), int(b)] for a, b in meta["just"]]
            self.fin = [[int(a), int(b)] for a, b in meta["fin"]]
            self.fin_log = [[[int(a), int(b)] for a, b in lg]
                            for lg in meta["fin_log"]]


DENSE_VARIANTS = {
    "gasper": DenseGasper,
    "goldfish": DenseGoldfish,
    "rlmd": DenseRlmd,
    "ssf": DenseSsf,
}


def dense_variant_from_config(d) -> DenseProtocolVariant:
    """Variant from a ``describe()`` dict / name / instance — the resume
    side of the checkpoint fingerprint (round-trips ``describe()``)."""
    if d is None:
        return DenseGasper()
    if isinstance(d, DenseProtocolVariant):
        return d
    if isinstance(d, str):
        return DENSE_VARIANTS[d]()
    return DENSE_VARIANTS[d["kind"]](
        boost_percent=int(d.get("boost_percent", 0)))


def dense_rider_from_config(d):
    """Workload riders (the DAS sidecar plane and light-client
    populations) are not ported yet: any rider config raises."""
    if d is None:
        return None
    kind = d.get("kind") if isinstance(d, dict) else type(d).__name__
    raise ValueError(f"dense rider {kind!r}: riders are not ported yet "
                     "(ROADMAP Queue 1 item 5, sync, DAS and KZG)")
