"""Vectorized Byzantine strategies for the dense driver (port of
``pos_evolution_tpu/sim/dense_adversary.py``, host numpy as there).

A strategy is a masked transform over the message tables: per slot it
emits ``VoteBatch``\\ es (a bool[N] origination mask and a target block
index) and, for the chain-building strategies, extra block-tree entries.
The driver applies the batches through the same fault-masked vote
landing as the honest path, and the dense monitors observe them at
origination. Every decision is a pure function of (strategy seed, slot,
validator) through the ``stateless_unit`` hashes.

- ``DenseEquivocator``: double proposals and double votes on active
  slots; the accountable-safety monitor implicates every double voter.
- ``DenseWithholder``: a private chain behind a visibility mask, banked
  committee votes, all released in one burst at ``release_slot``.
- ``DenseExAnteReorg``: the slot-F proposal withheld and voted by the
  controlled duty slices for ``span`` slots, then revealed.
- ``DenseSplitVoter``: on a fully partitioned two-view network every
  controlled validator votes both views' heads.
- ``DenseBalancer``: swayer balancing on a delay-partitioned two-view
  network, holding the global tie so that no view justifies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pos_evolution_tpu_torch.sim.faults import stateless_unit

__all__ = [
    "VoteBatch", "DenseAdversaryStrategy", "DenseEquivocator",
    "DenseWithholder", "DenseExAnteReorg", "DenseSplitVoter",
    "DenseBalancer", "DENSE_STRATEGIES", "dense_adversary_from_config",
]


@dataclass
class VoteBatch:
    """One masked vote broadcast: ``mask`` validators vote ``block`` with
    target ``epoch``, delivered to ``views`` (None = every view). The
    mask is the ORIGINATION set — the driver composes the fault-plan
    drop/delay/crash masks on top before the table write, and the
    monitors tap the origination mask (evidence of a violation can be
    observed even when some recipients never get the vote)."""

    mask: np.ndarray
    block: int
    epoch: int
    views: tuple | None = None
    # None: the driver derives the FFG target-match per view (the flag
    # lands only where the vote's chain matches the view's checkpoint);
    # an explicit bool forces it (used by tests)
    flag: bool | None = None
    faultable: bool = True
    # origination slot (None = the delivery slot). Carried so expiry
    # windows and the per-slot variant tallies judge the CAST slot even
    # when the batch lands late (fault delays, banked releases)
    slot: int | None = None

    def for_view(self, g: int) -> bool:
        return self.views is None or g in self.views


class DenseAdversaryStrategy:
    """Base: holds the controlled index set and no-ops every hook.

    Hook contract (driven by ``DenseSimulation.run_slot``):

    - ``before_propose(sim, slot)``: before heads are computed — the
      release point (withheld chains become visible, banked votes go
      through the fault-masked apply path so a timely release lands
      ahead of the slot's honest votes);
    - ``on_proposals(sim, slot, new_idx)``: after the per-view honest
      blocks land in the tree — append equivocating siblings / private
      extensions via ``sim.adversary_block``;
    - ``vote_batches(sim, slot, new_idx)``: the slot's adversarial vote
      transforms, as ``VoteBatch``\\ es applied after the honest batch.

    Controlled validators are excluded from the honest duty mask at
    bind (the dense mirror of folding into ``Schedule.corrupted``):
    Byzantine actions happen only through the hooks.
    """

    name = "dense_adversary"

    def __init__(self, controlled=()):
        self.controlled = np.asarray(sorted(int(v) for v in controlled),
                                     dtype=np.int64)

    def bind(self, sim) -> None:
        self.sim = sim
        self.controlled_mask = np.zeros(sim.n, dtype=bool)
        self.controlled_mask[self.controlled[self.controlled < sim.n]] = True

    def describe(self) -> dict:
        """Config fingerprint for checkpoints and repro bundles; the
        controlled set is stored as [lo, hi) ranges when contiguous so a
        1M-validator bundle stays readable."""
        return {"kind": type(self).__name__,
                "controlled": _ranges(self.controlled)}

    # -- hooks -----------------------------------------------------------------

    def before_propose(self, sim, slot: int) -> None:
        pass

    def on_proposals(self, sim, slot: int, new_idx: list) -> None:
        pass

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        return []

    # -- checkpoint support ----------------------------------------------------

    def state_meta(self) -> dict:
        """JSON-able mutable state (checkpoint/resume mid-attack)."""
        return {}

    def state_arrays(self) -> dict:
        """Large mutable state as numpy arrays (land in the npz)."""
        return {}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        pass

    # -- shared helpers --------------------------------------------------------

    def _mine(self, sim, slot: int) -> np.ndarray:
        """Controlled members of this slot's duty set, as a mask —
        the slot committee under Gasper, everyone under a
        full-participation variant (the adversary votes on the same
        schedule the honest set does)."""
        return self.controlled_mask & sim.duty_mask(slot)


def _ranges(idx: np.ndarray) -> list:
    """Compress a sorted index array to [lo, hi) ranges (JSON-able)."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return []
    cuts = np.where(np.diff(idx) != 1)[0]
    starts = np.concatenate([[0], cuts + 1])
    ends = np.concatenate([cuts, [idx.size - 1]])
    return [[int(idx[s]), int(idx[e]) + 1] for s, e in zip(starts, ends)]


def _from_ranges(ranges: list) -> np.ndarray:
    if not ranges:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate([np.arange(lo, hi, dtype=np.int64)
                           for lo, hi in ranges])


class DenseEquivocator(DenseAdversaryStrategy):
    """Double blocks and double votes at the array level: on active
    slots (a ``stateless_unit`` draw per slot), the slot's block gets an
    equivocating SIBLING (same parent, different root) and the
    controlled committee slice votes BOTH tips — two overlapping masked
    batches with different targets, which is exactly the double-vote
    shape the accountable-safety monitor implicates. On inactive slots
    the controlled slice votes the honest head, so a <1/3 equivocator
    never costs the run its finality. Single-view strategy (acts on
    view 0)."""

    name = "dense_equivocator"

    def __init__(self, controlled=(), p_fork: float = 0.5, seed: int = 0):
        super().__init__(controlled)
        self.p_fork = float(p_fork)
        self.seed = int(seed)
        self._sibling: int | None = None
        self._sibling_slot = -1

    def describe(self) -> dict:
        d = super().describe()
        d.update(p_fork=self.p_fork, seed=self.seed)
        return d

    def _active(self, slot: int) -> bool:
        return stateless_unit(self.seed, 30, slot) < self.p_fork

    def on_proposals(self, sim, slot: int, new_idx: list) -> None:
        self._sibling = None
        if not self._active(slot):
            return
        honest = new_idx[0]
        parent = sim.parents[honest]
        self._sibling = sim.adversary_block(parent, slot,
                                            tag=(b"equiv", self.seed))
        self._sibling_slot = slot

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        mine = self._mine(sim, slot)
        if not mine.any():
            return []
        epoch = slot // sim.S
        if self._sibling is None or self._sibling_slot != slot:
            return [VoteBatch(mine, new_idx[0], epoch, views=(0,))]
        # the double vote: same mask, two targets, observed by the tap
        return [VoteBatch(mine, new_idx[0], epoch, views=(0,)),
                VoteBatch(mine.copy(), self._sibling, epoch, views=(0,))]

    def state_meta(self) -> dict:
        return {"sibling": self._sibling, "sibling_slot": self._sibling_slot}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self._sibling = meta.get("sibling")
        self._sibling_slot = meta.get("sibling_slot", -1)


class DenseWithholder(DenseAdversaryStrategy):
    """The ex-ante reorg as masks: from ``fork_slot`` the strategy grows
    a PRIVATE chain (blocks appended behind the per-view visibility
    mask — honest fork choice cannot see them) while banking its
    controlled committee votes for the private tip as unapplied
    batches; at ``release_slot`` the chain flips visible and the bank
    goes through the normal fault-masked vote apply in one burst,
    before the slot's honest votes. The reorg succeeds iff the banked
    weight beats the honest weight on the competing public blocks —
    against an honest majority it must fail (the clean-episode pin)."""

    name = "dense_withholder"

    def __init__(self, controlled=(), fork_slot: int = 2,
                 release_slot: int = 4):
        super().__init__(controlled)
        self.fork_slot = int(fork_slot)
        self.release_slot = int(release_slot)
        self.priv: list[int] = []       # private block indices
        self.bank: list[VoteBatch] = []
        self.released = False

    def describe(self) -> dict:
        d = super().describe()
        d.update(fork_slot=self.fork_slot, release_slot=self.release_slot)
        return d

    @property
    def tip(self) -> int | None:
        return self.priv[-1] if self.priv else None

    def before_propose(self, sim, slot: int) -> None:
        if self.released or slot != self.release_slot or not self.priv:
            if slot == self.release_slot:
                self.released = True
            return
        self.released = True
        sim.reveal_blocks(self.priv)
        # the timed release: banked votes land through the fault-masked
        # apply path NOW, so the head every honest validator computes
        # this slot already weighs the private chain
        sim.apply_votes_now(self.bank, slot)
        self.bank = []

    def on_proposals(self, sim, slot: int, new_idx: list) -> None:
        if not (self.fork_slot <= slot < self.release_slot):
            return
        parent = self.tip if self.tip is not None \
            else sim.parents[new_idx[0]]
        self.priv.append(sim.adversary_block(
            parent, slot, tag=(b"withheld", self.fork_slot),
            visible=False))

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        mine = self._mine(sim, slot)
        if not mine.any():
            return []
        epoch = slot // sim.S
        if self.fork_slot <= slot < self.release_slot and self.tip is not None:
            # private votes: banked, not broadcast (nothing to observe)
            self.bank.append(VoteBatch(mine, self.tip, epoch))
            return []
        return [VoteBatch(mine, new_idx[0], epoch, views=(0,))]

    def state_meta(self) -> dict:
        return {"priv": list(self.priv), "released": self.released,
                "bank": [{"block": b.block, "epoch": b.epoch}
                         for b in self.bank]}

    def state_arrays(self) -> dict:
        return {f"bank{j}_idx": np.flatnonzero(b.mask).astype(np.int64)
                for j, b in enumerate(self.bank)}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.priv = [int(i) for i in meta.get("priv", [])]
        self.released = bool(meta.get("released", False))
        self.bank = []
        for j, b in enumerate(meta.get("bank", [])):
            mask = np.zeros(self.sim.n, dtype=bool)
            mask[arrays[f"bank{j}_idx"]] = True
            self.bank.append(VoteBatch(mask, int(b["block"]),
                                       int(b["epoch"])))


class DenseExAnteReorg(DenseAdversaryStrategy):
    """Committee-targeted multi-slot ex-ante reorg — the
    attack the proposer-boost / full-participation matrix cells judge.

    Unlike ``DenseWithholder`` (private SIBLING chain + vote bank held
    OUT of the table), this is the pos-evolution.md:1495 shape: the
    adversary **controls the slot-F proposer**, withholds that slot's
    legitimate proposal (``sim.withhold_proposal`` — honest duty falls
    back to voting its parent), and for ``span`` slots votes the hidden
    block with its controlled duty slices THROUGH the normal table
    path. The banked weight is real latest-message state, but the head
    kernels weigh only visible blocks, so it is inert until
    ``reveal_blocks`` at slot ``F + span`` — where it lands all at once
    against the public branch the honest committees built meanwhile.

    Per-variant verdicts (the dense matrix pins):

    - Gasper, no boost: disjoint committees mean the bank accumulates
      ``span * f`` committees against the single honest committee
      backing the public tip — at f=0.35, span=2 the reorg SUCCEEDS;
    - Gasper, boost=40: the propose-time head query at the release slot
      carries the previous proposal's boost, outweighing the bank —
      defended;
    - Goldfish/RLMD/SSF (full participation): every honest validator
      re-votes the public branch every slot while the bank collapses to
      one latest-message stamp of ``f * total`` — structurally
      defended (and under Goldfish's eta=1 the early stamps expire
      outright).
    """

    name = "dense_exante_reorg"

    def __init__(self, controlled=(), fork_slot: int = 2, span: int = 2):
        super().__init__(controlled)
        self.fork_slot = int(fork_slot)
        self.span = max(int(span), 1)
        self.priv: list[int] = []       # the withheld proposal
        self.honest_tip: int | None = None  # public tip at release
        self.released = False

    def describe(self) -> dict:
        d = super().describe()
        d.update(fork_slot=self.fork_slot, span=self.span)
        return d

    def before_propose(self, sim, slot: int) -> None:
        if (slot == self.fork_slot + self.span and not self.released
                and self.priv):
            self.released = True
            # public tip NOW is what the reorg must beat; the matrix
            # verdict compares the post-release head against both
            self.honest_tip = sim._head(0)
            sim.reveal_blocks(self.priv)

    def on_proposals(self, sim, slot: int, new_idx: list) -> None:
        if slot == self.fork_slot and not self.priv:
            sim.withhold_proposal(0, new_idx[0])
            self.priv = [new_idx[0]]

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        mine = self._mine(sim, slot)
        if not mine.any():
            return []
        epoch = slot // sim.S
        if (self.priv and not self.released
                and self.fork_slot <= slot < self.fork_slot + self.span):
            # the bank: real table writes for an invisible target —
            # weightless in every honest head query until the release
            return [VoteBatch(mine, self.priv[0], epoch)]
        return [VoteBatch(mine, new_idx[0], epoch, views=(0,))]

    def state_meta(self) -> dict:
        return {"priv": list(self.priv), "released": self.released,
                "honest_tip": self.honest_tip}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.priv = [int(i) for i in meta.get("priv", [])]
        self.released = bool(meta.get("released", False))
        ht = meta.get("honest_tip")
        self.honest_tip = None if ht is None else int(ht)


class DenseSplitVoter(DenseAdversaryStrategy):
    """Coherent equivocation that kills safety: on a fully partitioned
    2-view network every controlled committee member votes BOTH views'
    heads every slot — one masked batch per view, each delivered only
    to its view. With exactly 1/3 of stake controlled and the honest
    set split evenly, each view tallies 2/3 target participation,
    justifies and finalizes its own chain, and the cross-view
    double-vote masks implicate exactly the controlled third: the
    Casper FFG accountable-safety theorem, operational at mainnet
    scale (the CHAOS_DENSE acceptance pin)."""

    name = "dense_split_voter"

    def bind(self, sim) -> None:
        super().bind(sim)
        plan = sim.fault_plan
        if sim.n_groups != 2 or plan is None or plan.partition != "full":
            raise ValueError("DenseSplitVoter needs two views on a fully "
                             "partitioned network")

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        mine = self._mine(sim, slot)
        if not mine.any():
            return []
        epoch = slot // sim.S
        return [VoteBatch(mine.copy(), new_idx[g], epoch, views=(g,))
                for g in range(sim.n_groups)]


class DenseBalancer(DenseAdversaryStrategy):
    """Swayer balancing, vectorized. The per-message strategy banks
    withheld votes and releases them per view "just before the
    attestation deadline"; this aggregate form is the same attack. The
    key dense fact is that fork-choice weight lives in a LATEST-message
    table: an honest validator
    re-voting its own chain moves nothing, a swayer flipping chains
    swings the tie by 2, and a first-time voter by 1. So the strategy
    balances the TABLE, not a vote stream:

    - it tracks every controlled validator's current table chain
      (``assign``) and which honest validators have voted at all
      (``voted`` — only first votes move weight);
    - each slot it cancels the honest first-vote imbalance with its
      controlled committee slice (±1 moves) and any carried residual
      with chain switches (±2 moves), keeping the global A-minus-B
      weight within ±1 forever;
    - it keeps the two views APART with one paired switch per slot
      (one A->B swayer and one B->A swayer), each delivered to the
      favored view immediately and to the other a slot late — every
      view's slot-start snapshot shows its own chain leading by ~2,
      the dense image of the deadline-timed release (swayers never
      double-vote: one vote per epoch, chain flips across epochs are
      honest-looking LMD updates, exactly as in the reference).

    Result: no view ever flips, each view's target quorum stays pinned
    near 1/2 < 2/3, and justification stalls — the balancing liveness
    attack, sustained for as long as every slot's controlled committee
    slice carries both chains (the reference's :1330 precondition,
    surfaced in ``infeasible_slots`` when it fails)."""

    name = "dense_balancer"

    def __init__(self, controlled=()):
        super().__init__(controlled)
        self.residual = 0   # table A-minus-B imbalance carried forward
        self.infeasible_slots: list[int] = []

    def bind(self, sim) -> None:
        super().bind(sim)
        plan = sim.fault_plan
        if sim.n_groups != 2 or plan is None or plan.partition != "delay":
            raise ValueError("DenseBalancer needs two views with the one-slot "
                             "cross-view delay")
        self._assign = np.full(sim.n, -1, dtype=np.int8)  # -1/0=A/1=B
        self._voted = np.zeros(sim.n, dtype=bool)

    def vote_batches(self, sim, slot: int, new_idx: list) -> list:
        committee = sim.committee_mask(slot)
        honest = committee & ~sim.controlled_any
        first_a = honest & (sim.group_of == 0) & ~self._voted
        first_b = honest & (sim.group_of == 1) & ~self._voted
        self._voted |= honest
        t = self.residual + int(first_a.sum()) - int(first_b.sum())
        members = np.flatnonzero(self.controlled_mask & committee)
        epoch = slot // sim.S
        if members.size == 0:
            if t != self.residual:
                self.infeasible_slots.append(slot)
            self.residual = t
            return []
        to_a: list[int] = []
        to_b: list[int] = []
        switch_a = switch_b = None   # the per-slot view-separating pair
        # phase 1: first-time swayers cancel the ±1 imbalance
        fresh = members[self._assign[members] == -1]
        seasoned = members[self._assign[members] != -1]
        for m in fresh:
            if t <= 0:
                to_a.append(m); self._assign[m] = 0; t += 1
            else:
                to_b.append(m); self._assign[m] = 1; t -= 1
        # phase 2: corrective switches (±2) until |t| <= 1
        pool_a = [m for m in seasoned if self._assign[m] == 0]
        pool_b = [m for m in seasoned if self._assign[m] == 1]
        while t > 1 and pool_a:
            m = pool_a.pop(0)
            to_b.append(m); self._assign[m] = 1; t -= 2
            switch_b = m
        while t < -1 and pool_b:
            m = pool_b.pop(0)
            to_a.append(m); self._assign[m] = 0; t += 2
            switch_a = m
        if abs(t) > 1:
            self.infeasible_slots.append(slot)
        # phase 3: the oscillating pair keeps each view's own chain
        # ahead at its decision point (net-zero on the global tie)
        if switch_a is None and switch_b is None and pool_a and pool_b:
            m_ab = pool_a.pop(0)
            to_b.append(m_ab); self._assign[m_ab] = 1
            switch_b = m_ab
            m_ba = pool_b.pop(0)
            to_a.append(m_ba); self._assign[m_ba] = 0
            switch_a = m_ba
        for m in pool_a:
            to_a.append(m)
        for m in pool_b:
            to_b.append(m)
        self.residual = t
        out = []
        for chain, voters in ((0, to_a), (1, to_b)):
            if not voters:
                continue
            mask = np.zeros(sim.n, dtype=bool)
            mask[voters] = True
            # favored view sees the vote now; the other a slot late —
            # the deadline-timed release, one slot of skew
            out.append(VoteBatch(mask, new_idx[chain], epoch,
                                 views=(chain,)))
            late = VoteBatch(mask.copy(), new_idx[chain], epoch,
                             views=(1 - chain,))
            sim.views[1 - chain].pending.append(late)
        return out

    def state_meta(self) -> dict:
        return {"residual": self.residual,
                "infeasible_slots": list(self.infeasible_slots)}

    def state_arrays(self) -> dict:
        return {"assign": self._assign, "voted": self._voted}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.residual = int(meta.get("residual", 0))
        self.infeasible_slots = [int(s) for s in
                                 meta.get("infeasible_slots", [])]
        self._assign = np.asarray(arrays["assign"], dtype=np.int8).copy()
        self._voted = np.asarray(arrays["voted"], dtype=bool).copy()


DENSE_STRATEGIES = {
    "DenseEquivocator": DenseEquivocator,
    "DenseWithholder": DenseWithholder,
    "DenseExAnteReorg": DenseExAnteReorg,
    "DenseSplitVoter": DenseSplitVoter,
    "DenseBalancer": DenseBalancer,
}


def dense_adversary_from_config(d: dict) -> DenseAdversaryStrategy:
    """Rebuild a strategy from its ``describe()`` dict (checkpoint
    resume and chaos-bundle replay)."""
    kind = d["kind"]
    cls = DENSE_STRATEGIES.get(kind)
    if cls is None:
        raise ValueError(f"unknown dense strategy kind {kind!r}")
    controlled = _from_ranges(d.get("controlled", []))
    kwargs = {}
    if kind == "DenseEquivocator":
        kwargs = {"p_fork": d.get("p_fork", 0.5), "seed": d.get("seed", 0)}
    elif kind == "DenseWithholder":
        kwargs = {"fork_slot": d.get("fork_slot", 2),
                  "release_slot": d.get("release_slot", 4)}
    elif kind == "DenseExAnteReorg":
        kwargs = {"fork_slot": d.get("fork_slot", 2),
                  "span": d.get("span", 2)}
    return cls(controlled=controlled, **kwargs)
