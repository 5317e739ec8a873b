"""In-loop Byzantine adversary engine (pos-evolution.md:1319-1527).

The attack reproductions used to live outside the driver as one-shot
scripts (``sim/attacks.py``). This module makes the adversary a
first-class *participant* of ``Simulation``: a pluggable
``AdversaryStrategy`` acts every slot over its controlled validator
indices, with exactly the reference's adversarial powers — equivocation,
private chains with timed release, targeted just-in-time delivery
(pos-evolution.md:1328) — while the honest duty loop, the ``FaultPlan``
message faults, crash windows, telemetry, and the online monitors
(``sim/monitors.py``) all keep running around it.

Hook contract (driven by ``Simulation.run_slot`` for slots >= 1):

- ``before_propose(ctx)``: round 0, after queued deliveries, before the
  honest proposer acts — release withheld chains here so a timely
  adversarial block lands inside the proposer-boost window;
- ``before_attest(ctx)``: 1Δ into the slot, before honest committees
  vote — the "just before a certain point in time" delivery target of
  the balancing attacks;
- ``after_attest(ctx)``: end of slot, after honest votes are broadcast —
  bank withheld votes, record per-slot observations.

Strategies inject messages only through ``AdversaryContext.broadcast``,
which routes through the driver's ``_send`` — so adversarial traffic is
subject to the same FaultPlan drops/duplications/reorders, crash-window
blackouts, telemetry gossip spans, and monitor observation as honest
traffic (composability is the point).

Determinism: ``RandomByzantine`` draws every decision from the same
stateless seeded hash as ``FaultPlan`` (``sim/faults.stateless_unit``):
no RNG cursor, so a checkpointed run resumed mid-attack replays the
identical adversarial behavior, and episode ordering in the chaos fuzzer
cannot perturb any episode's attack pattern.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.sim.faults import stateless_unit
from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
)
from pos_evolution_tpu_torch.specs.transition import state_transition
from pos_evolution_tpu_torch.specs.validator import (
    advance_state_to_slot,
    build_block,
    make_committee_attestation,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root

# src-id namespace for adversarial attestation gossip: honest attestation
# spans use the view-group id as src (small ints), adversarial ones use
# ATT_SRC_BASE + validator index — distinct span/fault identities without
# colliding with any honest message.
ATT_SRC_BASE = 1_000


def slot_committee(state, slot: int) -> np.ndarray:
    """All committee members of ``slot``, concatenated (the per-slot W of
    the reference's attack arithmetic)."""
    epoch = compute_epoch_at_slot(slot)
    count = get_committee_count_per_slot(state, epoch)
    return np.concatenate([get_beacon_committee(state, slot, i)
                           for i in range(count)])


def committee_attestations(state, slot: int, head_root: bytes,
                           participants) -> list:
    """Aggregates restricted to ``participants`` across all committees of
    ``slot`` (empty committees skipped)."""
    participants = np.asarray(participants, dtype=np.int64)
    epoch = compute_epoch_at_slot(slot)
    count = get_committee_count_per_slot(state, epoch)
    out = []
    for index in range(count):
        try:
            out.append(make_committee_attestation(
                state, slot, index, head_root, participants=participants))
        except ValueError:
            continue
    return out


class AdversaryContext:
    """One strategy invocation's window into the simulation: omniscient
    reads (the reference adversary sees every honest view and knows
    honest decision times, pos-evolution.md:1328) plus targeted writes
    routed through the driver's delivery path."""

    def __init__(self, sim, slot: int, phase: str, now: float):
        self.sim = sim
        self.slot = slot
        self.phase = phase
        self.now = now
        self._msg_seq = 0

    # -- omniscient reads ------------------------------------------------------

    def store(self, group: int = 0) -> fc.Store:
        return self.sim.groups[group].store

    def head(self, group: int = 0) -> bytes:
        """The head as the run's protocol variant computes it (the
        adversary forks off what honest validators actually follow).
        Under the Gasper default this stays the spec walk, byte-identical
        to the pre-seam context."""
        sim = self.sim
        if sim.variant.needs_view:
            return sim.variant.head(sim, sim.groups[group])
        return fc.get_head(sim.groups[group].store)

    def n_groups(self) -> int:
        return len(self.sim.groups)

    # -- targeted writes -------------------------------------------------------

    def broadcast(self, kind: str, payload, *, src: int,
                  delay: float | dict = 0.0, groups=None,
                  msg_id: int | None = None) -> None:
        """Send one message through the driver's fault-aware delivery.

        ``delay`` seconds after ``now`` (or a per-group-id dict — the
        targeted-delivery power); ``groups`` restricts recipients (None =
        every view group). Blocks are registered in the block archive so
        ``_sync_ancestors`` backfill works for late receivers, exactly as
        for honest proposals."""
        sim = self.sim
        if msg_id is None:
            msg_id = self._msg_seq
            self._msg_seq += 1
        if kind == "block":
            sim.block_archive[hash_tree_root(payload.message)] = payload
        sim._observe(kind, payload)
        targets = (sim.groups if groups is None
                   else [sim.groups[g] for g in groups])
        for dst in targets:
            d = delay.get(dst.id, None) if isinstance(delay, dict) else delay
            sim._send(dst, self.now, d, kind, payload, self.slot,
                      src=int(src), msg_id=int(msg_id))

    def deliver(self) -> None:
        """Flush everything due at ``now`` into the stores — lets a
        strategy observe the effect of its own injection within the same
        hook (the swayer's release-until-leading loop)."""
        self.sim._tick_all(self.now)


class AdversaryStrategy:
    """Base strategy: holds the controlled validator set and no-ops every
    hook. ``controlled`` indices are folded into ``Schedule.corrupted``
    at bind time, so the honest duty loop never proposes or attests for
    them — Byzantine actions happen only through the hooks."""

    name = "adversary"

    def __init__(self, controlled=()):
        self.controlled = tuple(int(v) for v in controlled)

    def bind(self, sim) -> None:
        self.sim = sim

    def describe(self) -> dict:
        """Config fingerprint for repro bundles (scripts/chaos_fuzz.py)."""
        return {"kind": type(self).__name__,
                "controlled": list(self.controlled)}

    def before_propose(self, ctx: AdversaryContext) -> None:
        pass

    def before_attest(self, ctx: AdversaryContext) -> None:
        pass

    def after_attest(self, ctx: AdversaryContext) -> None:
        pass


class Equivocator(AdversaryStrategy):
    """Double proposals and double votes (pos-evolution.md:233-238,
    1154-1156): when a controlled validator is the proposer of an active
    slot it publishes TWO conflicting blocks; controlled attesters vote
    both fork tips. Pure evidence generator — the slasher must catch all
    of it and the fork-choice discounting must neutralize the votes."""

    name = "equivocator"

    def __init__(self, controlled=(), slots=None):
        super().__init__(controlled)
        self.slots = None if slots is None else set(int(s) for s in slots)

    def describe(self) -> dict:
        d = super().describe()
        d["slots"] = None if self.slots is None else sorted(self.slots)
        return d

    def _active(self, slot: int) -> bool:
        return self.slots is None or slot in self.slots

    def before_propose(self, ctx: AdversaryContext) -> None:
        if not self._active(ctx.slot):
            return
        store = ctx.store(0)
        head = ctx.head(0)
        head_state = advance_state_to_slot(store.block_states[head], ctx.slot)
        proposer = int(get_beacon_proposer_index(head_state))
        if proposer not in self.controlled:
            return
        parent_state = store.block_states[head]
        sb_a = build_block(parent_state, ctx.slot, graffiti=b"\xe1" * 32)
        sb_b = build_block(parent_state, ctx.slot, graffiti=b"\xe2" * 32)
        ctx.broadcast("block", sb_a, src=proposer, msg_id=0)
        ctx.broadcast("block", sb_b, src=proposer, msg_id=1)

    def before_attest(self, ctx: AdversaryContext) -> None:
        if not self._active(ctx.slot):
            return
        store = ctx.store(0)
        head = ctx.head(0)
        # two targets: the head and its highest-slot sibling-or-ancestor
        # fork tip (our own equivocating proposal when one exists)
        others = [r for r, b in store.blocks.items()
                  if r != head and int(b.slot) == ctx.slot]
        alt = max(others) if others else bytes(store.blocks[head].parent_root)
        if alt == head or alt not in store.block_states:
            return  # no second tip to equivocate onto (e.g. head == anchor)
        for root in (head, alt):
            state = advance_state_to_slot(store.block_states[root], ctx.slot)
            mine = [v for v in self.controlled
                    if v in set(int(i) for i in slot_committee(state, ctx.slot))]
            if not mine:
                return
            for att in committee_attestations(state, ctx.slot, root, mine):
                ctx.broadcast("attestation", att,
                              src=ATT_SRC_BASE + mine[0],
                              delay=float(self.sim.delta))


@dataclass
class _PrivateChain:
    """A withheld fork: blocks built but not broadcast, plus the private
    votes controlled validators cast on it."""

    parent_root: bytes = b""
    state: object = None          # post-state of the tip
    blocks: list = field(default_factory=list)
    votes: list = field(default_factory=list)

    @property
    def tip(self) -> bytes:
        return hash_tree_root(self.blocks[-1].message)


class Withholder(AdversaryStrategy):
    """Private chain + timed release — the generalized ex-ante reorg
    (pos-evolution.md:1503-1526). At ``fork_slot`` the strategy starts a
    private chain on the honest head; controlled proposers extend it and
    controlled attesters vote it privately for ``vote_slots``; at
    ``release_slot`` everything is published in one burst (optionally
    followed by a timely controlled proposal on the private tip, the
    boost-stealing step of the 7%/0.8W variant)."""

    name = "withholder"

    def __init__(self, controlled=(), fork_slot: int = 2,
                 release_slot: int = 3, release_phase: str = "before_attest",
                 vote_slots=(), private_attesters=None,
                 propose_on_release: bool = False):
        super().__init__(controlled)
        self.fork_slot = int(fork_slot)
        self.release_slot = int(release_slot)
        self.release_phase = release_phase
        self.vote_slots = tuple(int(s) for s in vote_slots)
        # slot -> validator indices voting the private tip that slot;
        # None = every controlled member of the slot's committee
        self.private_attesters = private_attesters or {}
        self.propose_on_release = bool(propose_on_release)
        self.chain = _PrivateChain()
        self.released = False

    def describe(self) -> dict:
        d = super().describe()
        d.update(fork_slot=self.fork_slot, release_slot=self.release_slot,
                 release_phase=self.release_phase,
                 vote_slots=list(self.vote_slots),
                 propose_on_release=self.propose_on_release)
        return d

    def _extend_private(self, ctx: AdversaryContext) -> None:
        store = ctx.store(0)
        head = ctx.head(0)
        parent_state = store.block_states[head]
        # stay inside the adversary model: the private block is signed by
        # the slot's rightful proposer, so the fork only starts if that
        # proposer is ours (the curated scenarios corrupt it explicitly;
        # chaos compositions simply skip the fork otherwise — forging an
        # honest proposer's signature would frame an honest validator)
        proposer = int(get_beacon_proposer_index(
            advance_state_to_slot(parent_state, ctx.slot)))
        if proposer not in self.controlled:
            return
        sb = build_block(parent_state, ctx.slot, graffiti=b"\xad" * 32)
        post = parent_state.copy()
        state_transition(post, sb, True)
        self.chain.parent_root = head
        self.chain.state = post
        self.chain.blocks.append(sb)

    def _vote_private(self, ctx: AdversaryContext) -> None:
        view = advance_state_to_slot(self.chain.state, ctx.slot)
        voters = self.private_attesters.get(ctx.slot)
        committee = set(int(i) for i in slot_committee(view, ctx.slot))
        mine = [v for v in (self.controlled if voters is None else voters)
                if v in committee]
        if not mine:
            return
        self.chain.votes.extend(
            committee_attestations(view, ctx.slot, self.chain.tip, mine))

    def _release(self, ctx: AdversaryContext) -> None:
        self.released = True
        if not self.chain.blocks:
            return  # fork never started (fork-slot proposer not ours)
        src = self.controlled[0] if self.controlled else 0
        for sb in self.chain.blocks:
            ctx.broadcast("block", sb, src=int(sb.message.proposer_index))
        for att in self.chain.votes:
            ctx.broadcast("attestation", att, src=ATT_SRC_BASE + src)
        if self.propose_on_release:
            sb = build_block(self.chain.state, ctx.slot,
                             graffiti=b"\x44" * 32)
            ctx.broadcast("block", sb, src=int(sb.message.proposer_index))
        ctx.deliver()

    def before_propose(self, ctx: AdversaryContext) -> None:
        if ctx.slot == self.fork_slot:
            self._extend_private(ctx)
        if (not self.released and ctx.slot == self.release_slot
                and self.release_phase == "before_propose"):
            self._release(ctx)

    def before_attest(self, ctx: AdversaryContext) -> None:
        if self.chain.blocks and ctx.slot in self.vote_slots:
            self._vote_private(ctx)
        if (not self.released and ctx.slot == self.release_slot
                and self.release_phase == "before_attest"):
            self._release(ctx)


class Balancer(AdversaryStrategy):
    """Swayer-vote balancing against pre-boost Gasper
    (pos-evolution.md:1321-1348), as a strategy: the controlled slot-1
    proposer equivocates into two chains delivered one per view group;
    thereafter withheld controlled votes are released "just before a
    certain point in time" (:1328) — the attestation deadline — so each
    view sees its own chain strictly leading when its honest half votes,
    and fresh votes are banked every slot. Releasing any earlier is
    self-defeating IN-LOOP: a vote released before the proposal round
    lands in the recipient view's op pool and the next honest BLOCK
    re-gossips it to the other view mid-slot, instantly — exactly the
    honest re-gossip the reference's adversary model forbids relying on.
    (Proposals carry no fork-choice weight at boost 0, so the attester
    deadline is the only decision point that matters.)

    Requires a 2-group schedule and boost 0 (the attack the mainline W/4
    boost was introduced to kill). The tie survives exactly as long as
    the swayer banks cover each slot's honest committee imbalance
    between the views — the reference's "enough Byzantine validators in
    every slot" precondition (:1330); see
    ``sim/attacks.committee_balanced_split_schedule`` for the view
    assignment that makes epoch-0 committees split evenly."""

    name = "balancer"

    def __init__(self, controlled=()):
        super().__init__(controlled)
        self.fork_roots: tuple | None = None
        self.bank: dict[int, list] = {0: [], 1: []}

    def bind(self, sim) -> None:
        super().bind(sim)
        assert len(sim.groups) == 2, "Balancer needs exactly two view groups"
        assert cfg().proposer_score_boost_percent == 0, \
            "the swayer balancing attack targets pre-boost Gasper"

    def before_propose(self, ctx: AdversaryContext) -> None:
        if ctx.slot == 1:
            self._equivocate_genesis(ctx)

    def before_attest(self, ctx: AdversaryContext) -> None:
        if self.fork_roots is not None:
            self._sway(ctx)

    def _equivocate_genesis(self, ctx: AdversaryContext) -> None:
        store = ctx.store(0)
        anchor = ctx.head(0)
        state = store.block_states[anchor]
        proposer = int(get_beacon_proposer_index(
            advance_state_to_slot(state, 1)))
        assert proposer in self.controlled, \
            "Balancer needs the slot-1 proposer under adversary control"
        sb_l = build_block(state, 1, graffiti=b"\x1f" * 32)
        sb_r = build_block(state, 1, graffiti=b"\xf1" * 32)
        sps = float(cfg().seconds_per_slot)
        # each side sees "its" block in time to attest; the other arrives
        # a slot later (targeted delivery, pos-evolution.md:1328)
        ctx.broadcast("block", sb_l, src=proposer, msg_id=0,
                      delay={0: 0.0, 1: sps})
        ctx.broadcast("block", sb_r, src=proposer, msg_id=1,
                      delay={0: sps, 1: 0.0})
        ctx.deliver()
        self.fork_roots = (hash_tree_root(sb_l.message),
                           hash_tree_root(sb_r.message))

    def _sway(self, ctx: AdversaryContext) -> None:
        """Release banked withheld votes to each side until that side
        sees its own chain strictly leading (released votes reach the
        other side a slot later via gossip)."""
        c = cfg()
        epoch = compute_epoch_at_slot(ctx.slot)
        for side in (0, 1):
            # prune withheld votes that fell out of the validity window
            self.bank[side] = [(v, a) for v, a in self.bank[side]
                               if int(a.data.target.epoch) >= epoch - 1]
        for side in (0, 1):
            own, other = self.fork_roots[side], self.fork_roots[1 - side]
            store = ctx.store(side)
            while self.bank[side]:
                try:
                    w_own = fc.get_latest_attesting_balance(store, own)
                    w_other = fc.get_latest_attesting_balance(store, other)
                except KeyError:
                    break
                if w_own > w_other:
                    break
                voter, att = self.bank[side].pop(0)
                ctx.broadcast("attestation", att, src=ATT_SRC_BASE + voter,
                              delay={side: 0.0,
                                     1 - side: float(c.seconds_per_slot)})
                ctx.deliver()

    def after_attest(self, ctx: AdversaryContext) -> None:
        """Bank fresh withheld votes for each side's tip, alternating so
        both banks stay stocked."""
        if self.fork_roots is None:
            return
        view0 = advance_state_to_slot(
            ctx.store(0).block_states[ctx.head(0)], ctx.slot)
        committee = [int(v) for v in slot_committee(view0, ctx.slot)]
        corrupted_here = [v for v in committee if v in set(self.controlled)]
        for k, v in enumerate(corrupted_here):
            side = (k + ctx.slot) % 2
            store = ctx.store(side)
            head = fc.get_head(store)
            head_state = advance_state_to_slot(store.block_states[head],
                                               ctx.slot)
            self.bank[side].extend(
                (v, a) for a in
                committee_attestations(head_state, ctx.slot, head, [v]))


class SplitVoter(AdversaryStrategy):
    """The accountable-safety theorem's worst case, operational: with the
    network partitioned into two isolated view groups (cross-group
    delivery withheld by the Schedule), every controlled validator votes
    BOTH groups' heads every slot, and controlled proposers equivocate —
    one block per view, each packing that view's attestation pool. With
    exactly 1/3 controlled and the honest set split evenly, each view
    sees 2/3 of stake attesting its own chain and the two views finalize
    CONFLICTING checkpoints — at which point Casper FFG's theorem
    (pos-evolution.md:233-238) says the double votes themselves are the
    evidence: ``AccountableSafetyMonitor`` must attribute >= 1/3 of stake
    from them. Strictly stronger than ``Equivocator``: it equivocates
    *coherently enough to kill safety*, not just to feed the slasher.

    Use with a 2-group schedule whose ``block_delay``/``attestation_delay``
    return None across groups (``sim/attacks.split_brain_schedule``)."""

    name = "split_voter"

    def bind(self, sim) -> None:
        super().bind(sim)
        assert len(sim.groups) >= 2, "SplitVoter needs a partitioned network"

    def before_propose(self, ctx: AdversaryContext) -> None:
        sim = ctx.sim
        for g in range(ctx.n_groups()):
            group = sim.groups[g]
            if group.crashed:
                continue
            head = ctx.head(g)
            head_state = advance_state_to_slot(group.store.block_states[head],
                                               ctx.slot)
            proposer = int(get_beacon_proposer_index(head_state))
            if proposer not in self.controlled:
                continue
            # equivocating proposal: this view's chain advances with this
            # view's pool packed (the adversary builds both chains)
            atts = sim._pack_attestations(group, ctx.slot, head,
                                          head_state=head_state)
            try:
                sb = build_block(group.store.block_states[head], ctx.slot,
                                 attestations=atts,
                                 graffiti=bytes([0xD0 + g]) * 32)
            except AssertionError:
                sb = build_block(group.store.block_states[head], ctx.slot,
                                 graffiti=bytes([0xD0 + g]) * 32)
            ctx.broadcast("block", sb, src=proposer, msg_id=g, groups=[g])

    def before_attest(self, ctx: AdversaryContext) -> None:
        sim = ctx.sim
        # votes ride the wire like honest ones: usable from the next slot
        wire_delay = sim.slot_start(ctx.slot + 1) - ctx.now
        for g in range(ctx.n_groups()):
            if sim.groups[g].crashed:
                continue
            store = ctx.store(g)
            head = ctx.head(g)
            state = advance_state_to_slot(store.block_states[head], ctx.slot)
            mine = np.array(sorted(self.controlled), dtype=np.int64)
            for att in committee_attestations(state, ctx.slot, head, mine):
                ctx.broadcast("attestation", att, src=ATT_SRC_BASE + g,
                              delay=wire_delay, groups=[g])


class RandomByzantine(AdversaryStrategy):
    """Seeded stateless chaos over the controlled set: per (slot,
    validator), a hash draw picks abstain / equivocate-vote /
    stale-head-vote; controlled proposers coin-flip a double proposal.
    Same determinism discipline as ``FaultPlan`` — every decision is
    ``stateless_unit(seed, domain, slot, validator)``, so behavior is
    identical across checkpoint/resume, episode ordering, and array
    backends (all messages are built with spec builders and are
    valid-or-cleanly-rejected at the handlers)."""

    name = "random_byzantine"

    # decision domains (first key element of the seeded hash)
    _D_ACTION, _D_PROPOSE, _D_PICK = 0, 1, 2

    def __init__(self, controlled=(), seed: int = 0,
                 p_equivocate: float = 0.3, p_stale_vote: float = 0.2,
                 p_abstain: float = 0.2, p_double_propose: float = 0.5):
        super().__init__(controlled)
        self.seed = int(seed)
        self.p_equivocate = p_equivocate
        self.p_stale_vote = p_stale_vote
        self.p_abstain = p_abstain
        self.p_double_propose = p_double_propose

    def describe(self) -> dict:
        d = super().describe()
        d.update(seed=self.seed, p_equivocate=self.p_equivocate,
                 p_stale_vote=self.p_stale_vote, p_abstain=self.p_abstain,
                 p_double_propose=self.p_double_propose)
        return d

    def decisions(self, slot: int) -> dict[int, str]:
        """The pure decision table for ``slot`` (exposed for the
        determinism pin): validator -> action name."""
        out = {}
        for v in self.controlled:
            u = stateless_unit(self.seed, self._D_ACTION, slot, v)
            if u < self.p_abstain:
                out[v] = "abstain"
            elif u < self.p_abstain + self.p_equivocate:
                out[v] = "equivocate"
            elif u < self.p_abstain + self.p_equivocate + self.p_stale_vote:
                out[v] = "stale_vote"
            else:
                out[v] = "honest_vote"
        return out

    def before_propose(self, ctx: AdversaryContext) -> None:
        store = ctx.store(0)
        head = ctx.head(0)
        head_state = advance_state_to_slot(store.block_states[head], ctx.slot)
        proposer = int(get_beacon_proposer_index(head_state))
        if proposer not in self.controlled:
            return
        u = stateless_unit(self.seed, self._D_PROPOSE, ctx.slot, proposer)
        if u < self.p_double_propose:
            parent_state = store.block_states[head]
            sb_a = build_block(parent_state, ctx.slot, graffiti=b"\xb1" * 32)
            sb_b = build_block(parent_state, ctx.slot, graffiti=b"\xb2" * 32)
            ctx.broadcast("block", sb_a, src=proposer, msg_id=0)
            ctx.broadcast("block", sb_b, src=proposer, msg_id=1)
        # else: withhold the slot entirely (a missed proposal)

    def before_attest(self, ctx: AdversaryContext) -> None:
        table = self.decisions(ctx.slot)
        store = ctx.store(0)
        head = ctx.head(0)
        head_state = advance_state_to_slot(store.block_states[head], ctx.slot)
        committee = set(int(i) for i in slot_committee(head_state, ctx.slot))
        delta = float(self.sim.delta)
        # advancing a state to the slot can run epoch processing; the
        # controlled set mostly votes the same few roots, so share it
        advanced = {head: head_state}

        def _state_at(root):
            if root not in advanced:
                advanced[root] = advance_state_to_slot(
                    store.block_states[root], ctx.slot)
            return advanced[root]

        for v, action in sorted(table.items()):
            if v not in committee or action == "abstain":
                continue
            roots = [head]
            if action == "equivocate":
                siblings = sorted(r for r, b in store.blocks.items()
                                  if r != head
                                  and int(b.slot) >= ctx.slot - 1)
                if siblings:
                    pick = int(stateless_unit(self.seed, self._D_PICK,
                                              ctx.slot, v) * len(siblings))
                    roots.append(siblings[min(pick, len(siblings) - 1)])
            elif action == "stale_vote":
                older = sorted(r for r, b in store.blocks.items()
                               if int(b.slot) < ctx.slot)
                if older:
                    pick = int(stateless_unit(self.seed, self._D_PICK,
                                              ctx.slot, v) * len(older))
                    roots = [older[min(pick, len(older) - 1)]]
            for root in roots:
                # vote from the target chain's own state so the LMD/FFG
                # consistency checks pass (a valid, merely-wrong vote)
                state = _state_at(root)
                for att in committee_attestations(state, ctx.slot, root, [v]):
                    ctx.broadcast("attestation", att, src=ATT_SRC_BASE + v,
                                  delay=delta)
