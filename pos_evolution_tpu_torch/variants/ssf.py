"""SsfVariant: single-slot finality in the production driver
(pos-evolution.md:1611-1650).

RLMD-GHOST with fast confirmation (the 4Δ slot: propose -> head-vote ->
FFG-vote/fast-confirm -> merge, :1617, :1631-1637) plus a per-slot FFG
gadget over (block, slot) checkpoints:

- every vote round derives one supermajority-link candidate per view:
  source = the view's latest justified checkpoint LJ, target = the
  highest fast-confirmed descendant of LJ (or LJ's block) at the round's
  slot (:1624-1629); the link's stake is tallied through the backend
  link kernel;
- 2/3 of stake on the link justifies the target (:1626); a link across
  consecutive slots finalizes its source (:1626); the voters then
  *acknowledge* the just-justified checkpoint and 2/3 acknowledgments
  finalize it within its own round (:1646) — single-slot finality;
- slashing: an acknowledgment ((C, t), t) conflicts with any FFG vote
  whose span strictly surrounds t (surround-the-ack, :1646), and two
  distinct links with the same target slot are a double vote — the
  variant keeps a cross-view evidence log so the
  ``VariantSafetyMonitor`` can attribute conflicting finality to >= 1/3
  of stake (the accountable-safety theorem at slot granularity).

Fork choice is LJ-filtered (:1628): the GHOST descent starts at the
view's latest justified block (or its newest fast confirmation when that
sits deeper in the chain).
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.variants.base import ExpiryVariantBase


class SsfVariant(ExpiryVariantBase):
    name = "ssf"
    fast_confirm = True

    def __init__(self, eta: int = 4, fast_confirm_threshold: float = 0.75):
        super().__init__()
        self.eta = int(eta)
        self.kappa = max(int(eta), 2)
        self.fast_confirm = True
        self.fast_confirm_threshold = float(fast_confirm_threshold)
        # per-group FFG state: latest justified (root, slot), the
        # justified set, and the finalized chain of checkpoints
        self.lj: dict[int, tuple[bytes, int]] = {}
        self.justified: dict[int, set[tuple[bytes, int]]] = {}
        self.finalized: dict[int, list[tuple[bytes, int]]] = {}
        # cross-view evidence log (the watchtower's view): derived FFG
        # votes and acknowledgments per validator
        self.ffg_log: dict[tuple[int, int], set] = {}   # (v, tslot) -> links
        self.ack_log: dict[int, set[int]] = {}          # v -> ack slots
        self.vote_spans: dict[int, set[tuple[int, int]]] = {}  # v -> (s, t)
        self._slashable: set[int] = set()

    def describe(self) -> dict:
        return {"kind": "SsfVariant", "eta": self.eta,
                "fast_confirm_threshold": self.fast_confirm_threshold}

    # -- fork choice: LJ filtering (:1628) -------------------------------------

    def _genesis_cp(self, store) -> tuple[bytes, int]:
        anchor = next(iter(store.blocks))
        return (anchor, int(store.blocks[anchor].slot))

    def _start_root(self, store, group_id: int) -> bytes:
        lj = self.lj.get(group_id)
        if lj is None or lj[0] not in store.blocks:
            return super()._start_root(store, group_id)
        fast = self.fast_confirmed.get(group_id)
        if fast is not None and fast[0] in store.blocks \
                and fast[1] > lj[1] and self._descends(store, fast[0], lj[0]):
            return fast[0]
        return lj[0]

    def reset_view(self, group) -> None:
        super().reset_view(group)
        self.lj.pop(group.id, None)
        self.justified.pop(group.id, None)
        # finalized history survives a crash (it is the one thing the
        # protocol promises never to revert); the rejoined view re-earns
        # justification from fresh rounds

    # -- per-round FFG gadget --------------------------------------------------

    def _process_round(self, sim, group, round_slot: int) -> None:
        from pos_evolution_tpu_torch.backend import get_backend
        from pos_evolution_tpu_torch.specs import forkchoice as fc
        store = group.store
        log = self.views[group.id]
        votes = log.by_slot.get(round_slot)
        if not votes:
            return
        gid = group.id
        lj = self.lj.get(gid)
        if lj is None:
            lj = self._genesis_cp(store)
            self.lj[gid] = lj
            self.justified.setdefault(gid, set()).add(lj)
            self.finalized.setdefault(gid, [])
        # target selection (:1624-1629)
        fast = self.fast_confirmed.get(gid)
        if fast is not None and fast[0] in store.blocks \
                and self._descends(store, fast[0], lj[0]):
            target_block = fast[0]
        else:
            target_block = lj[0]
        target = (target_block, round_slot)
        link = (lj[0], lj[1], target_block)

        # Only voters whose head vote SUPPORTS the target cast this
        # view's link (their FFG vote in the real protocol carries their
        # own view's target): a round split between two chains must not
        # let both views claim the full committee for conflicting links —
        # without this filter, honest equivocation-free execution could
        # finalize conflicting checkpoints with zero slashable evidence,
        # which the VariantSafetyMonitor (correctly) rejects.
        voters = sorted(
            v for v in votes if v not in log.equivocators
            and self._descends(store, votes[v], target_block))
        for v in voters:
            links = self.ffg_log.setdefault((v, round_slot), set())
            links.add(link)
            if len(links) > 1:
                self._slashable.add(v)           # double FFG vote (:238)
            span = (lj[1], round_slot)
            self.vote_spans.setdefault(v, set()).add(span)
            for ack_slot in self.ack_log.get(v, ()):
                if span[0] < ack_slot < span[1]:
                    self._slashable.add(v)       # surround-the-ack (:1646)

        # Supermajority-link tally through the backend kernel (:1626).
        # The carrier's per-slot committees subsample the validator set
        # (each validator FFG-votes once per epoch), so the 2/3 threshold
        # applies to the ROUND's eligible stake — committee-subsampled
        # SSF; the paper's full-participation protocol is the
        # subsample -> 1 limit, exercised by the models/ssf.py oracle.
        # Accountability still measures against TOTAL stake: committee
        # rotation accumulates cross-view double votes until the
        # implicated set covers the adversary (VariantSafetyMonitor
        # upgrades its verdict when it crosses 1/3).
        from pos_evolution_tpu_torch.sim.adversary import slot_committee
        from pos_evolution_tpu_torch.specs.validator import advance_state_to_slot
        state = fc.justified_checkpoint_state(store)
        reg = state.validators
        n = len(reg)
        cstate = store.block_states.get(target_block, state)
        if int(cstate.slot) < round_slot:
            cstate = advance_state_to_slot(cstate, round_slot)
        committee = [int(v) for v in slot_committee(cstate, round_slot)]
        eligible = sum(int(reg.effective_balance[v]) for v in committee
                       if v < n and not bool(reg.slashed[v]))
        weights = np.array([int(reg.effective_balance[v])
                            if v < n and not bool(reg.slashed[v]) else 0
                            for v in voters], np.int64)
        link_idx = np.zeros(len(voters), np.int64)
        w = int(get_backend().link_tally(
            link_idx, weights, np.ones(len(voters), bool), 1)[0])
        if eligible == 0 or 3 * w < 2 * eligible:
            return
        if lj not in self.justified.setdefault(gid, {lj}):
            return
        # justification
        newly = target not in self.justified[gid]
        self.justified[gid].add(target)
        if target[1] == lj[1] + 1:
            # consecutive-slot link finalizes the source (:1626)
            self._finalize(gid, lj)
        if newly:
            # acknowledgment round (:1646): the same 2/3 voters saw the
            # justification inside the round and acknowledge it —
            # finalizing the target within its own slot
            for v in voters:
                self.ack_log.setdefault(v, set()).add(round_slot)
                for span in self.vote_spans.get(v, ()):
                    if span[0] < round_slot < span[1]:
                        self._slashable.add(v)
            self._finalize(gid, target)
            if target[1] > self.lj[gid][1]:
                self.lj[gid] = target

    def _finalize(self, gid: int, checkpoint: tuple[bytes, int]) -> None:
        chain = self.finalized.setdefault(gid, [])
        if checkpoint not in chain:
            chain.append(checkpoint)

    # -- audit surface ---------------------------------------------------------

    def finalized_checkpoints(self, group_id: int) -> list[tuple[bytes, int]]:
        return list(self.finalized.get(group_id, []))

    def slashable(self) -> set[int]:
        return set(self._slashable)

    def doctor(self, sim, slot: int) -> bool:
        """Forge CONFLICTING finalized checkpoints into the first two
        views with no double votes behind them: the variant safety
        monitor must flag a protocol_violation — the per-variant CI
        negative. Cross-slot on purpose: a cross-slot conflict is judged
        against TOTAL stake (disjoint committees), so real sub-1/3
        chaos evidence can never launder the forgery into an
        accountable_fault."""
        if len(sim.groups) < 2:
            return False
        self._finalize(sim.groups[0].id, (b"\x0d" * 32, slot))
        self._finalize(sim.groups[1].id, (b"\x0e" * 32, slot + 1))
        return True

    # -- telemetry -------------------------------------------------------------

    def on_slot_end(self, sim, slot: int) -> dict | None:
        record = super().on_slot_end(sim, slot)
        if record is None:
            return None
        for g in sim.groups:
            row = record["groups"].get(str(g.id))
            if row is None:
                continue
            lj = self.lj.get(g.id)
            fin = self.finalized.get(g.id, [])
            row["justified_slot"] = lj[1] if lj else None
            row["finalized_slot"] = max((s for _, s in fin), default=None)
            row["n_finalized"] = len(fin)
        record["slashable_evidence"] = len(self._slashable)
        return record

    # -- snapshot --------------------------------------------------------------

    def state_blob(self, sim) -> dict:
        blob = super().state_blob(sim)
        blob.update({
            "lj": {str(g): [r.hex(), s]
                   for g, (r, s) in sorted(self.lj.items())},
            "justified": {str(g): sorted([r.hex(), s] for r, s in cps)
                          for g, cps in sorted(self.justified.items())},
            "finalized": {str(g): [[r.hex(), s] for r, s in chain]
                          for g, chain in sorted(self.finalized.items())},
            "ffg_log": [[v, t, sorted([sr.hex(), ss, tr.hex()]
                                      for sr, ss, tr in links)]
                        for (v, t), links in sorted(self.ffg_log.items())],
            "ack_log": {str(v): sorted(s)
                        for v, s in sorted(self.ack_log.items())},
            "vote_spans": {str(v): sorted(map(list, s))
                           for v, s in sorted(self.vote_spans.items())},
            "slashable": sorted(self._slashable),
        })
        return blob

    def restore_blob(self, sim, blob: dict) -> None:
        super().restore_blob(sim, blob)
        self.lj = {int(g): (bytes.fromhex(r), int(s))
                   for g, (r, s) in blob.get("lj", {}).items()}
        self.justified = {
            int(g): {(bytes.fromhex(r), int(s)) for r, s in cps}
            for g, cps in blob.get("justified", {}).items()}
        self.finalized = {
            int(g): [(bytes.fromhex(r), int(s)) for r, s in chain]
            for g, chain in blob.get("finalized", {}).items()}
        self.ffg_log = {
            (int(v), int(t)): {(bytes.fromhex(sr), int(ss),
                               bytes.fromhex(tr)) for sr, ss, tr in links}
            for v, t, links in blob.get("ffg_log", [])}
        self.ack_log = {int(v): set(s)
                        for v, s in blob.get("ack_log", {}).items()}
        self.vote_spans = {int(v): {tuple(x) for x in spans}
                           for v, spans in blob.get("vote_spans", {}).items()}
        self._slashable = set(blob.get("slashable", []))
