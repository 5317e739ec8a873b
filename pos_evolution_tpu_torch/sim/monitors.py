"""Online protocol-property monitors (Jepsen-style invariant checking).

The reference's central guarantees are *accountable safety* — conflicting
finalized checkpoints imply >= 1/3 of stake provably violated a slashing
condition (pos-evolution.md:233-238, the Casper FFG theorem) — and
*plausible liveness* — finality resumes after GST given < 1/3 adversarial
stake (:243, :1184-1190). ``sim/attacks.py`` exercises the attacks;
nothing so far *audited the properties they threaten, continuously,
inside the driver*. These monitors do: every slot, across every live
honest store, the protocol either holds its guarantees or the monitor
yields cryptographic evidence against the attackers.

- ``AccountableSafetyMonitor``: observes every originated attestation and
  block (honest and adversarial) through the driver's broadcast path,
  feeds the ``specs/slasher.Slasher``, and on conflicting finalized (or
  same-epoch justified) checkpoints across views computes the implicated
  slashable set from the vote logs. Evidence covering >= 1/3 of stake is
  the theorem holding (an *accountable* fault, attributable to the
  attackers); anything less is a genuine protocol violation. With
  ``broadcast_evidence=True`` detected ``AttesterSlashing``s are also
  fed back onto the wire as ``slashing`` messages — the in-loop
  watchtower closing the evidence -> ``on_attester_slashing`` ->
  discounting loop.
- ``FinalityLivenessMonitor``: after GST (and every crash window's end),
  with < 1/3 adversarial stake, the best finalized epoch across live
  views must trail the current epoch by at most ``bound_epochs``.
- ``ForkChoiceParityMonitor``: the resident device head must equal the
  spec head on every live accelerated view, every slot — the
  ``ops/resident.py`` periodic self-check promoted to a continuous,
  attack-time audit.

Violations are returned as dicts, recorded on
``Simulation.monitor_violations``, and emitted as ``monitor`` telemetry
events; ``scripts/chaos_fuzz.py`` turns them into repro bundles and
``scripts/run_report.py`` folds them into the property-audit section.
"""

from __future__ import annotations

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.specs.containers import (
    BeaconBlockHeader,
    SignedBeaconBlockHeader,
)
from pos_evolution_tpu_torch.specs.helpers import (
    get_indexed_attestation,
    get_total_active_balance,
)
from pos_evolution_tpu_torch.specs.slasher import Slasher
from pos_evolution_tpu_torch.specs.validator import advance_state_to_slot
from pos_evolution_tpu_torch.ssz import hash_tree_root

import numpy as np

# src id for monitor-originated slashing gossip (see adversary.ATT_SRC_BASE
# for the adversarial namespace; the watchtower gets its own)
SLASHING_SRC = 2_000


class Monitor:
    """Base monitor: observes originated messages, checks once per slot.

    ``observe`` sees every message at ORIGINATION (before FaultPlan
    drops), which is exactly the watchtower model: evidence of a
    violation can be observed by someone (pos-evolution.md:238) even if
    some recipients never get the message. ``on_slot_end`` returns a
    list of violation dicts; an empty list is a clean slot."""

    name = "monitor"

    def bind(self, sim) -> None:
        self.sim = sim

    def describe(self) -> dict:
        return {"kind": type(self).__name__}

    def observe(self, kind: str, payload) -> None:
        pass

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        return []


def _live_groups(sim):
    return [g for g in sim.groups if not g.crashed]


class AccountableSafetyMonitor(Monitor):
    """Safety auditor + watchtower (see module docstring)."""

    name = "accountable_safety"

    def __init__(self, broadcast_evidence: bool = False):
        self.broadcast_evidence = broadcast_evidence

    def bind(self, sim) -> None:
        super().bind(sim)
        self.slasher = Slasher()
        self.evidence: list = []          # every AttesterSlashing emitted
        self.proposer_evidence: list = []  # ProposerSlashings (equivocating
        #   proposals; recorded for the audit trail, not stake attribution —
        #   the 1/3 bound is about double/surround VOTES)
        self.implicated: set[int] = set()  # validators covered by evidence
        self._pending: list = []          # attestations awaiting a target state
        self._seen_atts: set = set()      # hash_tree_root of every buffered
        #   attestation: block-packed copies of already-observed votes are
        #   dropped at the tap instead of re-running committee indexing
        self._target_states: dict = {}    # (epoch, root) -> advanced state
        self._reported: set = set()       # conflict keys already reported
        self._slash_seq = 0

    def describe(self) -> dict:
        return {"kind": type(self).__name__,
                "broadcast_evidence": self.broadcast_evidence}

    # -- observation -----------------------------------------------------------

    def _buffer(self, att) -> None:
        key = hash_tree_root(att)
        if key in self._seen_atts:
            return
        self._seen_atts.add(key)
        self._pending.append(att)

    def observe(self, kind: str, payload) -> None:
        if kind == "attestation":
            self._buffer(payload)
        elif kind == "block":
            block = payload.message
            for att in block.body.attestations:
                self._buffer(att)
            header = SignedBeaconBlockHeader(
                message=BeaconBlockHeader(
                    slot=int(block.slot),
                    proposer_index=int(block.proposer_index),
                    parent_root=bytes(block.parent_root),
                    state_root=bytes(block.state_root),
                    body_root=hash_tree_root(block.body)),
                signature=bytes(payload.signature))
            ps = self.slasher.on_block_header(header)
            if ps is not None:
                self.proposer_evidence.append(ps)

    def _target_state(self, target):
        """The committee-resolving state for an attestation target, from
        whichever view or archived block knows the target root."""
        key = (int(target.epoch), bytes(target.root))
        state = self._target_states.get(key)
        if state is not None:
            return state
        root = bytes(target.root)
        base = None
        for g in self.sim.groups:
            base = g.store.block_states.get(root)
            if base is not None:
                break
        if base is None:
            return None
        state = advance_state_to_slot(
            base, int(target.epoch) * cfg().slots_per_epoch)
        self._target_states[key] = state
        return state

    def _ingest_pending(self) -> list:
        """Index and feed every observed attestation whose target is now
        resolvable; returns newly emitted evidence."""
        new_evidence = []
        still = []
        for att in self._pending:
            state = self._target_state(att.data.target)
            if state is None:
                # target chain never surfaced in any view yet; retry while
                # the vote is recent, then drop (bounds the buffer)
                horizon = (int(att.data.target.epoch) + 2) * cfg().slots_per_epoch
                if self.sim.slot <= horizon:
                    still.append(att)
                continue
            try:
                indexed = get_indexed_attestation(state, att)
            except (AssertionError, IndexError):
                continue  # malformed for this committee layout: unusable
            new_evidence.extend(self.slasher.on_attestation(indexed))
        self._pending = still
        for ev in new_evidence:
            a = set(int(i) for i in np.asarray(ev.attestation_1.attesting_indices))
            b = set(int(i) for i in np.asarray(ev.attestation_2.attesting_indices))
            self.implicated |= (a & b)
        self.evidence.extend(new_evidence)
        return new_evidence

    # -- per-slot check --------------------------------------------------------

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        new_evidence = self._ingest_pending()
        if new_evidence:
            if sim.telemetry is not None:
                sim.telemetry.bus.emit(
                    "slashing_detected", monitor=self.name, slot=slot,
                    n_new=len(new_evidence),
                    implicated_total=len(self.implicated))
            if self.broadcast_evidence:
                t = sim.slot_start(slot + 1)
                for ev in new_evidence:
                    for dst in sim.groups:
                        sim._send(dst, t, 0.0, "slashing", ev, slot,
                                  src=SLASHING_SRC, msg_id=self._slash_seq)
                    self._slash_seq += 1
        return self._check_conflicts(sim, slot)

    def _stake_of(self, indices) -> int:
        reg = self.sim.genesis_state.validators
        return sum(int(reg.effective_balance[i]) for i in indices
                   if i < len(reg))

    def _ancestor_in_archive(self, root: bytes, ancestor: bytes,
                             ancestor_slot: int) -> bool:
        """Ancestry via the global block archive (views may not hold each
        other's chains). Unknown roots resolve to 'not an ancestor'."""
        cur = root
        while True:
            sb = self.sim.block_archive.get(cur)
            if sb is None:
                # the anchor itself is not archived; a walk that dead-ends
                # exactly there can still match by identity
                return cur == ancestor
            if int(sb.message.slot) <= ancestor_slot:
                return cur == ancestor
            cur = bytes(sb.message.parent_root)

    def _conflicting(self, cp_a, cp_b) -> bool:
        ea, ra = int(cp_a.epoch), bytes(cp_a.root)
        eb, rb = int(cp_b.epoch), bytes(cp_b.root)
        if ea == 0 or eb == 0:
            return False  # genesis conflicts with nothing
        if ea == eb:
            return ra != rb
        lo, hi = ((ea, ra), (eb, rb)) if ea < eb else ((eb, rb), (ea, ra))
        lo_slot = int(self.sim.block_archive[lo[1]].message.slot) \
            if lo[1] in self.sim.block_archive else lo[0] * cfg().slots_per_epoch
        return not self._ancestor_in_archive(hi[1], lo[1], lo_slot)

    def _check_conflicts(self, sim, slot: int) -> list[dict]:
        out = []
        live = _live_groups(sim)
        for i in range(len(live)):
            for j in range(i + 1, len(live)):
                gi, gj = live[i], live[j]
                pairs = [
                    ("finalized", gi.store.finalized_checkpoint,
                     gj.store.finalized_checkpoint),
                    ("justified", gi.store.justified_checkpoint,
                     gj.store.justified_checkpoint),
                ]
                for label, ca, cb in pairs:
                    # conflicting *justified* checkpoints are slashable
                    # only at the SAME epoch (2/3 + 2/3 overlap); lagging
                    # views legitimately justify different epochs
                    if label == "justified" and int(ca.epoch) != int(cb.epoch):
                        continue
                    if not self._conflicting(ca, cb):
                        continue
                    key = (label, min(gi.id, gj.id), max(gi.id, gj.id),
                           int(ca.epoch), bytes(ca.root),
                           int(cb.epoch), bytes(cb.root))
                    if key in self._reported:
                        continue
                    self._reported.add(key)
                    stake = self._stake_of(self.implicated)
                    total = get_total_active_balance(sim.genesis_state)
                    accountable = 3 * stake >= total
                    out.append({
                        "monitor": self.name,
                        "kind": ("accountable_fault" if accountable
                                 else "protocol_violation"),
                        "checkpoint": label,
                        "groups": [gi.id, gj.id],
                        "epochs": [int(ca.epoch), int(cb.epoch)],
                        "roots": [bytes(ca.root).hex()[:16],
                                  bytes(cb.root).hex()[:16]],
                        "evidence_size": len(self.implicated),
                        "slashable_stake": stake,
                        "total_stake": total,
                        "detail": (
                            f"conflicting {label} checkpoints between "
                            f"groups {gi.id}/{gj.id}; slashable evidence "
                            f"covers {stake}/{total} stake"
                            + ("" if accountable else
                               " — BELOW the 1/3 accountable-safety bound")),
                    })
        return out


class FinalityLivenessMonitor(Monitor):
    """Plausible-liveness auditor: finality must advance within
    ``bound_epochs`` of the current epoch once the network is past GST
    and every declared crash window, given < 1/3 adversarial stake.
    Disarmed (checks nothing, loudly recorded in ``describe``) when the
    preconditions cannot hold: >= 1/3 corrupted, or message faults with
    no GST."""

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
        c = cfg()
        n = sim.n_validators
        n_corrupt = len(sim.schedule.corrupted)
        if 3 * n_corrupt >= n:
            self.disarmed_reason = (
                f"{n_corrupt}/{n} corrupted >= 1/3: liveness not guaranteed")
            return
        if self.armed_after_epoch is not None:
            return
        armed = 0
        plan = sim.schedule.faults
        if plan is not None:
            if (plan.drop_p or plan.duplicate_p or plan.reorder_p):
                if plan.gst is None:
                    self.disarmed_reason = \
                        "message faults with no GST: no synchrony to rely on"
                    return
                sec_per_epoch = c.seconds_per_slot * c.slots_per_epoch
                armed = max(armed, -(-int(plan.gst) // sec_per_epoch))
            for w in plan.crashes:
                armed = max(armed, -(-w.rejoin_slot // c.slots_per_epoch))
        self.armed_after_epoch = armed

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        if self.disarmed_reason is not None:
            return []
        c = cfg()
        epoch = slot // c.slots_per_epoch
        if epoch < (self.armed_after_epoch or 0) + self.bound_epochs:
            return []
        live = _live_groups(sim)
        if not live:
            return []
        best = max(int(g.store.finalized_checkpoint.epoch) for g in live)
        lag = epoch - best
        if lag <= self.bound_epochs or lag <= self._worst_lag:
            # report once per lag level, not every slot of a stall
            return []
        self._worst_lag = lag
        return [{
            "monitor": self.name,
            "kind": "liveness_violation",
            "epoch": epoch,
            "best_finalized_epoch": best,
            "lag_epochs": lag,
            "bound_epochs": self.bound_epochs,
            "armed_after_epoch": self.armed_after_epoch,
            "detail": (f"finality lag {lag} epochs > bound "
                       f"{self.bound_epochs} at epoch {epoch} "
                       f"(post-GST, < 1/3 adversarial)"),
        }]


class ForkChoiceParityMonitor(Monitor):
    """Device/spec head parity on every live accelerated view, every
    slot — under attack traffic, not just the honest benches the
    ``ops/resident.py`` periodic self-check mostly sees. A degraded
    mirror answers from the spec path and so stays trivially at parity;
    the monitor additionally surfaces NEW degradations as audit events
    rather than violations (degradation is the designed response)."""

    name = "forkchoice_parity"

    def bind(self, sim) -> None:
        super().bind(sim)
        self._seen_incidents = {g.id: 0 for g in sim.groups}

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        out = []
        for g in _live_groups(sim):
            if g.resident is None:
                continue
            spec_head = fc.get_head(g.store)
            device_head = g.resident.head(g.store)
            if device_head != spec_head:
                out.append({
                    "monitor": self.name,
                    "kind": "parity_violation",
                    "group": g.id,
                    "slot": slot,
                    "device_head": device_head.hex()[:16],
                    "spec_head": spec_head.hex()[:16],
                    "detail": (f"group {g.id} device head diverged from "
                               f"spec head at slot {slot}"),
                })
            n_inc = len(g.resident.incidents)
            if n_inc < self._seen_incidents.get(g.id, 0):
                # crash-rejoin rebuilt the resident with a fresh incident
                # list; restart the watermark or post-rejoin degradations
                # would be suppressed until the new list outgrew the old
                self._seen_incidents[g.id] = 0
            if n_inc > self._seen_incidents.get(g.id, 0):
                self._seen_incidents[g.id] = n_inc
                if sim.telemetry is not None:
                    sim.telemetry.bus.emit(
                        "monitor_note", monitor=self.name, group=g.id,
                        slot=slot, incidents=list(g.resident.incidents))
        return out


class VariantSafetyMonitor(Monitor):
    """Safety auditor for the protocol-variant layer (variants/,
    DESIGN.md §16) — the accountable-safety theorem at the successor
    protocols' granularity:

    - **conflicting variant-finalized checkpoints** across live views
      (SSF per-slot FFG, pos-evolution.md:1626, 1646): two finalized
      (block, slot) pairs, same slot with different blocks or
      non-ancestral chains, require two 2/3 quorums — the variant's
      cross-view evidence log (double per-slot FFG votes,
      surround-the-ack) must implicate >= 1/3 of stake, else the break
      is a genuine ``protocol_violation``;
    - **conflicting same-slot fast confirmations** (:1562-1569): two
      > 3/4 quorums for different blocks of one slot overlap in >= 1/2 of
      the eligible voters, all of whom double-voted — same accountable /
      protocol_violation split.

    Reporting contract: at most one report per (view pair, checkpoint
    label, verdict kind) — SSF finalizes every slot, so per-checkpoint
    reporting would flood the audit with one conflict repeated per slot;
    an ``accountable_fault`` never suppresses a later
    ``protocol_violation`` (a forged or genuinely unexplained break must
    surface even after an explained one), and a ``protocol_violation``
    re-reports once as ``accountable_fault`` when committee rotation
    accumulates the evidence past the bound (committee-subsampled SSF
    implicates the adversary round by round).

    Under the Gasper default (no overlay) the monitor is inert; the FFG
    layer stays ``AccountableSafetyMonitor``'s job."""

    name = "variant_safety"

    def bind(self, sim) -> None:
        super().bind(sim)
        self._reported: set = set()      # (label, gi, gj, kind)
        self._scan_idx: dict = {}        # (label, gi, gj) -> (len_a, len_b)
        self._first_violation: dict = {} # key -> (ca, cb) awaiting upgrade

    def _archive_descends(self, root: bytes, ancestor: bytes) -> bool:
        """Chain walk over the global block archive; no slot cutoff — an
        SSF checkpoint's BLOCK can be older than its checkpoint slot
        (e.g. the anchor finalized at slot 1), so cutting the walk at
        the checkpoint slot would declare ancestral same-chain
        checkpoints conflicting. The walk dead-ends at the anchor
        (never broadcast, so never archived)."""
        cur = root
        while True:
            if cur == ancestor:
                return True
            sb = self.sim.block_archive.get(cur)
            if sb is None:
                return False
            cur = bytes(sb.message.parent_root)

    def _conflicting(self, a: tuple[bytes, int], b: tuple[bytes, int]) -> bool:
        (ra, sa), (rb, sb) = a, b
        if ra == rb:
            return False
        if sa == sb:
            return True
        hi_r = ra if sa > sb else rb
        lo_r = rb if sa > sb else ra
        return not self._archive_descends(hi_r, lo_r)

    def _stake_of(self, indices) -> int:
        reg = self.sim.genesis_state.validators
        return sum(int(reg.effective_balance[i]) for i in indices
                   if i < len(reg))

    def _classify(self, stake: int, total: int,
                  ca: tuple[bytes, int], cb: tuple[bytes, int]) -> tuple:
        """(kind, scale): a SAME-SLOT conflict was finalized/confirmed by
        two quorums of that slot's committee — the theorem's bound is
        1/3 of one slot's committee weight W (the carrier subsamples the
        paper's full participation; W = total / slots_per_epoch, the
        same W as proposer boost). Cross-slot conflicts have disjoint
        committees and keep the full-stake bound."""
        scale = total
        if ca[1] == cb[1]:
            scale = total // cfg().slots_per_epoch
        kind = ("accountable_fault" if 3 * stake >= scale
                else "protocol_violation")
        return kind, scale

    def on_slot_end(self, sim, slot: int) -> list[dict]:
        variant = getattr(sim, "variant", None)
        if variant is None or not variant.needs_view:
            return []
        out = []
        live = _live_groups(sim)
        evidence = variant.slashable()
        stake = self._stake_of(evidence)
        total = int(get_total_active_balance(sim.genesis_state))
        for i in range(len(live)):
            for j in range(i + 1, len(live)):
                gi, gj = live[i], live[j]
                pairs = [("finalized",
                          variant.finalized_checkpoints(gi.id),
                          variant.finalized_checkpoints(gj.id)),
                         ("fast_confirmed",
                          variant.fast_confirmations(gi.id),
                          variant.fast_confirmations(gj.id))]
                for label, cps_a, cps_b in pairs:
                    key = (label, min(gi.id, gj.id), max(gi.id, gj.id))
                    # Incremental scan for the append-only finalized
                    # chains: pairs of already-examined entries never
                    # re-walk the archive (SSF finalizes per slot — a
                    # full rescan would be O(slots^2) walks per run).
                    # fast_confirmed REPLACES its single entry per view,
                    # so it is always rescanned (length <= 1).
                    na0 = nb0 = 0
                    if label == "finalized":
                        na0, nb0 = self._scan_idx.get(key, (0, 0))
                        self._scan_idx[key] = (len(cps_a), len(cps_b))
                    conflicts = []
                    for ia, ca in enumerate(cps_a):
                        for jb, cb in enumerate(cps_b):
                            if ia < na0 and jb < nb0:
                                continue
                            if label == "fast_confirmed" \
                                    and ca[1] != cb[1]:
                                # fast confirmations of different slots
                                # on different chains are the normal
                                # life of competing forks, not a quorum
                                # overlap
                                continue
                            if self._conflicting(ca, cb):
                                conflicts.append((ca, cb))
                    # re-classify the first still-unaccountable conflict
                    # so evidence growth upgrades the verdict once
                    if key in self._first_violation:
                        conflicts.append(self._first_violation[key])
                    for ca, cb in conflicts:
                        kind, scale = self._classify(stake, total, ca, cb)
                        if (key + (kind,)) in self._reported:
                            continue
                        self._reported.add(key + (kind,))
                        if kind == "protocol_violation":
                            self._first_violation.setdefault(key, (ca, cb))
                        else:
                            self._first_violation.pop(key, None)
                        accountable = kind == "accountable_fault"
                        out.append({
                            "monitor": self.name,
                            "kind": kind,
                            "variant": variant.name,
                            "checkpoint": label,
                            "groups": [gi.id, gj.id],
                            "slots": [ca[1], cb[1]],
                            "roots": [ca[0].hex()[:16], cb[0].hex()[:16]],
                            "evidence_size": len(evidence),
                            "slashable_stake": stake,
                            "total_stake": total,
                            "accountability_scale": scale,
                            "detail": (
                                f"conflicting {label} variant checkpoints "
                                f"({variant.name}) between groups "
                                f"{gi.id}/{gj.id}; variant evidence covers "
                                f"{stake}/{scale} accountable-scale stake"
                                + ("" if accountable else
                                   " — BELOW the 1/3 accountable-safety"
                                   " bound")),
                        })
        return out


def default_monitors(accountable_broadcast: bool = True) -> list[Monitor]:
    """The full audit stack (chaos fuzzing default)."""
    return [AccountableSafetyMonitor(broadcast_evidence=accountable_broadcast),
            FinalityLivenessMonitor(),
            ForkChoiceParityMonitor(),
            VariantSafetyMonitor()]
