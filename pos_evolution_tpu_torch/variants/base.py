"""The ProtocolVariant seam (ROADMAP item 5; pos-evolution.md:1528-1650).

A variant owns two protocol decisions the driver used to hard-code:

- **fork choice**: ``head(sim, group)`` answers every head query the
  driver makes (propose, attest, record, light-client/DAS serving,
  adversary omniscience);
- **finality/confirmation**: per-slot hooks (``on_slot_start`` /
  ``on_slot_end``) run the variant's confirmation rules — kappa-deep and
  3/4 fast confirmation (:1556, :1562-1569), per-slot supermajority links
  and acknowledgments (:1626, :1646) — over the votes each view actually
  received.

The beacon chain stays the **carrier**: blocks, committees, attestations
and the FFG state transition are unchanged (GasperVariant is the
behavior-identical default), and a successor variant interprets the same
per-view message stream under its own rule. Votes reach a variant through
``Store.variant_view`` — the fork-choice handlers notify the attached
``VariantVoteLog`` post-commit, so gossip, block-carried, backfilled and
adversarial attestations all land exactly once per view, subject to the
run's FaultPlan and partitions (composability with the PR-5 audit stack
is the point).

Carrier timing note: the driver's wire makes slot-``t`` head votes
deliverable from slot ``t+1`` (``validate_on_attestation``'s
current-slot guard), so a variant's vote-round processing for slot ``t``
runs at the ``t+1`` boundary — the same 3Δ/4Δ phase structure shifted by
one boundary, with the protocol rules themselves unchanged. The
``models/`` PVM simulations run the un-shifted rounds and serve as the
differential oracles for the fork-choice/confirmation rules proper
(tests/test_variant_seam.py).

Hot loops (expiry-windowed tally, supermajority/ack tallies, subtree
accumulation) dispatch through ``ExecutionBackend`` — vectorized on
NumPy and jitted JAX, bit-identical (ops/variant_tally.py).
"""

from __future__ import annotations

from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    get_total_active_balance,
)


class VariantVoteLog:
    """One view's slot-granular vote overlay: the ``(validator, slot,
    root)`` head-vote table the expiry-windowed variants need (the
    carrier's ``Store.latest_messages`` only keeps target epochs), plus
    per-slot equivocation detection (pos-evolution.md:1411) and the
    view-merge buffer (:1528-1541).

    ``note_vote`` lands in the **pending buffer**; ``merge()`` — called by
    the variant at the slot boundary, the Merge phase of the
    propose-vote-merge template (:1602-1608) — folds it into the active
    tables. A message delivered mid-slot therefore influences no head
    query until the next boundary, which is precisely the view-merge
    defense against just-before-the-deadline delivery (:1328, :1540).
    """

    def __init__(self, group_id: int, buffered: bool = True):
        self.group_id = group_id
        self.buffered = buffered
        self.pending: list[tuple[int, int, bytes]] = []  # (v, slot, root)
        self.latest: dict[int, tuple[int, bytes]] = {}   # v -> (slot, root)
        self.slot_votes: dict[tuple[int, int], bytes] = {}  # (v, slot) -> root
        self.by_slot: dict[int, dict[int, bytes]] = {}   # slot -> {v: root}
        self.equivocators: set[int] = set()

    # -- Store.variant_view contract (called by specs/forkchoice.py) ----------

    def note_vote(self, indices, slot: int, root: bytes) -> None:
        slot = int(slot)
        root = bytes(root)
        for v in indices:
            self.pending.append((int(v), slot, root))
        if not self.buffered:
            self.merge()

    def note_equivocators(self, indices) -> None:
        """Slasher-evidenced equivocators (on_attester_slashing) are
        discounted at the variant layer too (pos-evolution.md:1438)."""
        self.equivocators.update(int(i) for i in indices)

    # -- merge phase -----------------------------------------------------------

    def merge(self) -> None:
        for v, slot, root in self.pending:
            prev = self.slot_votes.get((v, slot))
            if prev is not None and prev != root:
                # two head votes in one slot: discounted forever (:1411)
                self.equivocators.add(v)
                continue
            self.slot_votes[(v, slot)] = root
            self.by_slot.setdefault(slot, {})[v] = root
            cur = self.latest.get(v)
            if cur is None or slot > cur[0]:
                self.latest[v] = (slot, root)
        self.pending = []

    def prune(self, below_slot: int) -> None:
        """Drop per-slot records older than ``below_slot`` (the expiry
        window plus confirmation depth bound them; ``latest`` is O(N)
        already)."""
        for s in [s for s in self.by_slot if s < below_slot]:
            del self.by_slot[s]
        for key in [k for k in self.slot_votes if k[1] < below_slot]:
            del self.slot_votes[key]

    # -- snapshot --------------------------------------------------------------

    def state_blob(self) -> dict:
        return {
            "pending": [[v, s, r.hex()] for v, s, r in self.pending],
            "latest": {str(v): [s, r.hex()]
                       for v, (s, r) in sorted(self.latest.items())},
            "slot_votes": [[v, s, r.hex()]
                           for (v, s), r in sorted(self.slot_votes.items())],
            "equivocators": sorted(self.equivocators),
        }

    @classmethod
    def from_blob(cls, group_id: int, blob: dict,
                  buffered: bool = True) -> "VariantVoteLog":
        log = cls(group_id, buffered=buffered)
        log.pending = [(int(v), int(s), bytes.fromhex(r))
                       for v, s, r in blob.get("pending", [])]
        log.equivocators = set(blob.get("equivocators", []))
        for v, s, r in blob.get("slot_votes", []):
            root = bytes.fromhex(r)
            log.slot_votes[(int(v), int(s))] = root
            log.by_slot.setdefault(int(s), {})[int(v)] = root
        for v, (s, r) in blob.get("latest", {}).items():
            log.latest[int(v)] = (int(s), bytes.fromhex(r))
        return log


def densify_view(store) -> tuple[list, dict, "np.ndarray", "np.ndarray"]:
    """Store block-tree -> parent-index arrays (insertion order is
    topological, the ``subtree_weights`` contract). Returns
    (roots, index_of, parent int32[B], slot int64[B])."""
    import numpy as np
    roots = list(store.blocks.keys())
    index_of = {r: i for i, r in enumerate(roots)}
    parent = np.full(len(roots), -1, dtype=np.int32)
    slots = np.zeros(len(roots), dtype=np.int64)
    for i, root in enumerate(roots):
        block = store.blocks[root]
        slots[i] = int(block.slot)
        parent[i] = index_of.get(bytes(block.parent_root), -1)
    return roots, index_of, parent, slots


class ProtocolVariant:
    """Base seam: the behavior contract every variant implements.

    ``needs_view = False`` (Gasper) means no overlay is attached and the
    handlers' ``variant_view`` hook stays ``None`` — the default path is
    byte-for-byte today's driver."""

    name = "variant"
    needs_view = False

    def bind(self, sim) -> None:
        self.sim = sim

    def describe(self) -> dict:
        """Config fingerprint for checkpoints and repro bundles; must
        round-trip through ``variant_from_config``."""
        return {"kind": type(self).__name__}

    # -- per-view overlay ------------------------------------------------------

    def make_view(self, group_id: int):
        """The object attached as ``Store.variant_view`` (None = no
        overlay)."""
        return None

    def reset_view(self, group) -> None:
        """Crash-rejoin: the process died and its overlay with it; the
        checkpoint-synced store gets a fresh one (votes re-arrive via
        backfilled blocks exactly like the carrier's LMD table)."""

    # -- fork choice -----------------------------------------------------------

    def head(self, sim, group) -> bytes:
        raise NotImplementedError

    # -- slot hooks (driver calls; slot 0 included) ----------------------------

    def on_slot_start(self, sim, slot: int) -> None:
        """After the boundary tick: merge view buffers, process the
        completed vote round (fast confirmation, per-slot FFG)."""

    def on_slot_end(self, sim, slot: int) -> dict | None:
        """After the slot's duties: confirmation rules, telemetry record.
        Returns the ``variant`` event payload (None = nothing to emit)."""
        return None

    # -- audit surface (sim/monitors.VariantSafetyMonitor) ---------------------

    def finalized_checkpoints(self, group_id: int) -> list[tuple[bytes, int]]:
        """Variant-finalized (root, slot) pairs in this view (SSF)."""
        return []

    def fast_confirmations(self, group_id: int) -> list[tuple[bytes, int]]:
        """Fast-confirmed (root, slot) pairs in this view (:1562-1569)."""
        return []

    def slashable(self) -> set[int]:
        """Validators implicated by variant-level slashing evidence
        (double per-slot FFG votes, surround-the-ack, :1646)."""
        return set()

    def doctor(self, sim, slot: int) -> bool:
        """Forge a variant-level safety conflict (the chaos-fuzz CI
        negative). Returns False when the variant has no forgeable
        surface — the caller falls back to the store-level doctor."""
        return False

    # -- snapshot --------------------------------------------------------------

    def state_blob(self, sim) -> dict:
        return {}

    def restore_blob(self, sim, blob: dict) -> None:
        pass


# --- shared machinery for the expiry-window family ----------------------------


class ExpiryVariantBase(ProtocolVariant):
    """Common core of Goldfish / RLMD-GHOST / SSF: slot-granular vote
    overlays per view, the expiry-windowed equivocation-discounted GHOST
    head through the backend kernels, kappa-deep confirmation, optional
    3/4 fast confirmation."""

    needs_view = True
    eta: int = 4                      # vote expiry (pos-evolution.md:1585)
    kappa: int = 4                    # kappa-deep confirmation (:1556)
    fast_confirm: bool = False
    fast_confirm_threshold: float = 0.75
    subsample_rate: float = 1.0       # voter subsampling (:1545)
    use_vrf: bool = False             # min-VRF proposal preference (:1554)

    def __init__(self):
        self.views: dict[int, VariantVoteLog] = {}
        # per group: newest fast-confirmed / kappa-confirmed (root, slot)
        self.fast_confirmed: dict[int, tuple[bytes, int]] = {}
        self.confirmed: dict[int, tuple[bytes, int]] = {}

    def bind(self, sim) -> None:
        super().bind(sim)
        self._total_stake = int(get_total_active_balance(sim.genesis_state))

    def make_view(self, group_id: int) -> VariantVoteLog:
        log = VariantVoteLog(group_id, buffered=True)
        self.views[group_id] = log
        return log

    def reset_view(self, group) -> None:
        log = self.make_view(group.id)
        group.variant_view = log
        group.store.variant_view = log
        self.fast_confirmed.pop(group.id, None)
        self.confirmed.pop(group.id, None)

    # -- vote arrays -----------------------------------------------------------

    def _vote_arrays(self, store, log: VariantVoteLog, index_of: dict,
                     slot: int):
        """Latest-vote table -> kernel arrays. Weights come from the
        justified checkpoint state's registry like the carrier's LMD
        weights (pos-evolution.md:916); equivocators (variant-level AND
        slasher-evidenced) carry none (:1438); subsampled-out voters
        carry none (:1545)."""
        import numpy as np
        state = fc.justified_checkpoint_state(store)
        reg = state.validators
        n = len(reg)
        current_epoch = compute_epoch_at_slot(slot)
        items = sorted(log.latest.items())
        k = len(items)
        block_idx = np.full(k, -1, np.int64)
        vote_slot = np.zeros(k, np.int64)
        weight = np.zeros(k, np.int64)
        active = np.zeros(k, bool)
        banned = log.equivocators | store.equivocating_indices
        for j, (v, (s, root)) in enumerate(items):
            vote_slot[j] = s
            block_idx[j] = index_of.get(root, -1)
            if v in banned or v >= n:
                continue
            if not (int(reg.activation_epoch[v]) <= current_epoch
                    < int(reg.exit_epoch[v])) or bool(reg.slashed[v]):
                continue
            if self.subsample_rate < 1.0 and not self._vote_eligible(v, s):
                continue
            active[j] = True
            weight[j] = int(reg.effective_balance[v])
        return block_idx, vote_slot, weight, active

    def _vote_eligible(self, v: int, slot: int) -> bool:
        from pos_evolution_tpu_torch.models.pvm import vrf_is_eligible
        return vrf_is_eligible(v, slot, b"vote", self.subsample_rate)

    # -- head ------------------------------------------------------------------

    def _start_root(self, store, group_id: int) -> bytes:
        """Descent anchor: the newest block the variant refuses to roll
        back — fast-confirmed when present (:1568), else the carrier's
        justified checkpoint (history below it is shared state)."""
        fast = self.fast_confirmed.get(group_id)
        if fast is not None and fast[0] in store.blocks:
            return fast[0]
        jroot = bytes(store.justified_checkpoint.root)
        return jroot if jroot in store.blocks else next(iter(store.blocks))

    def head(self, sim, group) -> bytes:
        from pos_evolution_tpu_torch.backend import get_backend
        store = group.store
        log = self.views[group.id]
        slot = fc.get_current_slot(store)
        lo = max(slot - self.eta, 0)
        hi = slot - 1
        roots, index_of, parent, _slots = densify_view(store)
        block_idx, vote_slot, weight, active = self._vote_arrays(
            store, log, index_of, slot)
        backend = get_backend()
        tally = backend.variant_tally(block_idx, vote_slot, weight, active,
                                      lo, hi, len(roots))
        subtree = backend.subtree_weights(parent, tally)
        children: dict[int, list[int]] = {}
        for i, p in enumerate(parent):
            if p >= 0:
                children.setdefault(int(p), []).append(i)
        start = self._start_root(store, group.id)
        head = index_of.get(start, 0)
        while True:
            kids = children.get(head, [])
            if not kids:
                return roots[head]
            head = max(kids, key=lambda i: (int(subtree[i]),
                                            self._tie_key(store, roots[i]),
                                            roots[i]))

    def _tie_key(self, store, root: bytes):
        """Secondary descent key between equal-weight siblings. Goldfish
        prefers the minimal-VRF proposal of the slot (:1554) — encoded
        complemented so ``max`` picks the smallest VRF output."""
        if not self.use_vrf:
            return b""
        from pos_evolution_tpu_torch.models.pvm import vrf_output
        block = store.blocks[root]
        out = vrf_output(int(block.proposer_index), int(block.slot))
        return bytes(255 - b for b in out)

    # -- slot hooks ------------------------------------------------------------

    def on_slot_start(self, sim, slot: int) -> None:
        """Merge phase (the votes of slot-1 just crossed the boundary),
        then the completed round's confirmation processing."""
        for g in sim.groups:
            if g.crashed or g.id not in self.views:
                continue
            log = self.views[g.id]
            log.merge()
            log.prune(slot - self.eta - self.kappa - 8)
        round_slot = slot - 1
        if round_slot >= 1:
            for g in sim.groups:
                if g.crashed or g.id not in self.views:
                    continue
                if self.fast_confirm:
                    self._fast_confirm_round(sim, g, round_slot)
                self._process_round(sim, g, round_slot)

    def _process_round(self, sim, group, round_slot: int) -> None:
        """Variant-specific per-round processing (SSF's FFG gadget)."""

    def _fast_confirm_round(self, sim, group, round_slot: int) -> None:
        """3/4 fast confirmation (pos-evolution.md:1562-1569): a proposal
        of ``round_slot`` voted by more than ``threshold`` of the slot's
        eligible voters fast-confirms and is never rolled back (:1568).
        The per-candidate tally runs through the backend link kernel."""
        import numpy as np
        from pos_evolution_tpu_torch.backend import get_backend
        store = group.store
        log = self.views[group.id]
        votes = log.by_slot.get(round_slot)
        if not votes:
            return
        candidates = [r for r, b in store.blocks.items()
                      if int(b.slot) == round_slot]
        if not candidates:
            return
        cand_idx = {r: i for i, r in enumerate(candidates)}
        voters = sorted(v for v in votes if v not in log.equivocators)
        link_idx = np.array([cand_idx.get(votes[v], -1) for v in voters],
                            np.int64)
        ones = np.ones(len(voters), np.int64)
        counts = get_backend().link_tally(link_idx, ones,
                                          np.ones(len(voters), bool),
                                          len(candidates))
        eligible = self._eligible_count(store, candidates[0], round_slot)
        if not eligible:
            return
        best = int(np.argmax(counts))
        if counts[best] > self.fast_confirm_threshold * eligible:
            root = candidates[best]
            prev = self.fast_confirmed.get(group.id)
            if prev is None or round_slot > prev[1]:
                self.fast_confirmed[group.id] = (root, round_slot)

    def _eligible_count(self, store, candidate_root: bytes,
                        round_slot: int) -> int:
        """The denominator of :1567 — the slot's (subsampled) committee,
        awake or not, derived from the candidate proposal's own state."""
        from pos_evolution_tpu_torch.sim.adversary import slot_committee
        state = store.block_states.get(candidate_root)
        if state is None:
            return 0
        committee = [int(v) for v in slot_committee(state, round_slot)]
        if self.subsample_rate >= 1.0:
            return len(committee)
        return sum(1 for v in committee
                   if self._vote_eligible(v, round_slot))

    def on_slot_end(self, sim, slot: int) -> dict | None:
        record = {"variant": self.name, "slot": slot, "groups": {}}
        for g in sim.groups:
            if g.crashed or g.id not in self.views:
                continue
            store = g.store
            head = self.head(sim, g)
            confirmed = self._kappa_confirmed(store, g.id, head, slot)
            if confirmed is not None:
                prev = self.confirmed.get(g.id)
                if prev is None or confirmed[1] >= prev[1]:
                    self.confirmed[g.id] = confirmed
            fast = self.fast_confirmed.get(g.id)
            conf = self.confirmed.get(g.id)
            record["groups"][str(g.id)] = {
                "head": head.hex()[:16],
                "head_slot": int(store.blocks[head].slot),
                "confirmed_slot": conf[1] if conf else None,
                "fast_confirmed_slot": fast[1] if fast else None,
                "equivocators": len(self.views[g.id].equivocators),
            }
        return record

    def _kappa_confirmed(self, store, group_id: int, head: bytes,
                         slot: int) -> tuple[bytes, int] | None:
        """kappa-deep confirmation (pos-evolution.md:1556): the head's
        ancestor at slot <= slot - kappa; a fast confirmation deeper in
        the chain than it is never rolled back (:1568)."""
        cutoff = slot - self.kappa
        cur = head
        while cur in store.blocks and int(store.blocks[cur].slot) > cutoff:
            nxt = bytes(store.blocks[cur].parent_root)
            if nxt not in store.blocks:
                break
            cur = nxt
        if cur not in store.blocks:
            return None
        fast = self.fast_confirmed.get(group_id)
        if fast is not None and fast[0] in store.blocks \
                and fast[1] > int(store.blocks[cur].slot) \
                and self._descends(store, fast[0], cur):
            return fast
        return (cur, int(store.blocks[cur].slot))

    @staticmethod
    def _descends(store, descendant: bytes, ancestor: bytes) -> bool:
        cur = descendant
        while cur in store.blocks:
            if cur == ancestor:
                return True
            nxt = bytes(store.blocks[cur].parent_root)
            if nxt == cur:
                return False
            cur = nxt
        return False

    def fast_confirmations(self, group_id: int) -> list[tuple[bytes, int]]:
        fast = self.fast_confirmed.get(group_id)
        return [fast] if fast is not None else []

    def doctor(self, sim, slot: int) -> bool:
        """Forge CONFLICTING same-slot fast confirmations into the first
        two views — two >3/4 quorums that never existed, which the
        ``VariantSafetyMonitor`` must flag (its variant evidence set is
        empty, so the verdict must be ``protocol_violation``)."""
        if not self.fast_confirm or len(sim.groups) < 2:
            return False
        self.fast_confirmed[sim.groups[0].id] = (b"\x0d" * 32, slot)
        self.fast_confirmed[sim.groups[1].id] = (b"\x0e" * 32, slot)
        return True

    # -- snapshot --------------------------------------------------------------

    def state_blob(self, sim) -> dict:
        return {
            "views": {str(gid): log.state_blob()
                      for gid, log in sorted(self.views.items())},
            "fast_confirmed": {str(g): [r.hex(), s]
                               for g, (r, s) in
                               sorted(self.fast_confirmed.items())},
            "confirmed": {str(g): [r.hex(), s]
                          for g, (r, s) in sorted(self.confirmed.items())},
        }

    def restore_blob(self, sim, blob: dict) -> None:
        for gid, vb in blob.get("views", {}).items():
            gid = int(gid)
            self.views[gid] = VariantVoteLog.from_blob(gid, vb, buffered=True)
        self.fast_confirmed = {int(g): (bytes.fromhex(r), int(s))
                               for g, (r, s) in
                               blob.get("fast_confirmed", {}).items()}
        self.confirmed = {int(g): (bytes.fromhex(r), int(s))
                          for g, (r, s) in blob.get("confirmed", {}).items()}
        for g in sim.groups:
            if g.id in self.views:
                g.variant_view = self.views[g.id]
                g.store.variant_view = self.views[g.id]


def variant_from_config(cfg: dict | None):
    """Rebuild a variant from its ``describe()`` fingerprint (checkpoint
    resume, chaos repro bundles, the variant matrix)."""
    from pos_evolution_tpu_torch.variants import (
        GasperVariant,
        GoldfishVariant,
        RlmdGhostVariant,
        SsfVariant,
    )
    if cfg is None:
        return GasperVariant()
    kind = cfg["kind"]
    if kind == "GasperVariant":
        return GasperVariant()
    if kind == "GoldfishVariant":
        return GoldfishVariant(
            kappa=cfg.get("kappa", 4),
            fast_confirm=cfg.get("fast_confirm", True),
            fast_confirm_threshold=cfg.get("fast_confirm_threshold", 0.75),
            subsample_rate=cfg.get("subsample_rate", 1.0))
    if kind == "RlmdGhostVariant":
        return RlmdGhostVariant(eta=cfg.get("eta", 4),
                                kappa=cfg.get("kappa", 4))
    if kind == "SsfVariant":
        return SsfVariant(eta=cfg.get("eta", 4),
                          fast_confirm_threshold=cfg.get(
                              "fast_confirm_threshold", 0.75))
    raise ValueError(f"unknown variant kind {kind!r}")
