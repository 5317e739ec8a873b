"""Attack scenario reproductions (SURVEY.md §2.10; pos-evolution.md:1319-1527).

Two tiers:

- **Simulation-driven** (the public entry points): ``run_ex_ante_reorg``,
  ``run_ex_ante_reorg_with_boost`` and ``run_lmd_balancing_attack`` run
  the adversary *inside* ``Simulation`` as ``AdversaryStrategy``
  instances (sim/adversary.py) — honest proposers/attesters follow the
  ordinary duty loop, the adversary acts through the per-slot hooks, and
  monitors/telemetry/faults can be layered on top. Their asserted
  outcomes are pinned bit-identical to the scripted originals by
  tests/test_attacks.py.
- **Scripted oracles** (``scripted_run_*``): the original one-shot
  reproductions against raw fork-choice stores, with the reference's
  exact numbers. Kept as the ground truth the sim-driven versions are
  compared against, and for the scenarios whose store-level mechanics
  the driver deliberately does not model (``run_bouncing_attack_step``,
  ``run_balancing_attack``).

The scenarios (pos-evolution.md):

- ex-ante reorg (:1516-1522): a hidden block + 1 private attestation
  beats the next honest proposal pre-boost; the mainline W/4 boost kills
  it (:1350); the 7%-adversary / 0.8W-boost variant (:1525-1526) defeats
  even the boost (W=100 per slot, 7 Byzantine per slot).
- LMD balancing despite boost (:1379-1403): equivocating release blocks
  credit each view's LMD table 80:0 for its own chain; honest votes
  split forever.
- swayer balancing (:1321-1348): withheld votes keep two chains tied so
  neither reaches 2/3 and finality halts (pre-boost protocol).

The adversary capabilities used are exactly the reference's model: knowing
honest decision times, targeted just-in-time delivery, and inability of
honest validators to re-gossip instantly (pos-evolution.md:1328).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.sim.adversary import committee_attestations
from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.specs.genesis import make_genesis
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    get_beacon_committee,
    get_committee_count_per_slot,
)
from pos_evolution_tpu_torch.specs.transition import state_transition
from pos_evolution_tpu_torch.specs.validator import (
    advance_state_to_slot,
    build_block,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root


def _tick(store: fc.Store, slot: int, offset: int = 0) -> None:
    fc.on_tick(store, store.genesis_time + slot * cfg().seconds_per_slot + offset)


def _attest_interval(c) -> int:
    return c.seconds_per_slot // c.intervals_per_slot


def _chain_contains(store: fc.Store, head: bytes, root: bytes) -> bool:
    cur = head
    while True:
        if cur == root:
            return True
        block = store.blocks[cur]
        parent = bytes(block.parent_root)
        if parent == cur or parent not in store.blocks:
            return False
        cur = parent


# committee-restricted aggregates now live in sim/adversary.py (the same
# routine the in-loop strategies use); keep the historical private name
# for the scripted oracles' call sites
_committee_attestations = committee_attestations


# --- ex-ante reorg (pos-evolution.md:1503-1526) -------------------------------

def scripted_run_ex_ante_reorg(n_validators: int = 64) -> dict:
    """Simple 1-block ex-ante reorg (pos-evolution.md:1516-1522).

    Slot layout (all within epoch 0):
      slot 1: honest block B1
      slot 2: adversary privately builds B2 on B1 and attests to it; honest
              slot-2 committee sees nothing and attests B1
      slot 3: honest proposer publishes B3 on B1; adversary simultaneously
              releases B2 + its attestation; honest slot-3 committee sees B2
              outweighing B3
      slot 4: next proposer builds on the head
    Returns whether B3 (the honest slot-3 block) was reorged out.
    """
    c = cfg()
    state, anchor = make_genesis(n_validators)
    store = fc.get_forkchoice_store(state, anchor)

    # slot 1: honest block B1.
    _tick(store, 1)
    sb1 = build_block(state, 1)
    fc.on_block(store, sb1)
    r1 = hash_tree_root(sb1.message)
    s1 = store.block_states[r1]

    # slot 2: adversary hides B2; honest committee attests B1.
    s2_view = advance_state_to_slot(s1, 2)
    committee2 = np.concatenate([
        get_beacon_committee(s2_view, 2, i)
        for i in range(get_committee_count_per_slot(s2_view, 0))])
    adversary = int(committee2[0])
    honest2 = committee2[committee2 != adversary]

    sb2_hidden = build_block(s1, 2, graffiti=b"\xad" * 32)
    r2 = hash_tree_root(sb2_hidden.message)
    hidden_state = advance_state_to_slot(s1, 2)
    hidden_att = _committee_attestations(
        hidden_state, 2, r2, participants=np.array([adversary]))
    _tick(store, 2)
    honest_atts2 = _committee_attestations(s2_view, 2, r1,
                                           participants=honest2)

    # slot 3: honest B3 on B1 (published at slot start but boost may be 0),
    # adversary releases B2 + private attestation just before attest time.
    _tick(store, 3)
    for att in honest_atts2:
        fc.on_attestation(store, att)
    sb3 = build_block(s1, 3, graffiti=b"\x33" * 32)
    fc.on_block(store, sb3)
    r3 = hash_tree_root(sb3.message)
    fc.on_block(store, sb2_hidden)
    for att in hidden_att:
        fc.on_attestation(store, att)

    # honest slot-3 committee votes for the head they now see
    head_at_3 = fc.get_head(store)
    s3_view = advance_state_to_slot(store.block_states[head_at_3], 3)
    committee3 = np.concatenate([
        get_beacon_committee(s3_view, 3, i)
        for i in range(get_committee_count_per_slot(s3_view, 0))])
    honest3 = committee3[committee3 != adversary]
    atts3 = _committee_attestations(s3_view, 3, head_at_3, participants=honest3)

    # slot 4: head after honest votes land.
    _tick(store, 4)
    for att in atts3:
        fc.on_attestation(store, att)
    head = fc.get_head(store)
    return {
        "b2_root": r2,
        "b3_root": r3,
        "head_at_slot_3": head_at_3,
        "final_head": head,
        "b3_reorged": not _chain_contains(store, head, r3),
        "b2_canonical": _chain_contains(store, head, r2),
    }


def scripted_run_ex_ante_reorg_with_boost(n_validators: int = 800) -> dict:
    """Ex-ante reorg despite boost (pos-evolution.md:1525-1526).

    Reference numbers: W = 100 validators per slot, boost W_p = 0.8W,
    7 Byzantine per slot. The adversary hides B2 (slot 2) with 7 votes,
    lets the honest B3 (slot 3, boosted) collect 93 honest votes but votes
    its own 7 of slot 3 for B2, then proposes B4 on B2 at slot 4 timely:
    left subtree 7 + 7 + 80(boost) = 94 > 93 — honest validators switch.
    """
    c = cfg()
    assert c.proposer_score_boost_percent == 80, "scenario expects 0.8W boost"
    state, anchor = make_genesis(n_validators)
    per_slot = n_validators // c.slots_per_epoch
    store = fc.get_forkchoice_store(state, anchor)

    _tick(store, 1)
    sb1 = build_block(state, 1)
    fc.on_block(store, sb1)
    r1 = hash_tree_root(sb1.message)
    s1 = store.block_states[r1]

    def slot_committee(view_state, slot):
        return np.concatenate([
            get_beacon_committee(view_state, slot, i)
            for i in range(get_committee_count_per_slot(view_state, 0))])

    # slot 2: hidden adversarial B2 + 7 private votes.
    s2_view = advance_state_to_slot(s1, 2)
    committee2 = slot_committee(s2_view, 2)
    adv2 = committee2[:7]
    honest2 = committee2[7:]
    sb2_hidden = build_block(s1, 2, graffiti=b"\xad" * 32)
    r2 = hash_tree_root(sb2_hidden.message)
    adv_atts2 = _committee_attestations(advance_state_to_slot(s1, 2), 2, r2,
                                        participants=adv2)
    honest_atts2 = _committee_attestations(s2_view, 2, r1, participants=honest2)

    # slot 3: honest B3 published timely (gets the 0.8W boost), honest
    # committee votes it; adversary's 7 vote for still-hidden B2.
    _tick(store, 3)
    for att in honest_atts2:
        fc.on_attestation(store, att)
    sb3 = build_block(s1, 3, graffiti=b"\x33" * 32)
    fc.on_block(store, sb3)  # timely -> boost while slot 3 lasts
    r3 = hash_tree_root(sb3.message)
    assert store.proposer_boost_root == r3
    s3_view = advance_state_to_slot(store.block_states[r3], 3)
    committee3 = slot_committee(s3_view, 3)
    adv3 = committee3[:7]
    honest3 = committee3[7:]
    honest_atts3 = _committee_attestations(s3_view, 3, r3, participants=honest3)
    adv_atts3 = _committee_attestations(advance_state_to_slot(s1, 3), 3, r2,
                                        participants=adv3)

    # slot 4: adversary releases everything and proposes B4 on B2, timely.
    _tick(store, 4)
    for att in honest_atts3:
        fc.on_attestation(store, att)
    fc.on_block(store, sb2_hidden)
    for att in adv_atts2 + adv_atts3:
        fc.on_attestation(store, att)
    sb4 = build_block(store.block_states[r2], 4, graffiti=b"\x44" * 32)
    fc.on_block(store, sb4)  # timely -> 0.8W boost on the adversarial branch
    r4 = hash_tree_root(sb4.message)

    head = fc.get_head(store)
    return {
        "per_slot_committee": per_slot,
        "head": head,
        "b3_reorged": not _chain_contains(store, head, r3),
        "b4_canonical": _chain_contains(store, head, r4),
        "b2_canonical": _chain_contains(store, head, r2),
    }


# --- bouncing attack step (pos-evolution.md:1065-1072) ------------------------

def run_bouncing_attack_step(n_validators: int = 64) -> dict:
    """One full bounce step with real states, and the mitigation in action.

    The bounce (pos-evolution.md:1067-1071): the store follows chain A with
    justified checkpoint (2, A); the adversary releases a chain-B block
    whose post-state carries a *higher, conflicting* justification (3, B).
    Released mid-epoch this would flip every validator's fork choice; the
    mitigation (:1054, :1072) defers the conflicting update to
    ``best_justified_checkpoint`` when it arrives past
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED, promoting only at the epoch boundary
    (:950-955).

    Two forks diverge at genesis (identical committees — the RANDAO mixes
    match, so seeds do too). Chain A withholds its epoch-2 target
    attestations from blocks until slot 2C+0' and crosses the 3->4 boundary
    to justify (2, A-EBB2); chain B does the same one epoch later to
    justify (3, B-EBB3). Honest validators voted target epoch 2 on A and
    target epoch 3 on B — different target epochs, NOT slashable, exactly
    the chain-switching behavior the bounce exploits.
    """
    c = cfg()
    spe = c.slots_per_epoch
    state, anchor = make_genesis(n_validators)
    store = fc.get_forkchoice_store(state, anchor)
    everyone = np.arange(n_validators, dtype=np.int64)

    def extend(parent_state, slot, atts=(), tag=0):
        sb = build_block(parent_state, slot, attestations=list(atts),
                         graffiti=bytes([tag]) * 32)
        post = parent_state.copy()
        state_transition(post, sb, True)
        return sb, post

    # --- chain A: justifies epoch 2 in its slot-4C block ---
    a1, sa1 = extend(state, 1, tag=0xA1)
    a16, sa16 = extend(sa1, 2 * spe, tag=0xA2)           # A's epoch-2 EBB
    atts_a = []
    for slot in range(2 * spe, 3 * spe):                  # epoch-2 votes
        view = advance_state_to_slot(sa16, slot)
        atts_a.extend(_committee_attestations(
            view, slot, hash_tree_root(a16.message), participants=everyone))
    a24, sa24 = extend(sa16, 3 * spe, atts=atts_a[: c.max_attestations], tag=0xA3)
    a32, sa32 = extend(sa24, 4 * spe, tag=0xA4)           # crosses 3->4: justifies 2
    assert int(sa32.current_justified_checkpoint.epoch) == 2

    # --- chain B: justifies epoch 3 in its slot-5C block ---
    b1, sb1 = extend(state, 1, tag=0xB1)
    b24, sb24 = extend(sb1, 3 * spe, tag=0xB2)            # B's epoch-3 EBB
    atts_b = []
    for slot in range(3 * spe, 4 * spe):                  # epoch-3 votes
        view = advance_state_to_slot(sb24, slot)
        atts_b.extend(_committee_attestations(
            view, slot, hash_tree_root(b24.message), participants=everyone))
    b32, sb32 = extend(sb24, 4 * spe, atts=atts_b[: c.max_attestations], tag=0xB3)
    b40, sb40 = extend(sb32, 5 * spe, tag=0xB4)           # crosses 4->5: justifies 3
    assert int(sb40.current_justified_checkpoint.epoch) == 3

    # Phase 1: chain A delivered early in epoch 4 -> store adopts (2, A).
    early = 4 * spe + 1
    assert early % spe < c.safe_slots_to_update_justified
    _tick(store, early)
    for sb in (a1, a16, a24, a32):
        fc.on_block(store, sb)
    justified_a = int(store.justified_checkpoint.epoch)
    root_a = bytes(store.justified_checkpoint.root)

    # Phase 2: chain B (with the conflicting higher justification) released
    # LATE in epoch 5 -> mitigation defers it.
    late = 5 * spe + c.safe_slots_to_update_justified + 1
    _tick(store, late)
    for sb in (b1, b24, b32, b40):
        fc.on_block(store, sb)
    deferred_justified = int(store.justified_checkpoint.epoch)
    deferred_root = bytes(store.justified_checkpoint.root)
    best = int(store.best_justified_checkpoint.epoch)

    # Phase 3: the next epoch boundary promotes best_justified.
    _tick(store, 6 * spe)
    promoted = int(store.justified_checkpoint.epoch)
    promoted_root = bytes(store.justified_checkpoint.root)

    return {
        "phase1_justified": justified_a,
        "phase1_is_chain_a": root_a == hash_tree_root(a16.message),
        "deferred_justified": deferred_justified,
        "deferral_held": deferred_root == root_a and deferred_justified == justified_a,
        "best_after_release": best,
        "promoted_at_boundary": promoted,
        "promoted_is_chain_b": promoted_root == hash_tree_root(b24.message),
    }


# --- LMD balancing despite proposer boost (pos-evolution.md:1379-1403) --------

def scripted_run_lmd_balancing_attack(n_validators: int = 800) -> dict:
    """The balancing attack that survives proposer boost, using the LMD
    first-received rule (pos-evolution.md:1383: equal-epoch votes never
    replace the table entry).

    Reference numbers (:1385): W = 100 validators per slot, 20% Byzantine
    (20 per slot), five consecutive Byzantine proposers. Slots 1-4 build
    two private chains with equivocating votes on each; at slot 5 two
    equivocating blocks carrying the 80 votes per chain are released to the
    two honest halves. Each half's LMD table permanently credits its chain
    80:0 (:1394), so honest votes split every slot thereafter despite the
    boost flipping temporarily (:1396-1399).
    """
    c = cfg()
    state, anchor = make_genesis(n_validators)
    store_A = fc.get_forkchoice_store(state, anchor)
    store_B = fc.get_forkchoice_store(state, anchor)
    stores = (store_A, store_B)

    def committee_of(slot):
        view = advance_state_to_slot(state, slot)
        count = get_committee_count_per_slot(view, compute_epoch_at_slot(slot))
        return [get_beacon_committee(view, slot, i) for i in range(count)]

    # Adaptive corruption: the proposers of slots 1-5 (they equivocate) +
    # 20 members of each slot committee (the adversary picks whom to
    # corrupt, :183-185).
    from pos_evolution_tpu_torch.specs.helpers import get_beacon_proposer_index
    corrupted: set[int] = set()
    per_slot_byz: dict[int, list[int]] = {}
    for slot in range(1, 6):
        flat = [int(v) for com in committee_of(slot) for v in com]
        per_slot_byz[slot] = flat[:20]
        corrupted.update(per_slot_byz[slot])
        corrupted.add(int(get_beacon_proposer_index(
            advance_state_to_slot(state, slot))))

    # --- slots 1-4: two private chains, equivocating votes on both ---
    chain_states = {"L": state, "R": state}
    chain_blocks = {"L": [], "R": []}
    chain_votes = {"L": [], "R": []}
    for slot in range(1, 5):
        for side, graffiti in (("L", b"\x1f" * 32), ("R", b"\xf1" * 32)):
            sb = build_block(chain_states[side], slot, graffiti=graffiti)
            chain_blocks[side].append(sb)
            post = chain_states[side].copy()
            state_transition(post, sb, True)
            chain_states[side] = post
            head_root = hash_tree_root(sb.message)
            head_state = advance_state_to_slot(post, slot)
            # the slot's 20 Byzantine attesters vote this chain's head too
            # (equivocation across chains)
            votes = _committee_attestations(
                head_state, slot, head_root,
                participants=np.array(per_slot_byz[slot], dtype=np.int64))
            chain_votes[side].extend(votes)

    # --- slot 5: equivocating blocks carry each chain's 80 votes ---
    release_blocks = {}
    for side in ("L", "R"):
        assert len(chain_votes[side]) <= c.max_attestations, \
            "equivocating votes exceed the block's attestation capacity"
        sb5 = build_block(chain_states[side], 5,
                          attestations=chain_votes[side],
                          graffiti=(b"\x55" if side == "L" else b"\xaa") * 32)
        release_blocks[side] = sb5

    def deliver(store, side):
        for sb in chain_blocks[side] + [release_blocks[side]]:
            fc.on_block(store, sb)
            for att in sb.message.body.attestations:
                try:
                    fc.on_attestation(store, att, is_from_block=True)
                except AssertionError:
                    pass

    # deliver: each view gets "its" chain timely at slot 5 (boost applies),
    # the other chain only after the attesting interval (no boost, and the
    # equal-epoch LMD entries keep the first-received chain, :1383, :1394)
    for s in stores:
        _tick(s, 5)
    deliver(store_A, "L")
    deliver(store_B, "R")
    for s in stores:
        _tick(s, 5, offset=_attest_interval(c) + 1)
    deliver(store_A, "R")
    deliver(store_B, "L")

    gwei32 = 32 * 10**9
    firstL = hash_tree_root(chain_blocks["L"][0].message)
    firstR = hash_tree_root(chain_blocks["R"][0].message)
    wA_L = fc.get_latest_attesting_balance(store_A, firstL)
    wA_R = fc.get_latest_attesting_balance(store_A, firstR)
    wB_L = fc.get_latest_attesting_balance(store_B, firstL)
    wB_R = fc.get_latest_attesting_balance(store_B, firstR)

    # --- slots 6+: honest halves keep voting their own side ---
    heads_disagree = []
    honest = [v for v in range(n_validators) if v not in corrupted]
    halves = (set(honest[0::2]), set(honest[1::2]))
    pending_cross: list[tuple[int, object]] = []  # (dst_store_idx, att)
    for slot in range(6, 11):
        for s in stores:
            _tick(s, slot)
        # last slot's cross-view votes arrive now (gossip delay Delta; they
        # never displace equal-epoch LMD entries, :1383)
        for dst, a in pending_cross:
            try:
                fc.on_attestation(stores[dst], a, is_from_block=True)
            except AssertionError:
                pass
        pending_cross = []
        for idx, (store, half) in enumerate(zip(stores, halves)):
            head = fc.get_head(store)
            head_state = advance_state_to_slot(store.block_states[head], slot)
            atts = _committee_attestations(
                head_state, slot, head,
                participants=np.array(sorted(half), dtype=np.int64))
            for a in atts:
                try:
                    fc.on_attestation(store, a, is_from_block=True)
                except AssertionError:
                    pass
                pending_cross.append((1 - idx, a))
        heads_disagree.append(fc.get_head(store_A) != fc.get_head(store_B))

    return {
        "viewA_L_votes": wA_L // gwei32, "viewA_R_votes": wA_R // gwei32,
        "viewB_L_votes": wB_L // gwei32, "viewB_R_votes": wB_R // gwei32,
        "heads_disagree": heads_disagree,
        "justified_A": int(store_A.justified_checkpoint.epoch),
        "justified_B": int(store_B.justified_checkpoint.epoch),
    }


# --- balancing attack (pos-evolution.md:1321-1348) ----------------------------

@dataclass
class BalancingResult:
    slots_run: int
    justified_epoch_L: int
    justified_epoch_R: int
    finalized_epoch_L: int
    finalized_epoch_R: int
    head_L: bytes
    head_R: bytes
    tie_maintained: bool


def run_balancing_attack(n_validators: int = 64, n_epochs: int = 3,
                         corrupted_fraction: float = 0.25,
                         debug: bool = False) -> BalancingResult:
    """The original balancing attack against pre-boost Gasper.

    Strategy (pos-evolution.md:1330-1348): an adversarial slot-1 proposer
    equivocates into BL/BR; honest committees are split into two views L/R
    by targeted just-in-time delivery; per slot, withheld adversarial
    ("swayer") votes are released one to each side just before attesting so
    that each side sees its own chain leading by one vote. Honest votes are
    gossiped to everyone and stay tied.
    """
    c = cfg()
    assert c.proposer_score_boost_percent == 0, \
        "the original balancing attack targets pre-boost Gasper"
    state, anchor = make_genesis(n_validators)
    anchor_root = hash_tree_root(anchor)
    store_L = fc.get_forkchoice_store(state, anchor)
    store_R = fc.get_forkchoice_store(state, anchor)
    stores = (store_L, store_R)

    n_corrupted = int(n_validators * corrupted_fraction)
    corrupted = set(range(n_corrupted))  # adversary corrupts f validators
    end_slot = n_epochs * c.slots_per_epoch

    # slot 1: the adversarial proposer equivocates: BL and BR on genesis.
    for s in stores:
        _tick(s, 1)
    sb_L = build_block(state, 1, graffiti=b"\x1f" * 32)
    sb_R = build_block(state, 1, graffiti=b"\xf1" * 32)
    rL, rR = hash_tree_root(sb_L.message), hash_tree_root(sb_R.message)
    # Each side sees "its" block in time to attest; the other arrives later
    # in the slot (still before Δ after the release).
    fc.on_block(store_L, sb_L)
    fc.on_block(store_R, sb_R)

    # Per-side chain states (tips).
    tip = {0: rL, 1: rR}

    # Swayer vote banks: withheld votes for the left/right tip.
    bank: dict[int, list] = {0: [], 1: []}
    pending_honest: list = []   # honest votes gossiped to everyone next slot
    pending_cross: list = []    # late cross-delivery of each side's block
    pending_cross.append(("block", sb_L, 1))
    pending_cross.append(("block", sb_R, 0))

    tie_maintained = True
    for slot in range(1, end_slot + 1):
        if slot > 1:
            for s in stores:
                _tick(s, slot)
            # deliver last slot's gossip to both sides
            for att in pending_honest:
                for s in stores:
                    try:
                        fc.on_attestation(s, att)
                    except AssertionError:
                        pass
            pending_honest = []
            for kind, payload, side in pending_cross:
                try:
                    if kind == "block":
                        fc.on_block(stores[side], payload)
                    else:
                        fc.on_attestation(stores[side], payload)
                except AssertionError:
                    pass
            pending_cross = []

            # Swayer release: deliver exactly as many banked withheld votes
            # to each side as needed for that side to see its own chain
            # strictly leading, just before the proposer/attesters of this
            # slot act. (The adversary knows honest decision times and
            # targets delivery, pos-evolution.md:1328; LMD epoch rollover
            # replaces old votes unevenly, so the required number varies.)
            # Released votes reach the other side a slot later via gossip.
            fork_roots = (rL, rR)
            for side in (0, 1):
                own, other = fork_roots[side], fork_roots[1 - side]
                while bank[side]:
                    w_own = fc.get_latest_attesting_balance(stores[side], own)
                    w_other = fc.get_latest_attesting_balance(stores[side], other)
                    if w_own > w_other:
                        break
                    att = bank[side].pop(0)
                    try:
                        fc.on_attestation(stores[side], att)
                    except AssertionError:
                        pass
                    pending_cross.append(("att", att, 1 - side))

            # Honest proposer of this slot extends their side's head. The
            # proposer's side is wherever the adversary put them; resolve by
            # computing the proposer on side L's view (identical registries).
            head_sides = []
            for side, s in enumerate(stores):
                head = fc.get_head(s)
                head_sides.append(head)
            # Proposer proposes on its own view; deliver the block to both
            # sides within the slot.
            from pos_evolution_tpu_torch.specs.helpers import get_beacon_proposer_index
            view = advance_state_to_slot(
                stores[0].block_states[head_sides[0]], slot)
            proposer = get_beacon_proposer_index(view)
            proposer_side = int(proposer) % 2  # adversary-chosen view assignment
            if int(proposer) not in corrupted:
                parent = head_sides[proposer_side]
                sb = build_block(stores[proposer_side].block_states[parent], slot)
                new_root = hash_tree_root(sb.message)
                for s in stores:
                    try:
                        fc.on_block(s, sb)
                    except AssertionError:
                        pass
                tip[proposer_side] = new_root

        # Committee of this slot, split adaptively: corrupted members feed
        # the swayer banks; honest members are split half/half between views.
        view0 = advance_state_to_slot(stores[0].block_states[fc.get_head(stores[0])],
                                      slot)
        epoch = compute_epoch_at_slot(slot)
        committee = np.concatenate([
            get_beacon_committee(view0, slot, i)
            for i in range(get_committee_count_per_slot(view0, epoch))])
        corrupted_here = [int(v) for v in committee if int(v) in corrupted]
        honest_here = np.array([int(v) for v in committee if int(v) not in corrupted],
                               dtype=np.int64)
        # Sticky view assignment by validator-index parity: each honest
        # validator is targeted with the same side every epoch, so LMD
        # epoch-rollover replacements never move weight across the fork
        # (the adversary's targeted-delivery power, pos-evolution.md:1328).
        halves = (honest_here[honest_here % 2 == 0],
                  honest_here[honest_here % 2 == 1])

        # Honest halves attest to their side's current head.
        for side, half in enumerate(halves):
            if half.size == 0:
                continue
            s = stores[side]
            head = fc.get_head(s)
            head_state = advance_state_to_slot(s.block_states[head], slot)
            atts = _committee_attestations(head_state, slot, head, participants=half)
            pending_honest.extend(atts)

        # Prune withheld votes whose target epoch fell out of the
        # on_attestation validity window (current/previous epoch).
        for side in (0, 1):
            bank[side] = [a for a in bank[side]
                          if int(a.data.target.epoch) >= epoch - 1]

        # Corrupted members bank fresh withheld votes for each side's tip,
        # alternating so both banks stay stocked.
        for k, v in enumerate(corrupted_here):
            side = (k + slot) % 2
            s = stores[side]
            head = fc.get_head(s)
            head_state = advance_state_to_slot(s.block_states[head], slot)
            atts = _committee_attestations(head_state, slot, head,
                                           participants=np.array([v]))
            bank[side].extend(atts)

        # Check the split is alive: the two views disagree on the head.
        if slot >= 2 and fc.get_head(store_L) == fc.get_head(store_R):
            tie_maintained = False
        if debug:
            def wf(s, r):
                try:
                    return fc.get_latest_attesting_balance(s, r) // (32 * 10**9)
                except KeyError:
                    return -1
            print(f"slot {slot}: same_head={fc.get_head(store_L) == fc.get_head(store_R)}"
                  f" bank=({len(bank[0])},{len(bank[1])})"
                  f" L:(L={wf(store_L, rL)},R={wf(store_L, rR)})"
                  f" R:(L={wf(store_R, rL)},R={wf(store_R, rR)})")

    return BalancingResult(
        slots_run=end_slot,
        justified_epoch_L=int(store_L.justified_checkpoint.epoch),
        justified_epoch_R=int(store_R.justified_checkpoint.epoch),
        finalized_epoch_L=int(store_L.finalized_checkpoint.epoch),
        finalized_epoch_R=int(store_R.finalized_checkpoint.epoch),
        head_L=fc.get_head(store_L),
        head_R=fc.get_head(store_R),
        tie_maintained=tie_maintained,
    )


# --- Simulation-driven scenarios (sim/adversary.py strategies) ----------------
#
# The entry points below run the SAME attacks inside ``Simulation``: honest
# proposers/attesters follow the ordinary duty loop, the adversary acts
# through AdversaryStrategy hooks, and the asserted outcome fields are
# pinned equal to the scripted oracles above by tests/test_attacks.py.


def balanced_split_schedule(n_validators: int, corrupted: set,
                            isolate: bool = False) -> "Schedule":
    """Two view groups with the HONEST set split exactly in half by rank
    (the reference's halves, pos-evolution.md:1330: the adversary assigns
    each honest validator a sticky side). A plain ``partition_schedule``
    splits by index parity, which leaves the halves unequal once the
    corrupted set is removed — and an unequal split erodes the balancing
    margin (own-side equivocating votes minus cross-side boost) until the
    attack collapses for the wrong reason. ``isolate=True`` additionally
    withholds ALL cross-group delivery (blocks and attestations), the
    split-brain network of ``sim/adversary.SplitVoter``."""
    from pos_evolution_tpu_torch.sim.schedule import Schedule
    group_of = np.zeros(n_validators, dtype=np.int64)
    honest = [v for v in range(n_validators) if v not in corrupted]
    for k, v in enumerate(honest):
        group_of[v] = k % 2
    for k, v in enumerate(sorted(corrupted)):
        group_of[v] = k % 2
    kwargs = {}
    if isolate:
        kwargs["block_delay"] = (
            lambda proposer, slot, group:
            0.0 if int(group_of[proposer]) == group else None)
        kwargs["attestation_delay"] = (
            lambda src_group, slot, group:
            0.0 if src_group == group else None)
    return Schedule(n_validators=n_validators, group_of=group_of,
                    corrupted=set(corrupted), **kwargs)


def split_brain_schedule(n_validators: int, corrupted: set) -> "Schedule":
    """Total 2-way partition: no message ever crosses groups. The network
    ``SplitVoter`` needs to force conflicting finality."""
    return balanced_split_schedule(n_validators, corrupted, isolate=True)


def committee_balanced_split_schedule(n_validators: int,
                                      corrupted: set) -> "Schedule":
    """Two view groups whose honest members split evenly within EVERY
    epoch-0 slot committee — the reference's idealized balancing setup
    (pos-evolution.md:1330 assumes per-slot symmetric halves). The
    adversary knows the epoch's committees in advance and targets
    delivery per validator, so this assignment is within its declared
    powers; committees reshuffle at the epoch boundary, which is exactly
    where the swayer banks start paying for the imbalance."""
    from pos_evolution_tpu_torch.sim.adversary import slot_committee
    from pos_evolution_tpu_torch.sim.schedule import Schedule
    from pos_evolution_tpu_torch.specs.genesis import make_genesis
    state, _ = make_genesis(n_validators)
    group_of = np.zeros(n_validators, dtype=np.int64)
    for slot in range(cfg().slots_per_epoch):
        committee = [int(v) for v in slot_committee(
            advance_state_to_slot(state, max(slot, 1)), slot)]
        honest = [v for v in committee if v not in corrupted]
        for k, v in enumerate(honest):
            group_of[v] = k % 2
    for k, v in enumerate(sorted(corrupted)):
        group_of[v] = k % 2
    return Schedule(n_validators=n_validators, group_of=group_of,
                    corrupted=set(corrupted))


def run_ex_ante_reorg(n_validators: int = 64) -> dict:
    """Sim-driven 1-block ex-ante reorg: the ``Withholder`` strategy hides
    B2 + one private vote at slot 2 and releases just before the slot-3
    attestation deadline (see ``scripted_run_ex_ante_reorg`` for the slot
    layout). The slot-2 proposer is corrupted (the scripted scenario has
    no honest slot-2 block), everything else is the honest duty loop."""
    from pos_evolution_tpu_torch.sim.adversary import Withholder, slot_committee
    from pos_evolution_tpu_torch.sim.driver import Simulation
    from pos_evolution_tpu_torch.specs.genesis import make_genesis
    from pos_evolution_tpu_torch.specs.helpers import get_beacon_proposer_index

    state, _ = make_genesis(n_validators)
    s2_view = advance_state_to_slot(state, 2)
    adversary = int(slot_committee(s2_view, 2)[0])
    proposer2 = int(get_beacon_proposer_index(s2_view))
    controlled = {adversary, proposer2}
    for s in (1, 3, 4):
        p = int(get_beacon_proposer_index(advance_state_to_slot(state, s)))
        assert p not in controlled, \
            f"scenario needs an honest slot-{s} proposer"

    strat = Withholder(controlled=controlled, fork_slot=2, release_slot=3,
                       release_phase="before_attest", vote_slots=(2,),
                       private_attesters={2: [adversary]})
    sim = Simulation(n_validators, adversaries=[strat])
    sim.run_until_slot(4)

    store = sim.store(0)
    head = fc.get_head(store)
    r2 = strat.chain.tip
    (r3,) = [r for r, b in store.blocks.items() if int(b.slot) == 3]
    return {
        "b2_root": r2,
        "b3_root": r3,
        "final_head": head,
        "b3_reorged": not _chain_contains(store, head, r3),
        "b2_canonical": _chain_contains(store, head, r2),
    }


def run_ex_ante_reorg_with_boost(n_validators: int = 800) -> dict:
    """Sim-driven 7%-adversary / 0.8W-boost ex-ante reorg: ``Withholder``
    banks 7 private votes in each of slots 2 and 3 and releases at slot 4
    ``before_propose`` with a timely proposal on the private tip — the
    boost-stealing step (see ``scripted_run_ex_ante_reorg_with_boost``
    for the arithmetic). Slot-2 and slot-4 proposers are corrupted (the
    scripted scenario has no honest block in either slot)."""
    from pos_evolution_tpu_torch.sim.adversary import Withholder, slot_committee
    from pos_evolution_tpu_torch.sim.driver import Simulation
    from pos_evolution_tpu_torch.specs.genesis import make_genesis
    from pos_evolution_tpu_torch.specs.helpers import get_beacon_proposer_index

    c = cfg()
    assert c.proposer_score_boost_percent == 80, "scenario expects 0.8W boost"
    state, _ = make_genesis(n_validators)
    adv2 = [int(v) for v in
            slot_committee(advance_state_to_slot(state, 2), 2)[:7]]
    adv3 = [int(v) for v in
            slot_committee(advance_state_to_slot(state, 3), 3)[:7]]
    proposer2 = int(get_beacon_proposer_index(advance_state_to_slot(state, 2)))
    proposer4 = int(get_beacon_proposer_index(advance_state_to_slot(state, 4)))
    controlled = set(adv2) | set(adv3) | {proposer2, proposer4}
    for s in (1, 3):
        p = int(get_beacon_proposer_index(advance_state_to_slot(state, s)))
        assert p not in controlled, \
            f"scenario needs an honest slot-{s} proposer"

    strat = Withholder(controlled=controlled, fork_slot=2, release_slot=4,
                       release_phase="before_propose", vote_slots=(2, 3),
                       private_attesters={2: adv2, 3: adv3},
                       propose_on_release=True)
    sim = Simulation(n_validators, adversaries=[strat])
    sim.run_until_slot(4)

    store = sim.store(0)
    head = fc.get_head(store)
    r2 = strat.chain.tip
    (r3,) = [r for r, b in store.blocks.items() if int(b.slot) == 3]
    (r4,) = [r for r, b in store.blocks.items() if int(b.slot) == 4]
    return {
        "per_slot_committee": n_validators // c.slots_per_epoch,
        "head": head,
        "b3_reorged": not _chain_contains(store, head, r3),
        "b4_canonical": _chain_contains(store, head, r4),
        "b2_canonical": _chain_contains(store, head, r2),
    }


class LMDBalancer:
    """Strategy form of the LMD balancing attack (pos-evolution.md:
    1379-1403): slots 1-4 build two private chains with 20 equivocating
    votes per chain per slot; slot 5 releases two equivocating blocks
    carrying each chain's 80 votes, each view receiving "its" chain
    timely (boost) and the other past the attesting interval — the LMD
    first-received rule then credits each view's table 80:0 for its own
    chain, permanently. Implements the ``AdversaryStrategy`` protocol
    structurally (duck-typed, the protocol's point) rather than by
    inheritance."""

    name = "lmd_balancer"

    def __init__(self, controlled, per_slot_byz: dict[int, list[int]],
                 build_slots=(1, 2, 3, 4), release_slot: int = 5):
        self.controlled = tuple(sorted(int(v) for v in controlled))
        self.per_slot_byz = {int(k): list(v) for k, v in per_slot_byz.items()}
        self.build_slots = tuple(build_slots)
        self.release_slot = int(release_slot)
        self.chain_states = None
        self.chain_blocks = {"L": [], "R": []}
        self.chain_votes = {"L": [], "R": []}
        self.first_roots: tuple | None = None
        self.release_tips: dict | None = None
        self.measured: dict | None = None
        self.tie_log: list[tuple[int, bool]] = []

    def bind(self, sim) -> None:
        self.sim = sim
        assert len(sim.groups) == 2, "LMDBalancer needs exactly two views"

    def describe(self) -> dict:
        return {"kind": type(self).__name__,
                "controlled": list(self.controlled),
                "build_slots": list(self.build_slots),
                "release_slot": self.release_slot}

    def _extend_both(self, ctx) -> None:
        for side, graffiti in (("L", b"\x1f" * 32), ("R", b"\xf1" * 32)):
            sb = build_block(self.chain_states[side], ctx.slot,
                             graffiti=graffiti)
            self.chain_blocks[side].append(sb)
            post = self.chain_states[side].copy()
            state_transition(post, sb, True)
            self.chain_states[side] = post
            head_root = hash_tree_root(sb.message)
            head_state = advance_state_to_slot(post, ctx.slot)
            # the slot's 20 Byzantine attesters vote this chain's head too
            # (equivocation across chains)
            self.chain_votes[side].extend(committee_attestations(
                head_state, ctx.slot, head_root,
                np.array(self.per_slot_byz[ctx.slot], dtype=np.int64)))
        if self.first_roots is None:
            self.first_roots = (
                hash_tree_root(self.chain_blocks["L"][0].message),
                hash_tree_root(self.chain_blocks["R"][0].message))

    def _release(self, ctx) -> None:
        c = cfg()
        # own side timely (boost applies), cross side one tick past the
        # attesting interval (no boost; equal-epoch LMD entries keep the
        # first-received chain, pos-evolution.md:1383, :1394)
        offset = float(_attest_interval(c) + 1)
        tips = {}
        for side, own in (("L", 0), ("R", 1)):
            assert len(self.chain_votes[side]) <= c.max_attestations, \
                "equivocating votes exceed the block's attestation capacity"
            sb5 = build_block(self.chain_states[side], ctx.slot,
                              attestations=self.chain_votes[side],
                              graffiti=(b"\x55" if side == "L" else b"\xaa") * 32)
            tips[side] = hash_tree_root(sb5.message)
            delay = {own: 0.0, 1 - own: offset}
            for sb in self.chain_blocks[side] + [sb5]:
                ctx.broadcast("block", sb,
                              src=int(sb.message.proposer_index), delay=delay)
        self.release_tips = tips
        ctx.deliver()

    def before_propose(self, ctx) -> None:
        if self.chain_states is None:
            base = ctx.store(0).block_states[ctx.head(0)]
            self.chain_states = {"L": base, "R": base}
        if self.first_roots is not None and ctx.slot > self.release_slot + 1:
            # head-tie audit for the PREVIOUS slot, read after the slot
            # boundary tick cleared its proposer boost (the scripted
            # oracle has no boost live at its per-slot head checks)
            self.tie_log.append((ctx.slot - 1, ctx.head(0) != ctx.head(1)))
        if ctx.slot in self.build_slots:
            self._extend_both(ctx)
        elif ctx.slot == self.release_slot:
            self._release(ctx)

    def before_attest(self, ctx) -> None:
        pass

    def after_attest(self, ctx) -> None:
        if ctx.slot == self.release_slot and self.measured is None:
            firstL, firstR = self.first_roots
            gwei32 = 32 * 10**9
            self.measured = {
                "viewA_L_votes": int(fc.get_latest_attesting_balance(
                    ctx.store(0), firstL)) // gwei32,
                "viewA_R_votes": int(fc.get_latest_attesting_balance(
                    ctx.store(0), firstR)) // gwei32,
                "viewB_L_votes": int(fc.get_latest_attesting_balance(
                    ctx.store(1), firstL)) // gwei32,
                "viewB_R_votes": int(fc.get_latest_attesting_balance(
                    ctx.store(1), firstR)) // gwei32,
            }


def run_lmd_balancing_attack(n_validators: int = 800,
                             end_slot: int = 10) -> dict:
    """Sim-driven LMD balancing despite boost, reference numbers (W=100
    per slot, 20 Byzantine per slot, five corrupted proposers). The
    adversary additionally censors the proposers of the post-release
    window (adaptive corruption, pos-evolution.md:183-185): the scripted
    oracle models no blocks after the release, and an honest proposal's
    boost would otherwise perturb the vote ledger the oracle pins."""
    from pos_evolution_tpu_torch.sim.adversary import slot_committee
    from pos_evolution_tpu_torch.sim.driver import Simulation
    from pos_evolution_tpu_torch.specs.genesis import make_genesis
    from pos_evolution_tpu_torch.specs.helpers import get_beacon_proposer_index

    state, _ = make_genesis(n_validators)
    per_slot_byz: dict[int, list[int]] = {}
    corrupted: set[int] = set()
    for slot in range(1, 6):
        flat = [int(v) for v in
                slot_committee(advance_state_to_slot(state, slot), slot)]
        per_slot_byz[slot] = flat[:20]
        corrupted.update(per_slot_byz[slot])
    for slot in range(1, end_slot + 1):
        corrupted.add(int(get_beacon_proposer_index(
            advance_state_to_slot(state, slot))))

    sched = balanced_split_schedule(n_validators, corrupted)
    strat = LMDBalancer(corrupted, per_slot_byz)
    sim = Simulation(n_validators, schedule=sched, adversaries=[strat])
    sim.run_until_slot(end_slot + 1)

    ties = dict(strat.tie_log)
    return {
        **strat.measured,
        "heads_disagree": [ties[s] for s in range(6, end_slot + 1)],
        "justified_A": sim.justified_epoch(0),
        "justified_B": sim.justified_epoch(1),
    }
