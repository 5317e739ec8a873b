"""Fork choice (L4): the HLMD-GHOST store and handlers.

Implements the fork-choice spoiler of the reference
(pos-evolution.md:884-1126): ``Store`` (:889-901), ``get_forkchoice_store``
(:1077-1095), ``on_tick`` (:934-955, bouncing-attack promotion),
``on_attestation`` (:963-979 and the ``is_from_block`` variant :1423-1428),
``on_block`` (:986-1036, proposer boost :1020-1024),
``should_update_justified_checkpoint`` (:1046-1062), ``get_head``
(:1102-1116), ``update_latest_messages`` with equivocation discounting
(:1435-1441), and ``on_attester_slashing`` (:1447-1461).

Handler atomicity (pos-evolution.md:1041: invalid handler calls must not
modify the store) is guaranteed structurally: every handler performs all
validation before its first store mutation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pos_evolution_tpu_torch.config import GENESIS_EPOCH, cfg
from pos_evolution_tpu_torch.specs.containers import (
    Attestation,
    AttesterSlashing,
    BeaconBlock,
    BeaconState,
    Checkpoint,
    LatestMessage,
    SignedBeaconBlock,
)
from pos_evolution_tpu_torch.specs.helpers import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_current_epoch,
    get_indexed_attestation,
    get_total_active_balance,
    is_slashable_attestation_data,
    is_valid_indexed_attestation,
)
from pos_evolution_tpu_torch.specs.transition import process_slots, state_transition
from pos_evolution_tpu_torch.ssz import hash_tree_root


@dataclass
class Store:
    """A validator's view G (pos-evolution.md:889-901)."""

    time: int
    genesis_time: int
    justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    best_justified_checkpoint: Checkpoint
    proposer_boost_root: bytes = b"\x00" * 32
    equivocating_indices: set = field(default_factory=set)
    blocks: dict = field(default_factory=dict)            # Root -> BeaconBlock
    block_states: dict = field(default_factory=dict)      # Root -> BeaconState
    checkpoint_states: dict = field(default_factory=dict)  # (epoch, root) -> BeaconState
    latest_messages: dict = field(default_factory=dict)   # ValidatorIndex -> LatestMessage
    # PoW-chain view for merge-transition validation; None falls back to the
    # module-level default registry in specs.merge (Simulation installs a
    # fresh per-instance view so sims never share PoW state).
    pow_chain: object = None
    # Data-availability view (das/engine.BlobStore): when attached, on_block
    # refuses blocks whose committed blob sidecars this view has not
    # verified — the DAS analogue of the merge payload gate. Like pow_chain
    # it is a live per-view object, never serialized (the driver reattaches
    # it on resume).
    blob_store: object = None
    # Protocol-variant overlay (variants/base.VariantVoteLog): when a
    # successor variant (Goldfish/RLMD-GHOST/SSF, DESIGN.md §16) drives the
    # simulation, the handlers notify it of every applied vote POST-commit
    # so the variant's slot-granular tables stay exactly in sync with this
    # view — gossip, block-carried and backfilled attestations alike. None
    # (the Gasper default) keeps the handlers byte-identical to the spec.
    variant_view: object = None


def get_forkchoice_store(anchor_state: BeaconState, anchor_block: BeaconBlock,
                         pow_chain: object = None) -> Store:
    """Init from a trusted anchor (pos-evolution.md:1077-1095); the anchor is
    genesis or a weak-subjectivity checkpoint (:1221)."""
    assert bytes(anchor_block.state_root) == hash_tree_root(anchor_state), \
        "anchor block/state mismatch"
    anchor_root = hash_tree_root(anchor_block)
    anchor_epoch = get_current_epoch(anchor_state)
    justified = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    finalized = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    return Store(
        time=int(anchor_state.genesis_time) + cfg().seconds_per_slot * int(anchor_state.slot),
        genesis_time=int(anchor_state.genesis_time),
        justified_checkpoint=justified,
        finalized_checkpoint=finalized,
        best_justified_checkpoint=justified,
        blocks={anchor_root: anchor_block.copy()},
        block_states={anchor_root: anchor_state.copy()},
        checkpoint_states={justified.as_key(): anchor_state.copy()},
        pow_chain=pow_chain,
    )


# --- time helpers -------------------------------------------------------------

def get_slots_since_genesis(store: Store) -> int:
    return (store.time - store.genesis_time) // cfg().seconds_per_slot


def get_current_slot(store: Store) -> int:
    return get_slots_since_genesis(store)


def compute_slots_since_epoch_start(slot: int) -> int:
    return slot - compute_start_slot_at_epoch(compute_epoch_at_slot(slot))


# --- tree walks ---------------------------------------------------------------

def get_ancestor(store: Store, root: bytes, slot: int) -> bytes:
    """Walk parents until ``slot`` (pos-evolution.md:953, 1005, 1058).

    A store initialized from a weak-subjectivity checkpoint (:1216) is
    anchored mid-chain: history below the anchor does not exist in this
    view. Asking for an ancestor older than the anchor answers with the
    anchor itself — the deepest known ancestor — rather than crashing on
    the missing parent (every known block descends from the anchor, so
    checkpoint-descent checks against it remain correct). Genesis-anchored
    stores never take this branch: the walk stops at slot 0 first."""
    root = bytes(root)
    block = store.blocks[root]
    while int(block.slot) > slot:
        parent = bytes(block.parent_root)
        if parent not in store.blocks:
            return root
        root = parent
        block = store.blocks[root]
    return root


def get_checkpoint_block(store: Store, root: bytes, epoch: int) -> bytes:
    return get_ancestor(store, root, compute_start_slot_at_epoch(epoch))


# --- weights ------------------------------------------------------------------

def justified_checkpoint_state(store: Store) -> BeaconState:
    """The justified checkpoint's state, materialized on demand.

    The cache is normally filled by ``on_attestation`` (whose targets led
    justification there), but a checkpoint-synced store can have its
    justified checkpoint advanced by BACKFILLED blocks before any
    attestation targeting it arrives — compute and commit the state then,
    exactly as ``compute_target_checkpoint_state`` would have."""
    key = store.justified_checkpoint.as_key()
    state = store.checkpoint_states.get(key)
    if state is None:
        state = compute_target_checkpoint_state(store,
                                                store.justified_checkpoint)
        store.checkpoint_states[key] = state
    return state


def get_proposer_boost(store: Store) -> int:
    """Boost fraction of one slot's committee weight W (pos-evolution.md:1355:
    W/4 mainline; the attack analyses use 0.7W/0.8W)."""
    justified_state = justified_checkpoint_state(store)
    committee_weight = get_total_active_balance(justified_state) // cfg().slots_per_epoch
    return committee_weight * cfg().proposer_score_boost_percent // 100


def get_latest_attesting_balance(store: Store, root: bytes) -> int:
    """Σ effective balance whose latest message is in ``root``'s subtree,
    skipping equivocators, plus proposer boost (pos-evolution.md:322, 916,
    1116, 1438)."""
    root = bytes(root)
    state = justified_checkpoint_state(store)
    block_slot = int(store.blocks[root].slot)
    reg = state.validators
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    attestation_score = 0
    for i, message in store.latest_messages.items():
        if i in store.equivocating_indices:
            continue
        if i >= len(reg):
            continue
        active = reg.activation_epoch[i] <= current_epoch < reg.exit_epoch[i]
        if not active or reg.slashed[i]:
            continue
        if message.root not in store.blocks:
            continue
        if get_ancestor(store, message.root, block_slot) == root:
            attestation_score += int(reg.effective_balance[i])

    boost_score = 0
    if store.proposer_boost_root != b"\x00" * 32:
        if get_ancestor(store, store.proposer_boost_root, block_slot) == root:
            boost_score = get_proposer_boost(store)
    return attestation_score + boost_score


# --- viable-branch filtering (pos-evolution.md:874-880, 1104-1106) ------------

def _leaf_is_viable(store: Store, root: bytes) -> bool:
    """A leaf is viable when its chain's justified view has caught up to the
    store's (pos-evolution.md:874-880): its voting source matches the
    store's justified epoch (with a 2-epoch catch-up grace so anchors
    resumed mid-chain stay viable), and it descends from the store's
    finalized checkpoint."""
    head_state = store.block_states[root]
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    voting_source = head_state.current_justified_checkpoint
    correct_justified = (
        int(store.justified_checkpoint.epoch) == GENESIS_EPOCH
        or int(voting_source.epoch) == int(store.justified_checkpoint.epoch)
        or int(voting_source.epoch) + 2 >= current_epoch)
    finalized_slot = compute_start_slot_at_epoch(int(store.finalized_checkpoint.epoch))
    correct_finalized = (
        int(store.finalized_checkpoint.epoch) == GENESIS_EPOCH
        or (int(store.blocks[root].slot) > finalized_slot
            and get_ancestor(store, root, finalized_slot)
            == bytes(store.finalized_checkpoint.root)))
    return correct_justified and correct_finalized


def get_filtered_block_tree(store: Store) -> dict:
    """Subtree rooted at the justified checkpoint, pruned to branches whose
    leaves carry the store's justified/finalized view.

    Iterative post-order traversal: long-running simulations grow chains
    past Python's recursion limit (~1000 frames), so no recursion here.
    """
    base = bytes(store.justified_checkpoint.root)
    children: dict[bytes, list[bytes]] = {}
    for root, block in store.blocks.items():
        children.setdefault(bytes(block.parent_root), []).append(root)

    from pos_evolution_tpu_torch.utils.traversal import postorder

    blocks: dict[bytes, BeaconBlock] = {}
    keep: dict[bytes, bool] = {}
    for root in postorder(children, base):
        kids = children.get(root, [])
        if kids:
            keep[root] = any(keep[k] for k in kids)
        else:
            keep[root] = _leaf_is_viable(store, root)
        if keep[root]:
            blocks[root] = store.blocks[root]
    return blocks


def get_head(store: Store) -> bytes:
    """HLMD-GHOST greedy descent (pos-evolution.md:1102-1116)."""
    blocks = get_filtered_block_tree(store)
    head = bytes(store.justified_checkpoint.root)
    children_of: dict[bytes, list[bytes]] = {}
    for root, block in blocks.items():
        children_of.setdefault(bytes(block.parent_root), []).append(root)
    while True:
        children = children_of.get(head, [])
        if not children:
            return head
        # max by (weight, root): lexicographic tie-break on the root
        head = max(children,
                   key=lambda r: (get_latest_attesting_balance(store, r), r))


# --- handlers -----------------------------------------------------------------

def on_tick(store: Store, time: int) -> None:
    """pos-evolution.md:934-955."""
    previous_slot = get_current_slot(store)
    store.time = int(time)
    current_slot = get_current_slot(store)

    if current_slot > previous_slot:
        store.proposer_boost_root = b"\x00" * 32

    if not (current_slot > previous_slot
            and compute_slots_since_epoch_start(current_slot) == 0):
        return

    # Epoch boundary: promote best_justified (bouncing-attack defense :1043).
    if int(store.best_justified_checkpoint.epoch) > int(store.justified_checkpoint.epoch):
        finalized_slot = compute_start_slot_at_epoch(int(store.finalized_checkpoint.epoch))
        ancestor = get_ancestor(store, store.best_justified_checkpoint.root, finalized_slot)
        if ancestor == bytes(store.finalized_checkpoint.root):
            store.justified_checkpoint = store.best_justified_checkpoint


def validate_on_attestation(store: Store, attestation: Attestation,
                            is_from_block: bool) -> None:
    """pos-evolution.md:970 contract."""
    target = attestation.data.target
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    previous_epoch = current_epoch - 1 if current_epoch > GENESIS_EPOCH else GENESIS_EPOCH
    assert int(target.epoch) in (current_epoch, previous_epoch), "target epoch not recent"
    assert int(target.epoch) == compute_epoch_at_slot(int(attestation.data.slot))
    assert bytes(target.root) in store.blocks, "unknown target block"
    beacon_block_root = bytes(attestation.data.beacon_block_root)
    assert beacon_block_root in store.blocks, "unknown head block"
    assert int(store.blocks[beacon_block_root].slot) <= int(attestation.data.slot), \
        "attestation head from the future"
    target_slot = compute_start_slot_at_epoch(int(target.epoch))
    assert bytes(target.root) == get_ancestor(store, beacon_block_root, target_slot), \
        "LMD vote inconsistent with FFG target"
    if not is_from_block:
        assert get_current_slot(store) >= int(attestation.data.slot) + 1, \
            "attestation from current slot"


def compute_target_checkpoint_state(store: Store, target: Checkpoint) -> BeaconState:
    base_state = store.block_states[bytes(target.root)].copy()
    target_slot = compute_start_slot_at_epoch(int(target.epoch))
    if int(base_state.slot) < target_slot:
        process_slots(base_state, target_slot)
    return base_state


def update_latest_messages(store: Store, attesting_indices, attestation: Attestation) -> None:
    """LMD table update skipping equivocators (pos-evolution.md:1435-1441)."""
    target = attestation.data.target
    beacon_block_root = bytes(attestation.data.beacon_block_root)
    for i in attesting_indices:
        i = int(i)
        if i in store.equivocating_indices:
            continue
        prev = store.latest_messages.get(i)
        if prev is None or int(target.epoch) > prev.epoch:
            store.latest_messages[i] = LatestMessage(epoch=int(target.epoch),
                                                     root=beacon_block_root)


def on_attestation(store: Store, attestation: Attestation,
                   is_from_block: bool = False):
    """pos-evolution.md:963-979 / :1423-1428.

    Returns the attesting indices (the pyspec handler returns None; the
    value is surplus for spec fidelity but lets accelerated mirrors
    forward the vote batch without re-deriving the committee)."""
    validate_on_attestation(store, attestation, is_from_block)
    target_key = attestation.data.target.as_key()
    if target_key in store.checkpoint_states:
        target_state = store.checkpoint_states[target_key]
        commit_checkpoint_state = None
    else:
        target_state = compute_target_checkpoint_state(store, attestation.data.target)
        commit_checkpoint_state = target_state

    indexed_attestation = get_indexed_attestation(target_state, attestation)
    assert is_valid_indexed_attestation(target_state, indexed_attestation), \
        "invalid indexed attestation"

    # Validation done — commit mutations (atomicity contract :1041).
    if commit_checkpoint_state is not None:
        store.checkpoint_states[target_key] = commit_checkpoint_state
    update_latest_messages(store, indexed_attestation.attesting_indices, attestation)
    if store.variant_view is not None:
        # variant overlay (DESIGN.md §16): slot-granular vote record for
        # the expiry-windowed successor protocols — post-commit, so a
        # rejected attestation never reaches the overlay
        store.variant_view.note_vote(
            indexed_attestation.attesting_indices,
            int(attestation.data.slot),
            bytes(attestation.data.beacon_block_root))
    return indexed_attestation.attesting_indices


def should_update_justified_checkpoint(store: Store,
                                       new_justified_checkpoint: Checkpoint) -> bool:
    """Bouncing-attack mitigation (pos-evolution.md:1046-1062)."""
    if compute_slots_since_epoch_start(get_current_slot(store)) \
            < cfg().safe_slots_to_update_justified:
        return True
    justified_slot = compute_start_slot_at_epoch(int(store.justified_checkpoint.epoch))
    if get_ancestor(store, new_justified_checkpoint.root, justified_slot) \
            != bytes(store.justified_checkpoint.root):
        return False
    return True


def on_block(store: Store, signed_block: SignedBeaconBlock) -> None:
    """pos-evolution.md:986-1036."""
    c = cfg()
    block = signed_block.message
    parent_root = bytes(block.parent_root)
    assert parent_root in store.block_states, "unknown parent"
    pre_state = store.block_states[parent_root]
    assert get_current_slot(store) >= int(block.slot), "block from the future"

    finalized_slot = compute_start_slot_at_epoch(int(store.finalized_checkpoint.epoch))
    assert int(block.slot) > finalized_slot, "block at or before finalized slot"
    assert get_ancestor(store, parent_root, finalized_slot) \
        == bytes(store.finalized_checkpoint.root), "not a descendant of finalized"

    # [DAS] availability gate (das/, DESIGN.md §15): a block whose graffiti
    # commits to blob sidecars imports only once this view holds and has
    # verified all of them — same shape as the merge payload gate below,
    # and before the (expensive) state transition like the spec's
    # is_data_available check.
    if store.blob_store is not None:
        assert store.blob_store.is_available(hash_tree_root(block), block), \
            "blob data not available"

    # Full state transition on a copy (pos-evolution.md:1009).
    state = pre_state.copy()
    state_transition(state, signed_block, True)

    # [New in Bellatrix] merge-transition validation (pos-evolution.md:1011-1013).
    from pos_evolution_tpu_torch.specs.merge import (
        is_merge_transition_block, validate_merge_block)
    if is_merge_transition_block(pre_state, block.body):
        validate_merge_block(block, pow_view=store.pow_chain)

    block_root = hash_tree_root(block)
    store.blocks[block_root] = block
    store.block_states[block_root] = state

    # Proposer boost if timely: first 1/3 of the slot (pos-evolution.md:1020-1024).
    time_into_slot = (store.time - store.genesis_time) % c.seconds_per_slot
    is_before_attesting_interval = time_into_slot < c.seconds_per_slot // c.intervals_per_slot
    if get_current_slot(store) == int(block.slot) and is_before_attesting_interval:
        store.proposer_boost_root = block_root

    # Justified / finalized checkpoint updates (pos-evolution.md:1026-1036).
    if int(state.current_justified_checkpoint.epoch) > int(store.justified_checkpoint.epoch):
        if int(state.current_justified_checkpoint.epoch) \
                > int(store.best_justified_checkpoint.epoch):
            store.best_justified_checkpoint = state.current_justified_checkpoint
        if should_update_justified_checkpoint(store, state.current_justified_checkpoint):
            store.justified_checkpoint = state.current_justified_checkpoint

    if int(state.finalized_checkpoint.epoch) > int(store.finalized_checkpoint.epoch):
        store.finalized_checkpoint = state.finalized_checkpoint
        store.justified_checkpoint = state.current_justified_checkpoint


def on_block_batch(store: Store, signed_blocks: list) -> None:
    """A parent-linked run of blocks applied as one batch — the req/resp
    backfill / checkpoint-sync path of real clients, with per-block
    semantics exactly those of ``on_block`` (pos-evolution.md:986-1036):
    same asserts, same per-block commit points, and a mid-run failure
    leaves the already-committed prefix in place precisely like the
    sequential loop would. What the batch amortizes:

    - the finalized-descent ``get_ancestor`` walk runs once, for the run's
      first parent. Each later block's parent is the in-run block just
      committed, which descends from the finalized checkpoint by
      induction — including when finalization advances *mid-run*: the new
      finalized root then lies on this very chain, and every remaining
      block descends through it. (The per-block ``slot > finalized_slot``
      assert is still evaluated against the live store.) This turns the
      O(K · chain-depth) backfill walk into O(depth + K).
    - the pre-state is copied once and carried through the run via the
      ``ExecutionBackend``'s ``multi_block_apply``, so the fused block
      sweep's device-resident columns stay hot across consecutive blocks
      instead of re-uploading per block, and only the *stored* snapshots
      are copied.
    """
    c = cfg()
    if not signed_blocks:
        return
    parent_root = bytes(signed_blocks[0].message.parent_root)
    assert parent_root in store.block_states, "unknown parent"
    finalized_slot = compute_start_slot_at_epoch(int(store.finalized_checkpoint.epoch))
    assert get_ancestor(store, parent_root, finalized_slot) \
        == bytes(store.finalized_checkpoint.root), "not a descendant of finalized"

    # Linkage + from-the-future checks for the whole run before any mutation
    # (the sequential loop would also reject these before touching the store).
    prev_root = parent_root
    for sb in signed_blocks:
        block = sb.message
        assert bytes(block.parent_root) == prev_root, "batch not parent-linked"
        assert get_current_slot(store) >= int(block.slot), "block from the future"
        prev_root = hash_tree_root(block)

    from pos_evolution_tpu_torch.backend import get_backend
    from pos_evolution_tpu_torch.specs.merge import (
        is_merge_transition_block, validate_merge_block)

    state = store.block_states[parent_root].copy()
    last_root = prev_root
    merge_flag = [False]

    def pre_block(sb, pre_state):
        block = sb.message
        fslot = compute_start_slot_at_epoch(int(store.finalized_checkpoint.epoch))
        assert int(block.slot) > fslot, "block at or before finalized slot"
        if store.blob_store is not None:
            # same per-block availability gate as on_block; a mid-run
            # unavailable block keeps the committed prefix (prefix-commit
            # contract) exactly like any other per-block reject
            assert store.blob_store.is_available(hash_tree_root(block),
                                                 block), \
                "blob data not available"
        merge_flag[0] = is_merge_transition_block(pre_state, block.body)

    def commit(sb, post_state):
        block = sb.message
        if merge_flag[0]:
            validate_merge_block(block, pow_view=store.pow_chain)
        block_root = hash_tree_root(block)
        store.blocks[block_root] = block
        # the working state keeps advancing; store a snapshot (the run's
        # last block stores the working state itself)
        store.block_states[block_root] = (
            post_state if block_root == last_root else post_state.copy())

        time_into_slot = (store.time - store.genesis_time) % c.seconds_per_slot
        is_before_attesting_interval = \
            time_into_slot < c.seconds_per_slot // c.intervals_per_slot
        if get_current_slot(store) == int(block.slot) and is_before_attesting_interval:
            store.proposer_boost_root = block_root

        if int(post_state.current_justified_checkpoint.epoch) \
                > int(store.justified_checkpoint.epoch):
            if int(post_state.current_justified_checkpoint.epoch) \
                    > int(store.best_justified_checkpoint.epoch):
                store.best_justified_checkpoint = post_state.current_justified_checkpoint
            if should_update_justified_checkpoint(
                    store, post_state.current_justified_checkpoint):
                store.justified_checkpoint = post_state.current_justified_checkpoint
        if int(post_state.finalized_checkpoint.epoch) \
                > int(store.finalized_checkpoint.epoch):
            store.finalized_checkpoint = post_state.finalized_checkpoint
            store.justified_checkpoint = post_state.current_justified_checkpoint

    get_backend().multi_block_apply(state, signed_blocks, validate_result=True,
                                    pre_block=pre_block, on_applied=commit)


# Prefix-commit contract marker: a mid-run reject leaves the committed
# prefix in the store by design (exactly like the sequential loop). The
# debug StoreInvariantChecker honors this instead of flagging a torn write.
on_block_batch.commits_prefix = True


def prune_store(store: Store) -> int:
    """Drop blocks/states that cannot affect fork choice anymore: everything
    not descending from (or equal to) the finalized checkpoint block.

    The reference guarantees the fork-choice never walks behind the
    finalized checkpoint (pos-evolution.md:407: "the fork-choice rule does
    not need to go back more than this checkpoint"), so pruned entries are
    unreachable. Returns the number of blocks removed.
    """
    finalized_root = bytes(store.finalized_checkpoint.root)
    if finalized_root not in store.blocks:
        return 0
    finalized_slot = int(store.blocks[finalized_root].slot)
    keep = set()
    for root in store.blocks:
        try:
            if get_ancestor(store, root, finalized_slot) == finalized_root:
                keep.add(root)
        except KeyError:
            continue
    keep.add(finalized_root)
    dropped = [r for r in store.blocks if r not in keep]
    for r in dropped:
        del store.blocks[r]
        store.block_states.pop(r, None)
    for key in [k for k in store.checkpoint_states
                if k[0] < int(store.finalized_checkpoint.epoch)]:
        del store.checkpoint_states[key]
    return len(dropped)


def on_attester_slashing(store: Store, attester_slashing: AttesterSlashing):
    """Equivocation evidence feeds the discounting set (pos-evolution.md:1447-1461).

    Returns the newly discounted indices (surplus over the pyspec's None
    return, so accelerated mirrors see exactly the set the handler used)."""
    a1, a2 = attester_slashing.attestation_1, attester_slashing.attestation_2
    assert is_slashable_attestation_data(a1.data, a2.data), "not slashable"
    state = store.block_states[bytes(store.justified_checkpoint.root)]
    assert is_valid_indexed_attestation(state, a1)
    assert is_valid_indexed_attestation(state, a2)
    indices = set(int(i) for i in np.asarray(a1.attesting_indices)) \
        & set(int(i) for i in np.asarray(a2.attesting_indices))
    for index in indices:
        store.equivocating_indices.add(index)
    if store.variant_view is not None:
        # variant overlays discount slasher-evidenced equivocators too
        # (pos-evolution.md:1438)
        store.variant_view.note_equivocators(indices)
    return indices
