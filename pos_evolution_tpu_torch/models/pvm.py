"""Propose-vote-merge protocol template (L7; pos-evolution.md:1602-1608).

The reference observes that LMD-GHOST, Goldfish and RLMD-GHOST share one
structure: slots of k rounds with a Propose phase (proposer merges its
buffer, runs the fork-choice rule FC, extends the head, broadcasts block +
its view), a Vote phase (validators merge the proposed view — the
*view-merge* technique of pos-evolution.md:1528-1541 — then vote for
FC(view, slot)), and a Merge phase (validators merge their buffers).

This module builds that template once; the concrete protocols plug in a
fork-choice rule and a vote-expiry period:

- ``vote_expiry = None``  -> (secured) LMD-GHOST (pos-evolution.md:1585)
- ``vote_expiry = eta``   -> RLMD-GHOST (pos-evolution.md:1581-1600)
- ``vote_expiry = 1``     -> Goldfish / GHOST-Eph (pos-evolution.md:1543-1579)

Views and buffers are per-validator message sets (pos-evolution.md:201-203,
1596); equivocation discounting (pos-evolution.md:1409-1413) is applied
inside the weight computation; VRF leader election with subsampling
(pos-evolution.md:1554) replaces round-robin when enabled.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

import numpy as np

GENESIS_ROOT = b"genesis" + b"\x00" * 25


@dataclass(frozen=True)
class PVMBlock:
    """A block in the propose-vote-merge block-tree."""

    slot: int
    parent: bytes
    proposer: int
    salt: int = 0  # distinguishes equivocating blocks

    @property
    def root(self) -> bytes:
        h = hashlib.sha256(
            b"pvm-block" + self.slot.to_bytes(8, "little")
            + self.parent + self.proposer.to_bytes(8, "little", signed=True)
            + self.salt.to_bytes(8, "little"))
        return h.digest()


@dataclass(frozen=True)
class HeadVote:
    """[HEAD-VOTE, B, t, v] (pos-evolution.md:1624)."""

    slot: int
    block_root: bytes
    validator: int


class View:
    """A validator's view G: accepted blocks + votes (pos-evolution.md:201).

    Tracks equivocation evidence: a proposer with two blocks in one slot,
    or a validator with two head-votes in one slot, is discounted forever
    (fork-choice discounting, pos-evolution.md:1411).
    """

    def __init__(self):
        self.blocks: dict[bytes, PVMBlock] = {
            GENESIS_ROOT: PVMBlock(slot=0, parent=GENESIS_ROOT, proposer=-1)}
        # (validator, slot) -> block_root of their vote; conflicts mark
        # the voter as an equivocator.
        self.votes: dict[tuple[int, int], bytes] = {}
        self.equivocators: set[int] = set()
        self._proposals: dict[tuple[int, int], bytes] = {}

    def add_block(self, block: PVMBlock) -> None:
        if block.parent not in self.blocks:
            return  # dependency rule: accept only with ancestors present
        if block.root in self.blocks:
            return
        key = (block.proposer, block.slot)
        prev = self._proposals.get(key)
        if prev is not None and prev != block.root:
            self.equivocators.add(block.proposer)
        self._proposals.setdefault(key, block.root)
        self.blocks[block.root] = block

    def add_vote(self, vote: HeadVote) -> None:
        key = (vote.validator, vote.slot)
        prev = self.votes.get(key)
        if prev is not None and prev != vote.block_root:
            self.equivocators.add(vote.validator)
            return
        self.votes[key] = vote.block_root

    def merge(self, other: "View") -> None:
        # parents always have strictly lower slots, so one slot-ordered pass
        # inserts parent-first (no quadratic fixpoint iteration); the
        # genesis marker is skipped (re-adding it would duplicate it under
        # its computed hash root)
        for root, b in sorted(other.blocks.items(), key=lambda kv: kv[1].slot):
            if root != GENESIS_ROOT:
                self.add_block(b)
        for (v, s), root in other.votes.items():
            self.add_vote(HeadVote(slot=s, block_root=root, validator=v))
        self.equivocators |= other.equivocators

    def copy(self) -> "View":
        out = View()
        out.blocks = dict(self.blocks)
        out.votes = dict(self.votes)
        out.equivocators = set(self.equivocators)
        out._proposals = dict(self._proposals)
        return out

    # -- fork-choice support ---------------------------------------------
    def children(self) -> dict[bytes, list[bytes]]:
        ch: dict[bytes, list[bytes]] = {}
        for root, b in self.blocks.items():
            if root == GENESIS_ROOT:
                continue
            ch.setdefault(b.parent, []).append(root)
        return ch

    def is_ancestor(self, ancestor: bytes, descendant: bytes) -> bool:
        cur = descendant
        while True:
            if cur == ancestor:
                return True
            blk = self.blocks.get(cur)
            if blk is None or cur == GENESIS_ROOT:
                return False
            cur = blk.parent

    def latest_votes(self, slot: int, expiry: int | None) -> dict[int, bytes]:
        """Latest non-equivocating vote per validator within the expiry
        window [slot - eta, slot - 1] (pos-evolution.md:1585, 1596)."""
        lo = 0 if expiry is None else max(slot - expiry, 0)
        latest: dict[int, tuple[int, bytes]] = {}
        for (v, s), root in self.votes.items():
            if v in self.equivocators or not (lo <= s < slot):
                continue
            if root not in self.blocks:
                continue
            cur = latest.get(v)
            if cur is None or s > cur[0]:
                latest[v] = (s, root)
        return {v: root for v, (s, root) in latest.items()}


def ghost_head(view: View, slot: int, expiry: int | None,
               weights: np.ndarray | None = None) -> bytes:
    """(R)LMD-GHOST / GHOST-Eph head: greedy heaviest-subtree descent using
    the (expiry-windowed, equivocation-discounted) latest votes
    (pos-evolution.md:1549, 1585, 1596)."""
    votes = view.latest_votes(slot, expiry)
    weight_of: dict[bytes, float] = {}
    for v, root in votes.items():
        w = 1.0 if weights is None else float(weights[v])
        cur = root
        while True:
            weight_of[cur] = weight_of.get(cur, 0.0) + w
            if cur == GENESIS_ROOT:
                break
            cur = view.blocks[cur].parent
    children = view.children()
    head = GENESIS_ROOT
    while True:
        kids = children.get(head, [])
        if not kids:
            return head
        head = max(kids, key=lambda r: (weight_of.get(r, 0.0), r))


def vanilla_ghost_head(view: View) -> bytes:
    """Pre-LMD GHOST: subtree weight = number of blocks, equivocations NOT
    discounted — the rule the avalanche attack defeats
    (pos-evolution.md:1469-1473). Iterative (no recursion-depth limit)."""
    from pos_evolution_tpu_torch.utils.traversal import postorder

    children = view.children()
    # all subtree sizes in one post-order pass
    size: dict[bytes, int] = {}
    for root in postorder(children, GENESIS_ROOT):
        size[root] = 1 + sum(size[c] for c in children.get(root, ()))

    head = GENESIS_ROOT
    while True:
        kids = children.get(head, [])
        if not kids:
            return head
        head = max(kids, key=lambda r: (size[r], r))


def vrf_output(validator: int, slot: int) -> bytes:
    """Deterministic stand-in VRF evaluation (pos-evolution.md:1554)."""
    return hashlib.sha256(b"pvm-vrf" + validator.to_bytes(8, "little")
                          + slot.to_bytes(8, "little")).digest()


def vrf_is_eligible(validator: int, slot: int, tag: bytes,
                    subsample_rate: float) -> bool:
    """Subsampling predicate: pseudo-random committee self-selection
    (pos-evolution.md:1545)."""
    h = hashlib.sha256(b"pvm-sub" + tag + validator.to_bytes(8, "little")
                       + slot.to_bytes(8, "little")).digest()
    return int.from_bytes(h[:8], "little") < subsample_rate * 2**64


@dataclass
class PVMValidator:
    """A validator in a propose-vote-merge protocol: view + buffer
    (pos-evolution.md:1596)."""

    index: int
    view: View = field(default_factory=View)
    buffer: list = field(default_factory=list)
    # Goldfish sleep states: awake / asleep / dreamy (pos-evolution.md:1547)
    status: str = "awake"
    confirmed_prefix: bytes = GENESIS_ROOT

    def buffer_message(self, msg) -> None:
        self.buffer.append(msg)

    def merge_buffer(self) -> None:
        for msg in self.buffer:
            if isinstance(msg, PVMBlock):
                self.view.add_block(msg)
            elif isinstance(msg, HeadVote):
                self.view.add_vote(msg)
            elif isinstance(msg, View):
                self.view.merge(msg)
        self.buffer = []
