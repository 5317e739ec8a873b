"""Merge-transition validation (Bellatrix fork-choice additions).

The reference's ``on_block`` consults two helpers when a block crosses the
PoW→PoS boundary (pos-evolution.md:1011-1013)::

    # [New in Bellatrix]
    if is_merge_transition_block(pre_state, block.body):
        validate_merge_block(block)

The document references but does not inline them; this module supplies the
standard Bellatrix semantics. ``validate_merge_block`` needs a view of the
PoW chain to check the terminal block's total difficulty; a real client asks
its execution engine, so the simulator exposes the same seam as a pluggable
provider (default: an in-process registry the tests/scenarios populate).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.specs.containers import (
    BeaconBlock,
    BeaconState,
    ExecutionPayload,
    ExecutionPayloadHeader,
)
from pos_evolution_tpu_torch.specs.helpers import compute_epoch_at_slot

__all__ = [
    "PowBlock",
    "PowChainView",
    "DEFAULT_POW_CHAIN",
    "get_pow_block",
    "set_pow_block_provider",
    "register_pow_block",
    "clear_pow_chain",
    "is_merge_transition_complete",
    "is_merge_transition_block",
    "is_valid_terminal_pow_block",
    "validate_merge_block",
]


@dataclasses.dataclass(frozen=True)
class PowBlock:
    """Minimal PoW-chain view needed for terminal-block validation."""

    block_hash: bytes
    parent_hash: bytes
    total_difficulty: int


# --- pluggable PoW chain provider -------------------------------------------
# ``get_pow_block(hash) -> PowBlock | None`` mirrors the engine-API lookup a
# real client performs. Each ``Store`` may carry its own ``PowChainView``
# (``Simulation`` creates one per instance, so concurrent or sequential sims
# never share PoW state); stores without one fall back to the module-level
# default view that ``register_pow_block``/``set_pow_block_provider`` manage.


class PowChainView:
    """An isolated PoW-chain lookup: a block registry plus an optional
    engine-API-style provider that overrides it."""

    def __init__(self) -> None:
        self.blocks: Dict[bytes, PowBlock] = {}
        self.provider: Optional[Callable[[bytes], Optional[PowBlock]]] = None

    def register(self, block: PowBlock) -> None:
        self.blocks[bytes(block.block_hash)] = block

    def clear(self) -> None:
        self.blocks.clear()

    def set_provider(
        self, provider: Optional[Callable[[bytes], Optional[PowBlock]]]
    ) -> None:
        self.provider = provider

    def get(self, block_hash: bytes) -> Optional[PowBlock]:
        if self.provider is not None:
            return self.provider(bytes(block_hash))
        return self.blocks.get(bytes(block_hash))


DEFAULT_POW_CHAIN = PowChainView()


def register_pow_block(block: PowBlock) -> None:
    DEFAULT_POW_CHAIN.register(block)


def clear_pow_chain() -> None:
    DEFAULT_POW_CHAIN.clear()


def set_pow_block_provider(
    provider: Optional[Callable[[bytes], Optional[PowBlock]]]
) -> None:
    """Install a custom PoW lookup on the default view (None restores the
    registry default)."""
    DEFAULT_POW_CHAIN.set_provider(provider)


def get_pow_block(block_hash: bytes,
                  view: Optional[PowChainView] = None) -> Optional[PowBlock]:
    return (view or DEFAULT_POW_CHAIN).get(bytes(block_hash))


# --- transition predicates ---------------------------------------------------

def is_merge_transition_complete(state: BeaconState) -> bool:
    """True once the state has recorded any non-default payload header."""
    return state.latest_execution_payload_header != ExecutionPayloadHeader()


def is_merge_transition_block(state: BeaconState, body) -> bool:
    """True for the first block carrying a real execution payload
    (pos-evolution.md:1012): pre-state is still pre-merge AND the body's
    payload is non-default."""
    return (not is_merge_transition_complete(state)
            and body.execution_payload != ExecutionPayload())


def is_valid_terminal_pow_block(block: PowBlock, parent: PowBlock) -> bool:
    """The terminal PoW block is the first to reach terminal total
    difficulty: the block is at/over the threshold, its parent under."""
    c = cfg()
    is_total_difficulty_reached = (
        block.total_difficulty >= c.terminal_total_difficulty)
    is_parent_total_difficulty_valid = (
        parent.total_difficulty < c.terminal_total_difficulty)
    return is_total_difficulty_reached and is_parent_total_difficulty_valid


def validate_merge_block(block: BeaconBlock,
                         pow_view: Optional[PowChainView] = None) -> None:
    """Validate the merge-transition block's PoW parent
    (pos-evolution.md:1013).

    With a terminal-block-hash override configured, only the hash and the
    activation epoch are checked; otherwise the PoW parent and grandparent
    must exist and straddle the terminal total difficulty. AssertionError
    on failure, like every other ``on_block`` check — note the reference's
    caveat that a block failing only for an *unavailable* PoW block may
    become valid later (pos-evolution.md:988-990), which the simulator
    surfaces as the distinct message below.
    """
    c = cfg()
    if c.terminal_block_hash != b"\x00" * 32:
        assert (compute_epoch_at_slot(int(block.slot))
                >= c.terminal_block_hash_activation_epoch), \
            "merge block before terminal-block-hash activation epoch"
        assert (bytes(block.body.execution_payload.parent_hash)
                == c.terminal_block_hash), \
            "payload parent is not the configured terminal block"
        return

    pow_block = get_pow_block(bytes(block.body.execution_payload.parent_hash),
                              pow_view)
    assert pow_block is not None, "terminal PoW block unavailable"
    pow_parent = get_pow_block(bytes(pow_block.parent_hash), pow_view)
    assert pow_parent is not None, "terminal PoW parent unavailable"
    assert is_valid_terminal_pow_block(pow_block, pow_parent), \
        "PoW block does not straddle terminal total difficulty"
