"""Adversarial schedule: fault injection as data (SURVEY.md §5).

The reference's adversary model is first-class: Byzantine corruption of up
to f validators (pos-evolution.md:183-185), per-round sleep/awake scheduling
(:191-199), adversary-controlled message delays up to Δ under synchrony
(:197), GST/GAT partial synchrony (:199), and targeted delivery used by the
balancing attacks (:1328: "be able to target a message for delivery to an
honest validator just before a certain point in time").

A ``Schedule`` captures all of that as plain data — per-round awake masks,
per-(message, recipient-group) delivery offsets, corrupted sets — so the
same simulation driver executes honest runs and attack scenarios without
control-flow forks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class Schedule:
    """Delivery/corruption/sleep policy for one simulation run."""

    n_validators: int
    # Validator index -> view-group id. Validators in one group receive
    # exactly the same messages at the same times (pos-evolution.md:201-203:
    # views are per-validator; groups are the equivalence classes the
    # adversary's delivery strategy induces).
    group_of: np.ndarray = None
    # Corrupted (Byzantine) validator indices (pos-evolution.md:183-185).
    corrupted: set = field(default_factory=set)
    # awake(round_index, validator_index) -> bool (sleepy model, :191-199).
    awake: Callable[[int, int], bool] = None
    # block_delay(proposer, slot, group) -> seconds after slot start at which
    # the group receives the block (None = withhold forever).
    block_delay: Callable[[int, int, int], float | None] = None
    # attestation_delay(attester_group, slot, group) -> seconds after the
    # *next* slot start (wire attestations are only usable from slot+1).
    attestation_delay: Callable[[int, int, int], float | None] = None
    # Message-level fault policy (sim/faults.py): per-message drop /
    # duplicate / reorder, GST windows, crash-restart view groups. None =
    # faithful delivery at exactly the scheduled delays (the model above).
    faults: "FaultPlan | None" = None

    def __post_init__(self):
        if self.group_of is None:
            self.group_of = np.zeros(self.n_validators, dtype=np.int64)
        self.group_of = np.asarray(self.group_of, dtype=np.int64)
        if self.awake is None:
            self.awake = lambda r, v: True
        if self.block_delay is None:
            self.block_delay = lambda proposer, slot, group: 0.0
        if self.attestation_delay is None:
            self.attestation_delay = lambda src_group, slot, group: 0.0

    @property
    def n_groups(self) -> int:
        return int(self.group_of.max()) + 1 if self.group_of.size else 1

    def members(self, group: int) -> np.ndarray:
        return np.nonzero(self.group_of == group)[0]

    def honest_members(self, group: int) -> np.ndarray:
        m = self.members(group)
        if not self.corrupted:
            return m
        return np.array([v for v in m if int(v) not in self.corrupted], dtype=np.int64)


def honest_schedule(n_validators: int) -> Schedule:
    """Synchronous, all-honest, single-view run."""
    return Schedule(n_validators=n_validators)


def partition_schedule(n_validators: int, n_groups: int,
                       corrupted: set | None = None) -> Schedule:
    """Round-robin split of the validator set into ``n_groups`` views."""
    return Schedule(
        n_validators=n_validators,
        group_of=np.arange(n_validators, dtype=np.int64) % n_groups,
        corrupted=corrupted or set(),
    )


def faulty_schedule(n_validators: int, faults, n_groups: int = 1,
                    corrupted: set | None = None) -> Schedule:
    """A partitioned (or single-view) schedule with a ``FaultPlan``
    attached — the composition point for the sim/faults.py adversary."""
    sched = (honest_schedule(n_validators) if n_groups == 1 else
             partition_schedule(n_validators, n_groups, corrupted))
    sched.faults = faults
    return sched
