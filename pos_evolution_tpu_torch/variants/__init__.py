"""Pluggable protocol variants (ROADMAP item 5; DESIGN.md §16).

The protocol itself becomes a seam: ``ProtocolVariant`` abstracts fork
choice + finality over the production driver, so the paper's successor
protocols (view-merge -> Goldfish -> RLMD-GHOST -> single-slot finality,
pos-evolution.md:1528-1650) run end-to-end through ``Simulation`` — under
the PR-5 Byzantine adversaries, safety/liveness monitors, fault plans,
checkpoint/resume, and telemetry — instead of living only in the toy
``models/`` propose-vote-merge layer (which is retained as the
per-variant differential oracle).
"""

from pos_evolution_tpu_torch.variants.base import (
    ProtocolVariant,
    VariantVoteLog,
    variant_from_config,
)
from pos_evolution_tpu_torch.variants.gasper import GasperVariant
from pos_evolution_tpu_torch.variants.goldfish import GoldfishVariant
from pos_evolution_tpu_torch.variants.rlmd import RlmdGhostVariant
from pos_evolution_tpu_torch.variants.ssf import SsfVariant

VARIANTS = {
    "gasper": GasperVariant,
    "goldfish": GoldfishVariant,
    "rlmd": RlmdGhostVariant,
    "ssf": SsfVariant,
}

__all__ = [
    "ProtocolVariant", "VariantVoteLog", "variant_from_config",
    "GasperVariant", "GoldfishVariant", "RlmdGhostVariant", "SsfVariant",
    "VARIANTS",
]
