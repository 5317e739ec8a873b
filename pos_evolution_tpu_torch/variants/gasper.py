"""GasperVariant: today's protocol behind the seam, behavior-identical.

HLMD-GHOST + FFG exactly as ``specs/forkchoice.py`` implements them
(pos-evolution.md:884-1126): head queries answer from the resident device
mirror when one is attached (ops/resident.py) or the spec walk otherwise
— byte-for-byte the pre-seam driver (pinned by the behavior-identity test
in tests/test_variant_seam.py). No overlay is attached
(``needs_view = False``), so the fork-choice handlers' ``variant_view``
hook stays None and the hot path pays one attribute read."""

from __future__ import annotations

from pos_evolution_tpu_torch.specs import forkchoice as fc
from pos_evolution_tpu_torch.variants.base import ProtocolVariant


class GasperVariant(ProtocolVariant):
    name = "gasper"
    needs_view = False

    def head(self, sim, group) -> bytes:
        if group.resident is not None:
            return group.resident.head(group.store)
        return fc.get_head(group.store)

    def describe(self) -> dict:
        return {"kind": "GasperVariant"}
