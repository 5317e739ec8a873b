"""RlmdGhostVariant: RLMD-GHOST in the production driver
(pos-evolution.md:1581-1609).

Eta-expiry LMD: latest head votes from the last ``eta`` slots weigh the
GHOST descent (:1585; ``eta = 1`` recovers Goldfish, ``eta = inf`` LMD),
with the view-merge buffer discipline (:1528-1541) — votes delivered
mid-slot sit in the pending buffer until the next merge boundary, so
just-before-the-deadline delivery (:1328) cannot split the voters. The
protocol tolerates asynchronous periods shorter than ``eta - 1`` slots
(:1600); kappa-deep confirmation gives the output ledger."""

from __future__ import annotations

from pos_evolution_tpu_torch.variants.base import ExpiryVariantBase


class RlmdGhostVariant(ExpiryVariantBase):
    name = "rlmd"

    def __init__(self, eta: int = 4, kappa: int = 4):
        super().__init__()
        self.eta = int(eta)
        self.kappa = int(kappa)
        self.fast_confirm = False

    def describe(self) -> dict:
        return {"kind": "RlmdGhostVariant", "eta": self.eta,
                "kappa": self.kappa}
