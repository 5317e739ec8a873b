"""GoldfishVariant: GHOST-Eph in the production driver
(pos-evolution.md:1543-1579).

- ``eta = 1`` vote expiry: only the previous slot's head votes carry
  fork-choice weight (:1549) — the property that makes banked withheld
  votes worthless and kills the swayer balancing attack (:1321-1348)
  without proposer boost;
- VRF leader preference + voter subsampling (:1545, :1554): the beacon
  carrier fixes the proposer *schedule* (block validity pins
  ``proposer_index``), so VRF election manifests as the fork-choice
  preference for the minimal-VRF proposal among same-slot siblings and
  as the subsampled vote-eligibility predicate shared with the
  ``models/`` PVM oracle;
- kappa-deep (slow) and 3/4 fast confirmation (:1556, :1562-1569), fast
  confirmations never rolled back (:1568).
"""

from __future__ import annotations

from pos_evolution_tpu_torch.variants.base import ExpiryVariantBase


class GoldfishVariant(ExpiryVariantBase):
    name = "goldfish"
    eta = 1
    use_vrf = True

    def __init__(self, kappa: int = 4, fast_confirm: bool = True,
                 fast_confirm_threshold: float = 0.75,
                 subsample_rate: float = 1.0):
        super().__init__()
        self.kappa = int(kappa)
        self.fast_confirm = bool(fast_confirm)
        self.fast_confirm_threshold = float(fast_confirm_threshold)
        self.subsample_rate = float(subsample_rate)

    def describe(self) -> dict:
        return {"kind": "GoldfishVariant", "eta": 1, "kappa": self.kappa,
                "fast_confirm": self.fast_confirm,
                "fast_confirm_threshold": self.fast_confirm_threshold,
                "subsample_rate": self.subsample_rate}
