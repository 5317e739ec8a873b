"""In-loop corruption detection that triggers *recovery*, not just a log
line (port of ``pos_evolution_tpu/resilience/guard.py``).

The port's one change: ``scan_columns`` reads a tensor column back to
the host first (``_host``), since the dense driver's and the resident
store's columns are torch tensors, and ``np.asarray`` cannot take a
CUDA tensor.

The repo already owns the right oracles — the deep spec-walk audit
(``ops/resident.py`` self-checks, ``DenseSimulation.head_host_walk``),
store invariants, and the twin-divergence pins in tests. What was
missing is turning a mid-run mismatch into an action: the
``IntegrityGuard`` runs those oracles every ``every_n_slots`` inside
the autocheckpointing run loop, and on ANY finding the driver

1. emits an ``integrity_violation`` event naming every finding,
2. **quarantines the newest checkpoint** (it may already embed the
   corruption — a checksum cannot see semantic rot, so the newest step
   is guilty until a replay proves otherwise),
3. raises ``IntegrityError`` so the supervised process dies loudly and
   the supervisor resumes from the last *good* step and replays.

Rollback-replay bit-identity vs an uninterrupted twin is pinned in
``tests/test_resilience.py`` — determinism of the drivers is what makes
"roll back and replay" a correctness-preserving recovery instead of a
shrug.
"""

from __future__ import annotations

import numpy as np


class IntegrityError(RuntimeError):
    """Mid-run state corruption detected; the process must not keep
    building on (or checkpointing) the poisoned state."""

    def __init__(self, findings: list[str]):
        super().__init__("integrity check failed: " + "; ".join(findings))
        self.findings = list(findings)


def _host(col) -> np.ndarray:
    """A column as a host array: torch tensors are read back."""
    if hasattr(col, "detach"):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def scan_columns(cols: dict, n_blocks: int | None = None) -> list[str]:
    """Generic resident-column scan: non-finite values in any float
    column, negative balances, and message pointers outside the block
    table — the dense-state analogues of a NaN in a training step."""
    findings = []
    for name, col in cols.items():
        a = _host(col)
        if np.issubdtype(a.dtype, np.floating):
            bad = int((~np.isfinite(a)).sum())
            if bad:
                findings.append(f"{name}: {bad} non-finite value(s)")
        if name in ("balance", "effective_balance") and a.size:
            neg = int((a < 0).sum())
            if neg:
                findings.append(f"{name}: {neg} negative balance(s)")
        if name == "msg_block" and n_blocks is not None and a.size:
            oob = int(((a < -1) | (a >= n_blocks)).sum())
            if oob:
                findings.append(
                    f"msg_block: {oob} pointer(s) outside the "
                    f"{n_blocks}-entry block table")
    return findings


class IntegrityGuard:
    """Periodic deep audit for either driver; ``check(driver)``
    dispatches on the driver's shape and returns a list of human-
    readable findings (empty = clean)."""

    def __init__(self, every_n_slots: int = 8):
        self.every_n_slots = max(int(every_n_slots), 1)
        self.checks = 0
        self._last_finalized: int | None = None

    def due(self, slot: int) -> bool:
        return slot % self.every_n_slots == 0

    def check(self, driver) -> list[str]:
        self.checks += 1
        if hasattr(driver, "head_host_walk"):
            return self._check_dense(driver)
        return self._check_sim(driver)

    # -- dense driver ----------------------------------------------------------

    def _check_dense(self, sim) -> list[str]:
        findings = []
        cols = {f: getattr(sim.registry, f) for f in sim.registry._fields}
        cols["msg_block"] = sim.msg_block
        findings += scan_columns(cols, n_blocks=len(sim.roots))
        # the deep oracle: device fork choice vs the vectorized host
        # spec walk over the gathered message table. On state corrupt
        # enough to crash the walk itself (a poisoned pointer indexing
        # past the tree), the crash IS the finding — the guard must
        # report and trigger rollback, not die of the corruption it
        # exists to catch.
        try:
            device_head = sim.roots[sim._head()]
            host_head = sim.head_host_walk()
            if device_head != host_head:
                findings.append(
                    f"device head {device_head.hex()[:12]} != host "
                    f"spec-walk head {host_head.hex()[:12]}")
        except Exception as e:
            findings.append(f"deep head oracle crashed on corrupt state: "
                            f"{type(e).__name__}: {e}"[:300])
        findings += self._finality_monotone(sim.finalized[0])
        return findings

    # -- spec driver -----------------------------------------------------------

    def _check_sim(self, sim) -> list[str]:
        from pos_evolution_tpu_torch.specs import forkchoice as fc
        findings = []
        for g in sim.groups:
            if g.crashed:
                continue
            store = g.store
            if (int(store.finalized_checkpoint.epoch)
                    > int(store.justified_checkpoint.epoch)):
                findings.append(
                    f"group {g.id}: finalized epoch "
                    f"{int(store.finalized_checkpoint.epoch)} ahead of "
                    f"justified {int(store.justified_checkpoint.epoch)}")
            if g.resident is not None and not g.resident.degraded:
                cols = {"msg_block": g.resident.msg_block,
                        "msg_epoch": g.resident.msg_epoch}
                findings += [f"group {g.id}: {f}"
                             for f in scan_columns(cols)]
            if sim.variant.describe().get("kind") == "GasperVariant":
                # deep oracle (Gasper only: successor variants answer
                # from their own expiry-windowed rules, for which the
                # plain spec walk is the WRONG reference)
                spec_head = fc.get_head(store)
                prod_head = sim.variant.head(sim, g)
                if prod_head != spec_head:
                    findings.append(
                        f"group {g.id}: production head "
                        f"{prod_head.hex()[:12]} != spec-walk head "
                        f"{spec_head.hex()[:12]}")
        findings += self._finality_monotone(sim.finalized_epoch())
        return findings

    def _finality_monotone(self, finalized: int) -> list[str]:
        """Finality can never regress within one run — a rollback of the
        finalized epoch between audits means state was clobbered."""
        out = []
        if (self._last_finalized is not None
                and finalized < self._last_finalized):
            out.append(f"finalized epoch regressed "
                       f"{self._last_finalized} -> {finalized}")
        self._last_finalized = max(finalized,
                                   self._last_finalized
                                   if self._last_finalized is not None
                                   else finalized)
        return out
