"""Dense light-client population: finality followers as arrays (port of
``pos_evolution_tpu/lightclient/population.py``).

N clients tracked as struct-of-arrays, each following the active variant's
own finality-grade decision stream (Gasper: the FFG-finalized checkpoint;
Goldfish/RLMD: the fast or kappa confirmation; SSF: the per-slot
finalization) with a seeded per-client propagation lag. Clients attach
round-robin to view groups, so under a partition the halves follow
conflicting streams. Host numpy, but for the lag digests at ``bind``: one
kernel-K6 call (``ops/sha256.sha256_rows``) on the run's device.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.ops.sha256 import sha256_rows

__all__ = ["DenseLightClientPopulation"]

_MAX_LAG = 4  # slots; per-client draw is uniform over [0, _MAX_LAG)


class DenseLightClientPopulation:
    """N finality followers with seeded per-client lag."""

    kind = "lightclient"

    def __init__(self, n_clients: int = 256, seed: int = 0):
        self.n = int(n_clients)
        self.seed = int(seed)
        self.sim = None
        self.updates_applied = 0

    def bind(self, sim) -> None:
        self.sim = sim
        msgs = np.zeros((self.n, 16), dtype=np.uint8)
        msgs[:, :8] = np.frombuffer(self.seed.to_bytes(8, "little"),
                                    dtype=np.uint8)
        msgs[:, 8:16] = np.arange(self.n, dtype="<u8").view(
            np.uint8).reshape(self.n, 8)
        digests = sha256_rows(msgs, sim.device, plain=sim.plain).cpu().numpy()
        self.lag = (digests[:, 0] % _MAX_LAG).astype(np.int64)
        self.view_of = (np.arange(self.n, dtype=np.int64)
                        % sim.n_groups).astype(np.int8)
        # newest adopted decision per client: slot and block index
        self.head_slot = np.full(self.n, -1, dtype=np.int64)
        self.head_idx = np.full(self.n, -1, dtype=np.int64)
        # per-view publication log of (decision slot, block index)
        self._published: list[list[tuple[int, int]]] = [
            [] for _ in range(sim.n_groups)]

    def on_slot_end(self, sim, slot: int) -> None:
        for g in range(sim.n_groups):
            dec = sim.variant.latest_decision(sim, g)
            if dec is None:
                continue
            log = self._published[g]
            if not log or log[-1] != (int(dec[0]), int(dec[1])):
                log.append((int(dec[0]), int(dec[1])))
        # clients adopt the newest decision published at least ``lag``
        # slots ago (publication slot = the slot the decision was made)
        for g in range(sim.n_groups):
            log = self._published[g]
            if not log:
                continue
            slots = np.array([s for s, _ in log], dtype=np.int64)
            idxs = np.array([i for _, i in log], dtype=np.int64)
            mine = self.view_of == g
            # per-client newest visible publication index (-1 = none)
            vis = slots[None, :] + self.lag[mine, None] <= slot
            pick = np.where(vis.any(axis=1),
                            vis.shape[1] - 1 - np.argmax(vis[:, ::-1],
                                                         axis=1), -1)
            has = pick >= 0
            new_slot = np.where(has, slots[np.clip(pick, 0, None)], -1)
            new_idx = np.where(has, idxs[np.clip(pick, 0, None)], -1)
            old = self.head_slot[mine]
            adv = new_slot > old
            self.updates_applied += int(np.count_nonzero(adv))
            self.head_slot[mine] = np.where(adv, new_slot, old)
            self.head_idx[mine] = np.where(adv, new_idx,
                                           self.head_idx[mine])

    def stats(self) -> dict:
        synced = self.head_slot >= 0
        return {"clients": self.n,
                "updates_applied": self.updates_applied,
                "clients_synced": int(np.count_nonzero(synced)),
                "max_head_slot": int(self.head_slot.max(initial=-1)),
                "max_lag_slots": int(self.lag.max(initial=0))}

    def describe(self) -> dict:
        return {"kind": self.kind, "n_clients": self.n, "seed": self.seed}

    @classmethod
    def from_config(cls, d: dict) -> "DenseLightClientPopulation":
        return cls(n_clients=int(d.get("n_clients", 256)),
                   seed=int(d.get("seed", 0)))

    # -- checkpoint state ------------------------------------------------------

    def state_meta(self) -> dict:
        return {"updates_applied": self.updates_applied,
                "published": [[[int(s), int(i)] for s, i in log]
                              for log in self._published]}

    def state_arrays(self) -> dict:
        return {"head_slot": self.head_slot, "head_idx": self.head_idx}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.updates_applied = int(meta.get("updates_applied", 0))
        self._published = [[(int(s), int(i)) for s, i in log]
                           for log in meta.get("published", [])]
        while len(self._published) < (self.sim.n_groups if self.sim else 1):
            self._published.append([])
        if "head_slot" in arrays:
            self.head_slot = np.asarray(arrays["head_slot"], np.int64)
            self.head_idx = np.asarray(arrays["head_idx"], np.int64)
