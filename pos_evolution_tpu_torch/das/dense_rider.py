"""DAS workload rider for the dense driver (port of
``pos_evolution_tpu/das/dense_rider.py``).

Every per-view proposal gets its sidecars built (``BlobEngine``), verified
through the receiving view's full pipeline (``BlobStore``: the commitment
recomputed, the parity-half reconstruction), and sampled by the seeded
client population. The work runs on the run's device, a proposal's blobs
together, and is charged to the driver's ``workload`` phase.

Everything is a pure function of (seed, slot, parent_root), so a resumed
episode rebuilds byte-identical sidecars; the counters are the rider's only
mutable state and ride the dense checkpoint.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.das.containers import BlobSidecar
from pos_evolution_tpu_torch.das.engine import BlobEngine, BlobStore
from pos_evolution_tpu_torch.das.sampler import SamplingClientPopulation

__all__ = ["DenseDasRider"]


class DenseDasRider:
    """Sidecar production, sampling and verification per dense proposal."""

    kind = "das"

    def __init__(self, scheme: str = "merkle", n_blobs: int = 1, n_clients: int = 64,
                 samples_per_client: int = 4, seed: int = 0, verify_every: int = 1):
        self.scheme = str(scheme)
        self.n_blobs = int(n_blobs)
        self.n_clients = int(n_clients)
        self.samples_per_client = int(samples_per_client)
        self.seed = int(seed)
        # the reconstruction check is the expensive leg: thinned to every
        # N-th proposal (commitments and sampling run on every one)
        self.verify_every = max(int(verify_every), 1)
        self.sidecars_built = 0
        self.sidecars_verified = 0
        self.sidecar_failures = 0
        self.samples_drawn = 0
        self.sample_misses = 0
        self._proposals_seen = 0

    def bind(self, sim) -> None:
        self.engine = BlobEngine(sim.cfg, n_blobs=self.n_blobs, scheme=self.scheme,
                                 seed=self.seed, device=sim.device, plain=sim.plain)
        self.clients = SamplingClientPopulation(
            sim.cfg, self.n_clients, samples_per_client=self.samples_per_client,
            seed=self.seed, device=sim.device, plain=sim.plain)

    def on_proposals(self, sim, slot: int, new_idx) -> None:
        for idx in dict.fromkeys(int(i) for i in new_idx):
            self._proposals_seen += 1
            root = sim.roots[idx]
            parent_root = sim.roots[sim.parents[idx]]
            grids, commitments = self.engine.build_batch(slot, parent_root)
            self.sidecars_built += len(commitments)
            if self._proposals_seen % self.verify_every == 0:
                # the receiving view's full verification: geometry,
                # commitment recompute, parity-half reconstruction
                store = BlobStore(self.engine)
                scs = [BlobSidecar(slot=slot, proposer_index=0, block_root=root, blob_index=i,
                                   n_blobs=len(commitments), cells=grids[i], commitment=com)
                       for i, com in enumerate(commitments)]
                for ok in store.on_sidecars(scs):
                    if ok:
                        self.sidecars_verified += 1
                    else:
                        self.sidecar_failures += 1
            n_cells = int(grids.shape[1])
            blob_ids, cell_ids = self.clients.select_cells(root, len(commitments), n_cells)
            self.samples_drawn += int(blob_ids.size)
            # availability sweep: every sampled (blob, cell) coordinate must
            # exist in the extended grids the proposer published
            ok = ((blob_ids >= 0) & (blob_ids < len(commitments))
                  & (cell_ids >= 0) & (cell_ids < n_cells))
            self.sample_misses += int(np.size(ok) - np.count_nonzero(ok))

    def describe(self) -> dict:
        return {"kind": self.kind, "scheme": self.scheme,
                "n_blobs": self.n_blobs, "n_clients": self.n_clients,
                "samples_per_client": self.samples_per_client,
                "seed": self.seed, "verify_every": self.verify_every}

    @classmethod
    def from_config(cls, d: dict) -> "DenseDasRider":
        return cls(scheme=d.get("scheme", "merkle"),
                   n_blobs=int(d.get("n_blobs", 1)),
                   n_clients=int(d.get("n_clients", 64)),
                   samples_per_client=int(d.get("samples_per_client", 4)),
                   seed=int(d.get("seed", 0)),
                   verify_every=int(d.get("verify_every", 1)))

    def stats(self) -> dict:
        return {"scheme": self.scheme,
                "sidecars_built": self.sidecars_built,
                "sidecars_verified": self.sidecars_verified,
                "sidecar_failures": self.sidecar_failures,
                "samples_drawn": self.samples_drawn,
                "sample_misses": self.sample_misses,
                "blocks_sampled": self.clients.blocks_sampled}

    # -- checkpoint state (counters only; content is replay-from-seed) ---------

    def state_meta(self) -> dict:
        return {"sidecars_built": self.sidecars_built,
                "sidecars_verified": self.sidecars_verified,
                "sidecar_failures": self.sidecar_failures,
                "samples_drawn": self.samples_drawn,
                "sample_misses": self.sample_misses,
                "proposals_seen": self._proposals_seen,
                "blocks_sampled": self.clients.blocks_sampled,
                "client_samples_drawn": self.clients.samples_drawn}

    def state_arrays(self) -> dict:
        return {}

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self.sidecars_built = int(meta.get("sidecars_built", 0))
        self.sidecars_verified = int(meta.get("sidecars_verified", 0))
        self.sidecar_failures = int(meta.get("sidecar_failures", 0))
        self.samples_drawn = int(meta.get("samples_drawn", 0))
        self.sample_misses = int(meta.get("sample_misses", 0))
        self._proposals_seen = int(meta.get("proposals_seen", 0))
        self.clients.blocks_sampled = int(meta.get("blocks_sampled", 0))
        self.clients.samples_drawn = int(meta.get("client_samples_drawn", 0))
