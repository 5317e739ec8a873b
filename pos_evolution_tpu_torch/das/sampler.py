"""Sampling-client population: 10^5-10^6 DAS light clients as arrays (port
of ``pos_evolution_tpu/das/sampler.py``).

Each client picks a few (blob, cell) coordinates per block by a seeded
stateless hash of (seed, client_id, block_root): one SHA-256 digest per
client per selection round, all clients' digests in one kernel-K6 call
(``ops/sha256.sha256_rows``) on the population's device and read back to
the host once. The draws are the JAX package's byte for byte.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.device import resolve_device
from pos_evolution_tpu_torch.ops.sha256 import sha256_rows

__all__ = ["SamplingClientPopulation"]

# bytes of digest consumed per sample (u16 cell draw + u8 blob draw)
_BYTES_PER_SAMPLE = 3
_SAMPLES_PER_DIGEST = 32 // _BYTES_PER_SAMPLE  # 10


class SamplingClientPopulation:
    """N sampling clients with seeded per-client cell selection, under
    config ``cfg``, hashing on ``device`` (CUDA unless the caller asks for
    another; ``plain=True``: K6's plain version)."""

    def __init__(self, cfg, n_clients: int, samples_per_client: int | None = None,
                 seed: int = 0, device="cuda", *, plain: bool = False):
        self.n = int(n_clients)
        self.samples = (cfg.das_samples_per_client if samples_per_client is None
                        else int(samples_per_client))
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.blocks_sampled = 0
        self.samples_drawn = 0

    def _digests(self, block_root: bytes, round_: int) -> np.ndarray:
        """(n, 32) per-client digests for one selection round."""
        msgs = np.zeros((self.n, 49), dtype=np.uint8)
        msgs[:, :8] = np.frombuffer(self.seed.to_bytes(8, "little"), dtype=np.uint8)
        msgs[:, 8:16] = np.arange(self.n, dtype="<u8").view(np.uint8).reshape(self.n, 8)
        msgs[:, 16:48] = np.frombuffer(bytes(block_root), dtype=np.uint8)
        msgs[:, 48] = round_ & 0xFF
        return sha256_rows(msgs, self.device, plain=self.plain).cpu().numpy()

    def select_cells(self, block_root: bytes, n_blobs: int,
                     n_cells: int) -> tuple[np.ndarray, np.ndarray]:
        """Seeded (blob_ids, cell_ids), each (n_clients, samples_per_client).
        One digest serves up to 10 samples; more draw further digests with a
        round counter."""
        s = self.samples
        blob_ids = np.zeros((self.n, s), dtype=np.int64)
        cell_ids = np.zeros((self.n, s), dtype=np.int64)
        for j in range(s):
            round_, slot_in = divmod(j, _SAMPLES_PER_DIGEST)
            if slot_in == 0:
                digests = self._digests(block_root, round_)
            b = digests[:, slot_in * 3:slot_in * 3 + 3].astype(np.int64)
            cell_ids[:, j] = (b[:, 0] | (b[:, 1] << 8)) % n_cells
            blob_ids[:, j] = b[:, 2] % max(n_blobs, 1)
        self.blocks_sampled += 1
        self.samples_drawn += self.n * s
        return blob_ids, cell_ids

    def describe(self) -> dict:
        return {"kind": "das_population", "clients": self.n,
                "samples_per_client": self.samples, "seed": self.seed}
