"""Blob production and per-view availability: the full-node side of DAS
(port of ``pos_evolution_tpu/das/engine.py``).

``BlobEngine`` is the deterministic blob workload: a blob's data cells are
a seeded pure function of (slot, parent_root, blob_index), so the proposer,
every verifying view and a resumed run regenerate byte-identical grids.
``BlobStore`` is one view's availability state: sidecars are verified
(geometry, the commitment recomputed over the full grid, then the
erasure-consistency check from the parity half) before they feed the
availability gate.

The work is independent per blob, so a proposal's blobs go through the
card together: ``build_batch`` makes all of a proposal's grids with one
kernel-K6 call for the counter streams, one kernel-K7 call for the
extensions and one K6 call plus one K2 call a level for the commitments;
``BlobStore.on_sidecars`` verifies a list of sidecars with one K6 call,
the K2 levels and one K7 call, and one read of the verdicts. Every verdict,
counter and byte is what the JAX package's per-blob loop gives.

The configuration is explicit here (the JAX package reads a global one).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pos_evolution_tpu_torch.das.commitment import MerkleCellScheme, get_scheme
from pos_evolution_tpu_torch.das.containers import (
    BlobSidecar,
    commitments_digest,
    das_graffiti,
    parse_das_graffiti,
    validate_das_config,
)
from pos_evolution_tpu_torch.das.erasure import extension_matrix
from pos_evolution_tpu_torch.device import rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops.das_verify import gf_matmul, reconstruct_check_batch
from pos_evolution_tpu_torch.ops.sha256 import sha256_rows

__all__ = ["BlobEngine", "BlobStore"]


class BlobEngine:
    """Deterministic blob workload and grid factory (one per simulation),
    under config ``cfg``, on ``device`` (CUDA unless the caller asks for
    another); ``plain=True`` takes the plain versions of K2, K6 and K7."""

    def __init__(self, cfg, n_blobs: int | None = None, scheme="merkle", seed: int = 0,
                 device="cuda", *, plain: bool = False):
        validate_das_config(cfg)
        self.cfg = cfg
        self.n_blobs = n_blobs
        self.scheme: MerkleCellScheme = (
            scheme if isinstance(scheme, MerkleCellScheme)
            else get_scheme(scheme, device, plain=plain))
        self.device = self.scheme.device
        self.plain = bool(plain)
        self.seed = int(seed)
        k = cfg.das_cells_per_blob
        self._ext = torch.from_numpy(extension_matrix(k)[None].copy()).to(self.device)

    def blobs_per_block(self) -> int:
        return self.cfg.das_max_blobs_per_block if self.n_blobs is None else self.n_blobs

    def data_batch(self, slot: int, parent_root: bytes, blob_indices) -> torch.Tensor:
        """(n, k, cell_bytes) data cells of the n blobs ``blob_indices`` on the
        device: one SHA-256 counter stream per blob, every blob's in one K6
        call."""
        c = self.cfg
        total = c.das_cells_per_blob * c.das_cell_bytes
        n_hashes = (total + 31) // 32
        idx = np.asarray(blob_indices, dtype=np.int64).reshape(-1)
        n = idx.size
        msgs = np.zeros((n, n_hashes, 52), dtype=np.uint8)
        msgs[:, :, :8] = np.frombuffer(self.seed.to_bytes(8, "little"), dtype=np.uint8)
        msgs[:, :, 8:16] = np.frombuffer(int(slot).to_bytes(8, "little"), dtype=np.uint8)
        msgs[:, :, 16:48] = np.frombuffer(bytes(parent_root), dtype=np.uint8)
        msgs[:, :, 48] = (idx & 0xFF)[:, None]
        msgs[:, :, 49:52] = np.arange(n_hashes, dtype="<u4").view(np.uint8).reshape(
            n_hashes, 4)[:, :3]
        stream = sha256_rows(msgs.reshape(n * n_hashes, 52), self.device, plain=self.plain)
        return stream.reshape(n, n_hashes * 32)[:, :total].reshape(
            n, c.das_cells_per_blob, c.das_cell_bytes)

    def blob_data(self, slot: int, parent_root: bytes, blob_index: int) -> np.ndarray:
        """(k, cell_bytes) seeded data cells of one blob."""
        return self.data_batch(slot, parent_root, [blob_index])[0].cpu().numpy()

    def extend_batch(self, data: torch.Tensor) -> torch.Tensor:
        """(G, k, W) data cells -> (G, 2k, W) extended grids, the data rows
        first: every blob's parity in one K7 call."""
        return torch.cat([data, gf_matmul(self._ext, data, plain=self.plain)], dim=1)

    def build_batch(self, slot: int, parent_root: bytes) -> tuple[torch.Tensor, list[bytes]]:
        """A proposal's (G, 2k, W) grids on the device and their G
        commitments (one read to the host)."""
        grids = self.extend_batch(
            self.data_batch(slot, parent_root, range(self.blobs_per_block())))
        roots = words_to_rows(self.scheme.commit_batch(grids)).cpu().numpy()
        return grids, [r.tobytes() for r in roots]

    def build_for(self, slot: int, parent_root: bytes
                  ) -> tuple[list[np.ndarray], list[bytes], bytes]:
        """Everything a proposer needs before the block exists: the extended
        grids (host arrays), their commitments and the graffiti marker."""
        grids, commitments = self.build_batch(slot, parent_root)
        return list(grids.cpu().numpy()), commitments, das_graffiti(commitments)

    def describe(self) -> dict:
        return {"kind": "blob_engine", "scheme": self.scheme.name,
                "n_blobs": self.blobs_per_block(), "seed": self.seed}


class BlobStore:
    """One view group's DAS availability state."""

    def __init__(self, engine: BlobEngine, registry=None, group: int = -1):
        self.engine = engine
        self.registry = registry
        self.group = group
        # (block_root, blob_index) -> {commitment: verified BlobSidecar}:
        # candidate sets, so a self-consistent sidecar under a wrong
        # commitment cannot block the honest one; the block's graffiti
        # digest picks the real set at gate time
        self.sidecars: dict[tuple[bytes, int], dict[bytes, BlobSidecar]] = {}
        self._resolved: dict[bytes, list[BlobSidecar]] = {}

    def _count(self, name: str, help_: str) -> None:
        if self.registry is not None:
            self.registry.counter(name, help_).inc(group=self.group)

    def _verdicts(self, scs: list[BlobSidecar]) -> list[bool]:
        """Each sidecar's verification, all of them on the device at once:
        the geometry, the commitment recomputed over the full grid, and the
        parity-half reconstruction (the data interpolated back from the k
        parity cells must equal the claimed data half, and its re-extension
        the claimed parity half)."""
        c = self.engine.cfg
        k, width = c.das_cells_per_blob, c.das_cell_bytes
        dev = self.engine.device
        cells, shaped = [], []
        for i, sc in enumerate(scs):
            t = (sc.cells.to(dev, torch.uint8) if isinstance(sc.cells, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(sc.cells, dtype=np.uint8)).to(dev))
            if (tuple(t.shape) == (2 * k, width) and int(sc.blob_index) < int(sc.n_blobs)
                    and len(bytes(sc.commitment)) == 32):
                cells.append(t)
                shaped.append(i)
        out = [False] * len(scs)
        if not shaped:
            return out
        grids = torch.stack(cells)
        want = np.frombuffer(b"".join(bytes(scs[i].commitment) for i in shaped),
                             dtype=np.uint8).reshape(-1, 32)
        committed = (self.engine.scheme.commit_batch(grids)
                     == rows_to_words(torch.from_numpy(want.copy()).to(dev))).all(dim=1)
        half = np.zeros((len(shaped), 2 * k), dtype=bool)
        half[:, k:] = True
        recon_ok, data = reconstruct_check_batch(grids, half, plain=self.engine.plain)
        ok = committed & recon_ok & (data == grids[:, :k]).flatten(1).all(dim=1)
        for i, v in zip(shaped, ok.cpu().tolist()):
            out[i] = v
        return out

    def on_sidecars(self, scs: list[BlobSidecar]) -> list[bool]:
        """Ingest sidecars in order, as ``on_sidecar`` one after another
        would: a redelivery of a stored (block, blob, commitment) is ignored
        and passes; otherwise a sidecar failing verification is rejected and
        counted, and one passing is stored."""
        scs = list(scs)
        fresh = [i for i, sc in enumerate(scs)
                 if bytes(sc.commitment) not in self.sidecars.get(
                     (bytes(sc.block_root), int(sc.blob_index)), ())]
        verdicts = dict(zip(fresh, self._verdicts([scs[i] for i in fresh])))
        out = []
        for i, sc in enumerate(scs):
            key = (bytes(sc.block_root), int(sc.blob_index))
            com = bytes(sc.commitment)
            if com in self.sidecars.get(key, ()):
                self._count("das_sidecar_duplicates_total",
                            "sidecar redeliveries ignored by the blob store")
                out.append(True)
            elif not verdicts[i]:
                self._count("das_sidecars_rejected_total",
                            "sidecars failing commitment/erasure verification")
                out.append(False)
            else:
                self.sidecars.setdefault(key, {})[com] = sc
                self._count("das_sidecars_accepted_total", "sidecars verified and stored")
                out.append(True)
        return out

    def on_sidecar(self, sc: BlobSidecar) -> bool:
        """Gossip or backfill ingest of one sidecar: verify, then index."""
        return self.on_sidecars([sc])[0]

    # -- availability gate -----------------------------------------------------

    def is_available(self, block_root: bytes, block) -> bool:
        """The fork-choice data-availability predicate: for every blob the
        block's graffiti marker commits to, some verified candidate is held
        whose commitment set matches the marker digest. Blocks without the
        marker gate vacuously."""
        meta = parse_das_graffiti(bytes(block.body.graffiti))
        if meta is None:
            return True
        n_blobs, digest = meta
        root = bytes(block_root)
        if root in self._resolved:
            return True
        candidates = [list(self.sidecars.get((root, i), {}).values()) for i in range(n_blobs)]
        if any(not held for held in candidates):
            return False
        # honest traffic has one candidate per index; a flood is bounded
        for pick in itertools.islice(itertools.product(*candidates), 256):
            if commitments_digest([bytes(sc.commitment) for sc in pick]) == digest:
                self._resolved[root] = list(pick)
                return True
        return False

    def sidecars_for_block(self, block_root: bytes) -> list[BlobSidecar]:
        root = bytes(block_root)
        if root in self._resolved:
            return list(self._resolved[root])
        out = []
        i = 0
        while (root, i) in self.sidecars:
            out.append(next(iter(self.sidecars[(root, i)].values())))
            i += 1
        return out
