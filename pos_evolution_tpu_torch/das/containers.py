"""DAS containers: blob sidecars over an erasure-extended cell grid (port
of ``pos_evolution_tpu/das/containers.py``).

A proposal's blob payload travels as per-blob ``BlobSidecar`` gossip
objects, each carrying the full 2k-cell extended grid. The block commits
to its blobs through its 32-byte graffiti: a DAS marker binding the blob
count and the commitment set (``das_graffiti`` / ``parse_das_graffiti``).

``CellRows`` and ``BlobSidecar`` are SSZ types on the port's copied SSZ
core, byte-equal in serialization and ``hash_tree_root`` to the JAX
package's: ``CellRows`` stores a grid as one (n_cells, cell_bytes) uint8
array, its per-cell roots through ``ssz/hash.sha256_pairs`` (kernel K2 on
a CUDA backend from the crossover up) and its list root through
``ssz/merkle.merkleize_chunks``. The spec driver's sidecars carry host
arrays; the dense rider's (``das/dense_rider.py``) carry its device grids
in ``cells``, which nothing there serializes or hashes.

Cell geometry (``das_cell_bytes`` x ``das_cells_per_blob``) comes from the
config: ``validate_das_config`` takes one, the thread's by default, and
``CellRows.deserialize`` reads the thread's.
"""

from __future__ import annotations

import numpy as np

from pos_evolution_tpu_torch.config import cfg
from pos_evolution_tpu_torch.ssz.core import Bytes32, Container, Sedes, uint64
from pos_evolution_tpu_torch.ssz.hash import sha256, sha256_pairs
from pos_evolution_tpu_torch.ssz.merkle import merkleize_chunks, mix_in_length

__all__ = [
    "MAX_EXTENDED_CELLS",
    "CellRows",
    "BlobSidecar",
    "das_graffiti",
    "parse_das_graffiti",
    "commitments_digest",
    "validate_das_config",
]


def validate_das_config(c=None) -> None:
    """Loud checks for the DAS geometry constraints the documentation
    promises (config.py): silently violating any of these produces
    structurally wrong roots or colliding blob payloads, not crashes."""
    c = c or cfg()
    k = int(c.das_cells_per_blob)
    if not (1 <= k <= MAX_EXTENDED_CELLS // 2) or (k & (k - 1)):
        raise ValueError(
            f"das_cells_per_blob must be a power of two in "
            f"[1, {MAX_EXTENDED_CELLS // 2}] (2k GF(2^8) evaluation "
            f"points, padded binary commitment tree), got {k}")
    chunks = max((int(c.das_cell_bytes) + 31) // 32, 1)
    if chunks & (chunks - 1):
        raise ValueError(
            f"das_cell_bytes={c.das_cell_bytes} pads to {chunks} 32-byte "
            f"chunks per cell — must be a power of two (the per-cell "
            f"merkle sweep pairs rows level by level)")
    if not (0 <= int(c.das_max_blobs_per_block) <= 255):
        raise ValueError(
            f"das_max_blobs_per_block must be in [0, 255] (blob_index is "
            f"one seed byte), got {c.das_max_blobs_per_block}")
    if int(c.das_samples_per_client) < 1:
        raise ValueError("das_samples_per_client must be >= 1")

#: SSZ list limit for the extended grid (2k <= 256 by the GF(2^8) bound).
MAX_EXTENDED_CELLS = 256

#: graffiti marker prefix for blocks that carry DAS blobs
_DAS_MAGIC = b"DAS\x01"


class CellRows(Sedes):
    """``List[ByteVector[cell_bytes], MAX_EXTENDED_CELLS]`` stored as an
    (n_cells, cell_bytes) uint8 array. The runtime array carries both its
    cell count and cell width (``cfg().das_cell_bytes`` resolves the width
    on deserialize), mirroring the ``Bytes32Rows`` preset-sharing rule."""

    def is_fixed(self):
        return False

    def serialize(self, value) -> bytes:
        return np.ascontiguousarray(value, dtype=np.uint8).tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        width = cfg().das_cell_bytes
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, width).copy()

    def htr(self, value) -> bytes:
        arr = np.ascontiguousarray(value, dtype=np.uint8)
        n = arr.shape[0]
        if n == 0:
            chunks = np.empty((0, 32), dtype=np.uint8)
            cell_roots = chunks
        else:
            width = arr.shape[1]
            chunks_per_cell = max((width + 31) // 32, 1)
            if chunks_per_cell & (chunks_per_cell - 1):
                raise ValueError(
                    f"cell width {width} pads to {chunks_per_cell} chunks "
                    f"per cell — the level sweep needs a power of two")
            padded = np.zeros((n, chunks_per_cell * 32), dtype=np.uint8)
            padded[:, :width] = arr
            # per-cell root: merkleize each cell's chunk run (all cells
            # share one geometry, so the level sweeps batch across cells)
            layer = padded.reshape(n * chunks_per_cell, 32)
            m = chunks_per_cell
            while m > 1:
                layer = sha256_pairs(layer[0::2], layer[1::2])
                m //= 2
            cell_roots = layer
        root = merkleize_chunks(cell_roots, MAX_EXTENDED_CELLS)
        return mix_in_length(root, n)

    def default(self) -> np.ndarray:
        return np.zeros((0, cfg().das_cell_bytes), dtype=np.uint8)


class BlobSidecar(Container):
    """One blob's worth of availability data, gossiped alongside its block.

    ``cells`` is the full extended grid; ``commitment`` is the pluggable
    cell-commitment root (``das/commitment.py``) the block's graffiti
    marker binds. ``n_blobs`` repeats the block's blob count so a store
    holding ANY sidecar knows how many siblings availability needs.
    """

    slot: uint64
    proposer_index: uint64
    block_root: Bytes32
    blob_index: uint64
    n_blobs: uint64
    cells: CellRows()
    commitment: Bytes32


def das_graffiti(commitments: list[bytes]) -> bytes:
    """32-byte graffiti marker binding a block to its blob commitments:
    magic(4) | n_blobs(2, LE) | sha256(commitment list)[:26]. Set at block
    build time, so the proposal SSZ-commits to its blob payload through a
    field every fork already carries."""
    n = len(commitments)
    if n == 0:
        return b"\x00" * 32
    digest = sha256(b"".join(bytes(c) for c in commitments))
    return _DAS_MAGIC + n.to_bytes(2, "little") + digest[:26]


def parse_das_graffiti(graffiti: bytes) -> tuple[int, bytes] | None:
    """``(n_blobs, commitment_digest26)`` when ``graffiti`` carries the DAS
    marker, else None (a block with no blob payload, or a free-form
    graffiti from a non-DAS proposer — both gate vacuously)."""
    g = bytes(graffiti)
    if not g.startswith(_DAS_MAGIC):
        return None
    n = int.from_bytes(g[4:6], "little")
    return (n, g[6:32]) if n else None


def commitments_digest(commitments: list[bytes]) -> bytes:
    """The 26-byte digest ``das_graffiti`` embeds, for availability checks."""
    return sha256(b"".join(bytes(c) for c in commitments))[:26]
