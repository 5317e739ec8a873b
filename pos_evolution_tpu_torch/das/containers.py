"""DAS sidecars and the block's blob marker (the port's copy of what the
dense rider uses from ``pos_evolution_tpu/das/containers.py``).

A proposal's blob payload travels as per-blob ``BlobSidecar`` objects, each
carrying the full 2k-cell extended grid. The block commits to its blobs
through its 32-byte graffiti: a DAS marker binding the blob count and the
commitment set (``das_graffiti`` / ``parse_das_graffiti``).

The SSZ forms of the JAX package (``CellRows`` and ``BlobSidecar`` as a
``Container``) need its SSZ core, which the port has not copied yet;
here ``BlobSidecar`` is a plain dataclass with the same fields, and its
``cells`` may be a numpy array or a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pos_evolution_tpu_torch.ssz.hash import sha256

__all__ = [
    "MAX_EXTENDED_CELLS",
    "BlobSidecar",
    "das_graffiti",
    "parse_das_graffiti",
    "commitments_digest",
    "validate_das_config",
]

#: SSZ list limit for the extended grid (2k <= 256 by the GF(2^8) bound).
MAX_EXTENDED_CELLS = 256

#: graffiti marker prefix for blocks that carry DAS blobs
_DAS_MAGIC = b"DAS\x01"


def validate_das_config(c) -> None:
    """Loud checks of the DAS geometry of config ``c``: violating any of
    them gives structurally wrong roots or colliding blob payloads, not
    crashes."""
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


@dataclass
class BlobSidecar:
    """One blob's availability data: the full extended grid ``cells``
    (2k, cell_bytes) and its cell-commitment root. ``n_blobs`` repeats the
    block's blob count."""

    slot: int
    proposer_index: int
    block_root: bytes
    blob_index: int
    n_blobs: int
    cells: Any
    commitment: bytes


def das_graffiti(commitments: list[bytes]) -> bytes:
    """32-byte graffiti marker binding a block to its blob commitments:
    magic(4) | n_blobs(2, LE) | sha256(commitment list)[:26]."""
    n = len(commitments)
    if n == 0:
        return b"\x00" * 32
    digest = sha256(b"".join(bytes(c) for c in commitments))
    return _DAS_MAGIC + n.to_bytes(2, "little") + digest[:26]


def parse_das_graffiti(graffiti: bytes) -> tuple[int, bytes] | None:
    """``(n_blobs, commitment_digest26)`` when ``graffiti`` carries the DAS
    marker, else None (no blob payload: the availability gate passes)."""
    g = bytes(graffiti)
    if not g.startswith(_DAS_MAGIC):
        return None
    n = int.from_bytes(g[4:6], "little")
    return (n, g[6:32]) if n else None


def commitments_digest(commitments: list[bytes]) -> bytes:
    """The 26-byte digest ``das_graffiti`` embeds, for availability checks."""
    return sha256(b"".join(bytes(c) for c in commitments))[:26]
