"""Cell-commitment schemes for the DAS grid (port of the merkle scheme of
``pos_evolution_tpu/das/commitment.py``).

``MerkleCellScheme`` commits to a blob's extended grid by a binary merkle
tree over the per-cell SHA-256 leaves: the leaves by kernel K6
(``ops/sha256.sha256_rows``), every tree level by kernel K2
(``ops/merkle_device``), on the scheme's device. ``commit_batch`` commits
to G equal-geometry grids at once, one K6 launch for all their cells and
one K2 launch a level; ``commit`` is its one-grid case.

The pairing-based scheme (``get_scheme("kzg")``) waits for ROADMAP
Queue 1 item 5b.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops.merkle_device import _paths_from_levels, pair_hash
from pos_evolution_tpu_torch.ops.sha256 import sha256_rows
from pos_evolution_tpu_torch.ssz.merkle import _tree_levels

__all__ = ["MerkleCellScheme", "get_scheme"]


class MerkleCellScheme:
    """SHA-256 merkle commitment over per-cell leaves, on ``device`` (CUDA
    unless the caller asks for another); ``plain=True`` takes the plain
    versions of K2 and K6."""

    name = "merkle"

    def __init__(self, device="cuda", *, plain: bool = False):
        self.device = resolve_device(device)
        self.plain = bool(plain)

    @staticmethod
    def depth_for(n_cells: int) -> int:
        return max(int(n_cells - 1).bit_length(), 0)

    def cell_leaves(self, cells) -> torch.Tensor:
        """(n, 32) uint8 leaf rows of a grid (numpy or tensor), on the device."""
        if not isinstance(cells, torch.Tensor):
            cells = np.ascontiguousarray(cells, dtype=np.uint8)
        return sha256_rows(cells, self.device, plain=self.plain)

    def commit(self, cells) -> bytes:
        """32-byte commitment to one grid of a power-of-two cell count (as
        ``das/containers.validate_das_config`` makes every grid):
        ``commit_batch`` of the one grid."""
        grid = torch.as_tensor(np.ascontiguousarray(cells, dtype=np.uint8)) \
            if not isinstance(cells, torch.Tensor) else cells
        root = self.commit_batch(grid.to(self.device)[None])
        return words_to_rows(root).cpu().numpy().tobytes()

    def commit_batch(self, grids: torch.Tensor) -> torch.Tensor:
        """Roots of G grids of n cells, n a power of two: (G, n, W) uint8
        -> (G, 8) int32 words on the grids' device."""
        g, n, w = grids.shape
        if n & (n - 1) or not n:
            raise ValueError(f"commit_batch needs a power-of-two cell count, got {n}")
        layer = rows_to_words(self.cell_leaves(grids.reshape(g * n, w)))
        # n is even at every level above the root, so no pair straddles two grids
        while layer.shape[0] > g:
            layer = pair_hash(layer[0::2], layer[1::2], plain=self.plain)
        return layer

    def branches(self, cells, indices) -> tuple[np.ndarray, np.ndarray]:
        """(leaves[indices] (S, 32), branches (S, depth, 32)) uint8 for the
        batched sample verification: one tree build, then the sibling gather."""
        leaves = rows_to_words(self.cell_leaves(cells))
        depth = self.depth_for(leaves.shape[0])
        levels = _tree_levels(leaves, depth, combine=partial(pair_hash, plain=self.plain))
        picked, branches = _paths_from_levels(levels, indices, depth)
        s = picked.shape[0]
        return (words_to_rows(picked).cpu().numpy(),
                words_to_rows(branches.reshape(-1, 8)).reshape(s, -1, 32).cpu().numpy())


def get_scheme(name: str = "merkle", device="cuda", *, plain: bool = False) -> MerkleCellScheme:
    if name == "merkle":
        return MerkleCellScheme(device, plain=plain)
    if name == "kzg":
        raise ValueError("the kzg cell-commitment scheme is not ported yet "
                         "(ROADMAP Queue 1 item 5b)")
    raise ValueError(f"unknown cell-commitment scheme {name!r}; registered: ['merkle']")
