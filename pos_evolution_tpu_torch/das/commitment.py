"""Pluggable cell-commitment schemes for the DAS grid (port of
``pos_evolution_tpu/das/commitment.py``).

A scheme binds one blob's extended cell grid to a 32-byte commitment and
proves cells, one at a time or in batches, against it
(``CellCommitmentScheme``); ``register_scheme`` files a scheme class by
its ``name`` for ``get_scheme``.

``MerkleCellScheme`` commits to a blob's extended grid by a binary merkle
tree over the per-cell SHA-256 leaves: the leaves by kernel K6
(``ops/sha256.sha256_rows``), every tree level by kernel K2
(``ops/merkle_device``), on the scheme's device. ``commit_batch`` commits
to G equal-geometry grids at once, one K6 launch for all their cells and
one K2 launch a level; ``commit`` is its one-grid case.

``get_scheme("kzg")`` gives the pairing-based ``KzgCellScheme``
(``kzg/scheme.py``): KZG commitments by kernels K10 (the Fr NTT) and K11
(the G1 multi-scalar multiply), with the same ``commit_batch``.

``branch`` and ``prove_cells`` build the tree over the leaves on the
scheme's device as ``commit_batch`` does and hand back host bytes;
``verify_cells`` hashes only the sampled cells (K6) and checks the
multiproof on the host. Its geometry comes from the scheme's ``cfg``, the
thread's config when none was given.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from pos_evolution_tpu_torch.config import cfg as _thread_cfg
from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops.merkle_device import _paths_from_levels, pair_hash
from pos_evolution_tpu_torch.ops.sha256 import sha256_rows
from pos_evolution_tpu_torch.ssz.merkle import (
    _tree_levels,
    build_multiproof,
    merkle_tree_branch,
    verify_multiproof,
)

__all__ = [
    "CellCommitmentScheme",
    "MerkleCellScheme",
    "register_scheme",
    "scheme_class",
    "get_scheme",
]


class CellCommitmentScheme:
    """Contract every scheme implements over an (n_cells, cell_bytes) grid."""

    name = "abstract"
    # capability flag: schemes that fold a whole sampled set into ONE
    # opening proof (kzg/) set this True and additionally implement
    # ``prove_aggregate``/``verify_aggregate``; branch-based schemes
    # leave it False and serve per-cell branches
    aggregates = False

    def cell_leaves(self, cells):
        """(n, 32) leaf values the commitment tree/polynomial is built over."""
        raise NotImplementedError

    def commit(self, cells) -> bytes:
        """32-byte commitment to the full extended grid."""
        raise NotImplementedError

    def branch(self, cells, index: int) -> np.ndarray:
        """(depth, 32) single-cell inclusion proof for ``cells[index]``."""
        raise NotImplementedError

    def prove_cells(self, cells, indices) -> list[bytes]:
        """One aggregated proof for a batch of cell indices."""
        raise NotImplementedError

    def verify_cells(self, commitment: bytes, cells, indices,
                     proof: list[bytes]) -> bool:
        """Check a batch of (index, cell) pairs against ``commitment``."""
        raise NotImplementedError


class MerkleCellScheme(CellCommitmentScheme):
    """SHA-256 merkle commitment over per-cell leaves, on ``device`` (CUDA
    unless the caller asks for another), under config ``cfg`` (the
    thread's when None); ``plain=True`` takes the plain versions of K2
    and K6."""

    name = "merkle"

    def __init__(self, device="cuda", *, plain: bool = False, cfg=None):
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.cfg = cfg

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

    def _leaf_words(self, cells) -> torch.Tensor:
        return rows_to_words(self.cell_leaves(cells))

    def branch(self, cells, index: int) -> np.ndarray:
        leaves = self._leaf_words(cells)
        sibs = merkle_tree_branch(leaves, int(index), self.depth_for(leaves.shape[0]),
                                  combine=partial(pair_hash, plain=self.plain))
        return np.frombuffer(b"".join(sibs), dtype=np.uint8).reshape(-1, 32)

    def prove_cells(self, cells, indices) -> list[bytes]:
        leaves = self._leaf_words(cells)
        return build_multiproof(leaves, [int(i) for i in indices],
                                self.depth_for(leaves.shape[0]),
                                combine=partial(pair_hash, plain=self.plain))

    def verify_cells(self, commitment: bytes, cells, indices, proof: list[bytes]) -> bool:
        # hash only the sampled cells: the verifier never sees the grid
        leaves = self.cell_leaves(cells).cpu().numpy()
        n_cells = 2 * (self.cfg or _thread_cfg()).das_cells_per_blob
        return verify_multiproof([leaves[j].tobytes() for j in range(leaves.shape[0])],
                                 [int(i) for i in indices], proof,
                                 self.depth_for(n_cells), commitment)


_SCHEMES: dict[str, type] = {}


def register_scheme(cls) -> type:
    """Register a ``CellCommitmentScheme`` subclass by its ``name``; it is
    built as ``cls(device, plain=, cfg=)``."""
    _SCHEMES[cls.name] = cls
    return cls


def scheme_class(name: str) -> type:
    """The class registered as ``name``, with nothing built (its class
    flags, such as ``aggregates``, read without a device)."""
    if name not in _SCHEMES:
        # the kzg package loads its field and curve constants when asked for
        import pos_evolution_tpu_torch.kzg.scheme  # noqa: F401
    if name not in _SCHEMES:
        raise ValueError(f"unknown cell-commitment scheme {name!r}; "
                         f"registered: {list(_SCHEMES)}")
    return _SCHEMES[name]


def get_scheme(name: str = "merkle", device="cuda", *, plain: bool = False, cfg=None):
    """The scheme registered as ``name`` on ``device``, under config ``cfg``
    (the kzg scheme's geometry and setup seed: mainnet's when None)."""
    return scheme_class(name)(device, plain=plain, cfg=cfg)


register_scheme(MerkleCellScheme)
