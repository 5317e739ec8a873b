"""Batched DAS sample verification and the erasure-reconstruction check,
and kernel K7 (port of ``pos_evolution_tpu/ops/das_verify.py``).

A sampling client's unit of work is one (cell, branch, commitment) triple:
hash the cell to its leaf, walk the branch, compare with the blob's
commitment. ``verify_samples_device`` runs a whole batch: the leaves by
kernel K6 (``ops/sha256.sha256_rows``), then the walk of
``ops/sync_verify.merkle_walk`` (one K2 launch a level).
``verify_samples_host`` is the numpy/hashlib oracle: the leaves by
``ssz/hash.sha256_batch``, then ``ops/sync_verify.merkle_roots_host``.

The reconstruction check is the verifier's side of the erasure code:
interpolate the data cells from k of the >= k present cells of the 2k-cell
grid, re-extend, and require every present cell on the polynomial.
``gf_matmul`` is K7's wrapper (``csrc/gf256_matmul.cu``), a batched
GF(2^8) product; ``_gf_matmul`` its plain version. The interpolation and
the re-extension are one product here: the data rows are
``interp * cells[sel]`` and the parity rows ``ext * (interp * cells[sel])
= (ext * interp) * cells[sel]``, so one (2k, k) matrix built on the host
once per selection gives the whole re-extended grid in one launch, the
same bytes as the two products of the JAX package's
``_reconstruct_kernel`` (the field's arithmetic is exact).

The tensor's device decides where the work runs; ``plain=True`` takes the
plain versions of K2, K6 and K7 on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from pos_evolution_tpu_torch.das.erasure import (
    GF_EXP,
    GF_LOG,
    extension_matrix,
    lagrange_matrix,
    reconstruct_blob,
)
from pos_evolution_tpu_torch.das.erasure import gf_matmul as gf_matmul_host
from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.ops.sha256 import sha256_rows
from pos_evolution_tpu_torch.ops.sync_verify import (
    _index_bits,
    _rows_on,
    merkle_roots_host,
    merkle_walk,
)
from pos_evolution_tpu_torch.ssz.hash import sha256_batch

__all__ = [
    "DasSampleBatch",
    "gf_matmul",
    "verify_samples_host",
    "verify_samples_device",
    "reconstruct_check_host",
    "reconstruct_check_device",
    "reconstruct_check_batch",
]


@dataclass
class DasSampleBatch:
    """Dense form of S coalesced samples (array-level only)."""

    cells: np.ndarray        # (S, cell_bytes) u8 — sampled cell payloads
    branches: np.ndarray     # (S, D, 32) u8     — per-sample merkle branches
    indices: np.ndarray      # (S,) i64          — cell index in the grid
    commitments: np.ndarray  # (S, 32) u8        — expected grid commitments

    @property
    def size(self) -> int:
        return self.cells.shape[0]


def _result(ok, roots, leaves) -> dict:
    return {"ok": np.asarray(ok, dtype=bool),
            "roots": np.asarray(roots, dtype=np.uint8),
            "leaves": np.asarray(leaves, dtype=np.uint8)}


# --- sample verification ------------------------------------------------------

def verify_samples_host(batch: DasSampleBatch) -> dict:
    """numpy/hashlib reference path (the oracle the device path must match)."""
    leaves = sha256_batch(np.ascontiguousarray(batch.cells, dtype=np.uint8))
    roots = merkle_roots_host(leaves, batch.branches, batch.indices)
    ok = (roots == np.asarray(batch.commitments, dtype=np.uint8)).all(axis=1)
    return _result(ok, roots, leaves)


def verify_samples_device(batch: DasSampleBatch, device="cuda", *, plain: bool = False) -> dict:
    """The batch on ``device`` (CUDA unless the caller asks for another):
    the leaves by K6, then ``merkle_walk`` (K2) from them."""
    dev = resolve_device(device)
    s, depth = batch.size, batch.branches.shape[1]
    leaves = sha256_rows(np.ascontiguousarray(batch.cells, dtype=np.uint8), dev, plain=plain)
    roots = merkle_walk(rows_to_words(leaves), _rows_on(batch.branches, dev).reshape(s, depth, 8),
                        torch.from_numpy(_index_bits(batch.indices, depth)).to(dev), plain=plain)
    root_rows = words_to_rows(roots).cpu().numpy()
    ok = (root_rows == np.asarray(batch.commitments, dtype=np.uint8)).all(axis=1)
    return _result(ok, root_rows, leaves.cpu().numpy())


# --- kernel K7 and its plain version --------------------------------------------

_LOG_ZERO = 510     # K7's log of 0: every sum with it indexes exp's zero tail


@lru_cache(maxsize=None)
def _gf_tables(device: torch.device) -> torch.Tensor:
    """K7's tables on ``device``: exp (1,024 bytes: ``GF_EXP``, then zeros)
    and log (256 little-endian uint16, log[0] = 510)."""
    exp = np.zeros(1024, dtype=np.uint8)
    exp[:GF_EXP.size] = GF_EXP
    log = GF_LOG.astype("<u2")
    log[0] = _LOG_ZERO
    return torch.from_numpy(np.concatenate([exp, log.view(np.uint8)])).to(device)


def _groups(a, b) -> int:
    """The product's group count: an operand's group axis of 1 broadcasts."""
    return a.shape[0] if b.shape[0] == 1 else b.shape[0]


def _gf_matmul(a, b):
    """Plain version of K7: (G, r, k) uint8 x (G, k, W) uint8 -> (G, r, W)
    uint8, either group axis of size 1 broadcasting; one log/exp lookup and
    an XOR per inner index, as ``_reconstruct_kernel`` does."""
    exp = torch.from_numpy(GF_EXP).to(a.device)
    log = torch.from_numpy(GF_LOG.astype(np.int64)).to(a.device)
    log_a, log_b = log[a.long()], log[b.long()]
    acc = torch.zeros((_groups(a, b), a.shape[1], b.shape[2]), dtype=torch.uint8,
                      device=a.device)
    for t in range(a.shape[2]):
        prod = exp[log_a[:, :, t, None] + log_b[:, None, t, :]]
        zero = (a[:, :, t, None] == 0) | (b[:, None, t, :] == 0)
        acc ^= torch.where(zero, 0, prod)
    return acc


def gf_matmul(a, b, *, plain: bool = False):
    """K7's wrapper: the batched GF(2^8) product (G, r, k) x (G, k, W) ->
    (G, r, W) uint8, either operand's group axis of size 1 broadcasting.
    CUDA tensors: launch ``csrc/gf256_matmul.cu`` on the current stream, or
    raise (1 <= k <= 256). CPU tensors, or ``plain=True`` on any device: the
    plain version. An empty product returns zeros without a launch."""
    dev = a.device
    if a.dim() != 3 or b.dim() != 3 or a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError(f"gf_matmul: operands must be 3-D uint8, got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    g = _groups(a, b)
    (_, r, k), w = a.shape, b.shape[2]
    if b.device != dev or b.shape[1] != k or {a.shape[0], b.shape[0]} - {1, g}:
        raise ValueError(f"gf_matmul: cannot multiply {tuple(a.shape)} on {dev} by "
                         f"{tuple(b.shape)} on {b.device}")
    if plain or dev.type == "cpu":
        return _gf_matmul(a, b)
    if dev.type != "cuda":
        raise ValueError(f"gf_matmul: no kernel for device {dev}")
    if not (g and r and w and k):
        return torch.zeros((g, r, w), dtype=torch.uint8, device=dev)
    if k > 256 or g > 65535 or r > 32 * 65535:
        raise ValueError(f"gf_matmul: k <= 256, G <= 65535, r <= 2,097,120; got k={k}, "
                         f"G={g}, r={r}")
    a = a.contiguous()
    wp = -(-w // 4) * 4     # the kernel reads B in 4-byte words
    b = b.contiguous() if wp == w else torch.nn.functional.pad(b, (0, wp - w))
    if b.data_ptr() % 4:
        b = b.clone()       # an offset view: the kernel loads B in aligned 4-byte words
    out = torch.empty((g, r, wp), dtype=torch.uint8, device=dev)
    kernels.launch_on(dev, "gf256_matmul", _gf_tables(dev).data_ptr(), a.data_ptr(),
                      r * k if a.shape[0] == g else 0, b.data_ptr(),
                      k * wp if b.shape[0] == g else 0, out.data_ptr(), g, r, k, wp)
    return out if wp == w else out[..., :w].contiguous()


# --- erasure-reconstruction check ---------------------------------------------

def reconstruct_check_host(cells: np.ndarray, present: np.ndarray) -> tuple[bool, np.ndarray]:
    """(consistent, data_cells) from any >= 50% of the extended grid."""
    data, _full, ok = reconstruct_blob(cells, present)
    return ok, data


@lru_cache(maxsize=None)
def _regrid_matrix(sel: tuple, k: int) -> np.ndarray:
    """(2k, k) host matrix taking the cells at ``sel`` to the whole
    re-extended grid: the interpolation, then the extension of its rows."""
    interp = lagrange_matrix(sel, tuple(range(k)))
    return np.concatenate([interp, gf_matmul_host(extension_matrix(k), interp)], axis=0)


def _selection(present: np.ndarray, k: int) -> np.ndarray:
    avail = np.nonzero(present)[0]
    if avail.size < k:
        raise ValueError(f"reconstruction needs >= {k} of {2 * k} cells, got {avail.size}")
    return avail[:k]


def reconstruct_check_batch(cells: torch.Tensor, present: np.ndarray, *, plain: bool = False):
    """G blobs at once on ``cells``' device: cells (G, 2k, W) uint8, present
    (G, 2k) bool on the host -> (ok (G,) bool, data (G, k, W) uint8), both on
    the device. One K7 launch re-extends every blob."""
    g, n, _w = cells.shape
    k = n // 2
    present = np.asarray(present, dtype=bool).reshape(g, n)
    sels = [_selection(p, k) for p in present]
    mats = np.stack([_regrid_matrix(tuple(int(x) for x in sel), k) for sel in sels]) \
        if g else np.zeros((0, 2 * k, k), np.uint8)
    dev = cells.device
    sel_t = torch.from_numpy(np.array(sels, dtype=np.int64).reshape(g, k)).to(dev)
    picked = cells[torch.arange(g, device=dev)[:, None], sel_t]
    full = gf_matmul(torch.from_numpy(mats).to(dev), picked, plain=plain)
    mask = torch.from_numpy(present).to(dev)[:, :, None]
    ok = torch.where(mask, full == cells, True).flatten(1).all(dim=1)
    return ok, full[:, :k]


def reconstruct_check_device(cells: np.ndarray, present: np.ndarray, device="cuda", *,
                             plain: bool = False) -> tuple[bool, np.ndarray]:
    """The device twin of ``reconstruct_check_host`` for one blob (the same
    verdict and bytes), through K7 on ``device``."""
    cells_t = torch.from_numpy(np.ascontiguousarray(cells, dtype=np.uint8)).to(
        resolve_device(device))
    ok, data = reconstruct_check_batch(cells_t[None], np.asarray(present, dtype=bool)[None],
                                       plain=plain)
    return bool(ok[0]), data[0].cpu().numpy()
