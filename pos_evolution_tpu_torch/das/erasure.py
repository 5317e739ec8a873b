"""Reed-Solomon erasure coding over GF(2^8) for DAS blobs (the port's copy
of ``pos_evolution_tpu/das/erasure.py``, held equal to it by a test).

A blob's k data cells are, byte column by byte column, evaluations of a
degree-<k polynomial at points 0..k-1; the extension evaluates it at
k..2k-1, so any k of the 2k extended cells reconstruct the blob. The
arithmetic is table-driven (AES polynomial 0x11B, generator 0x03):
products are log/exp lookups, sums are XOR. These host numpy functions are
the oracle of the device path, kernel K7 (``ops/das_verify.gf_matmul``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "GF_EXP", "GF_LOG", "gf_mul", "gf_inv", "gf_matmul",
    "lagrange_matrix", "extension_matrix", "extend_blob",
    "reconstruct_blob",
]


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by the generator 0x03 = x * (0x02 ^ 0x01); note 0x02 is
        # NOT a generator of GF(256)^* under 0x11B (order 51) — using it
        # silently corrupts most log entries
        x = (x << 1) ^ x
        if x & 0x100:
            x ^= 0x11B  # AES reduction polynomial x^8+x^4+x^3+x+1
    exp[255:] = exp[:255]  # wrap so log[a]+log[b] never needs a mod
    return exp.astype(np.uint8), log.astype(np.int32)


# GF_EXP[(GF_LOG[a] + GF_LOG[b])] == a*b for a, b != 0.
GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) matrix product: (r, k) u8 x (k, c) u8 -> (r, c) u8.

    One log/exp gather + XOR accumulate per inner index — k is the blob's
    cell count (small), r*c the byte volume (vectorized).
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    log_a = GF_LOG[a]  # (r, k)
    log_b = GF_LOG[b]  # (k, c)
    for t in range(a.shape[1]):
        prod = GF_EXP[log_a[:, t][:, None] + log_b[t][None, :]]
        prod = np.where((a[:, t][:, None] == 0) | (b[t][None, :] == 0),
                        np.uint8(0), prod)
        out ^= prod
    return out


@lru_cache(maxsize=None)
def lagrange_matrix(xs_src: tuple, xs_dst: tuple) -> np.ndarray:
    """M with ``gf_matmul(M, values_at_src) = values_at_dst`` for any
    degree-<len(xs_src) polynomial: M[i, t] is the t-th Lagrange basis
    over ``xs_src`` evaluated at ``xs_dst[i]`` (GF addition is XOR)."""
    k = len(xs_src)
    m = np.zeros((len(xs_dst), k), dtype=np.uint8)
    for t in range(k):
        denom = 1
        for s in range(k):
            if s != t:
                denom = gf_mul(denom, xs_src[t] ^ xs_src[s])
        dinv = gf_inv(denom)
        for i, x in enumerate(xs_dst):
            num = 1
            for s in range(k):
                if s != t:
                    num = gf_mul(num, x ^ xs_src[s])
            m[i, t] = gf_mul(num, dinv)
    return m


def extension_matrix(k: int) -> np.ndarray:
    """(k, k) matrix mapping the k data cells to the k parity cells
    (evaluations at points k..2k-1)."""
    if not 1 <= k <= 128:
        raise ValueError(f"das_cells_per_blob must be in [1, 128], got {k}")
    return lagrange_matrix(tuple(range(k)), tuple(range(k, 2 * k)))


def extend_blob(data_cells: np.ndarray) -> np.ndarray:
    """(k, cell_bytes) data cells -> (2k, cell_bytes) extended grid whose
    first k rows ARE the data (systematic code)."""
    data_cells = np.ascontiguousarray(data_cells, dtype=np.uint8)
    k = data_cells.shape[0]
    parity = gf_matmul(extension_matrix(k), data_cells)
    return np.concatenate([data_cells, parity], axis=0)


def reconstruct_blob(cells: np.ndarray, present: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Recover a blob from any >=50% of its extended cells.

    ``cells`` is the (2k, cell_bytes) grid with arbitrary garbage in the
    missing rows; ``present`` marks which rows are trusted. Interpolates
    the data cells from the first k present rows, re-extends, and checks
    every present row against the re-extension — the consistency verdict
    is False when any present cell disagrees with the unique degree-<k
    polynomial through the selection (a corrupted cell cannot hide).

    Returns ``(data_cells, full_grid, ok)``.
    """
    cells = np.ascontiguousarray(cells, dtype=np.uint8)
    present = np.asarray(present, dtype=bool)
    k = cells.shape[0] // 2
    avail = np.nonzero(present)[0]
    if avail.size < k:
        raise ValueError(
            f"reconstruction needs >= {k} of {2 * k} cells, got {avail.size}")
    sel = avail[:k]
    interp = lagrange_matrix(tuple(int(x) for x in sel), tuple(range(k)))
    data = gf_matmul(interp, cells[sel])
    full = extend_blob(data)
    ok = bool((full[avail] == cells[avail]).all())
    return data, full, ok
