"""``KzgCellScheme``: pairing-backed cell commitments behind the DAS seam
(port of ``pos_evolution_tpu/kzg/scheme.py``).

A blob's extended grid (n_cells x cell_bytes) is a polynomial: every
16-byte column chunk packs little-endian into one Fr element (< 2^128 <
r), cell i's chunk j sitting at domain index i + n_cells*j of the size
N = n_cells*m evaluation domain, so each cell is the restriction of f to
one size-m coset and the committee aggregate of ``kzg/aggregate.py``
applies directly. The geometry, the wire binding, the memo and the proof
encoding are the JAX package's.

``commit_batch`` commits G grids on the scheme's device (CUDA unless the
caller asks for another): the chunks become Fr digits on the card, one
K10 launch takes them to Montgomery form, one K10 INTT (two passes in
shared memory at the PeerDAS domain) over all G blobs gives the
coefficients, one K10 launch their canonical digits, and K11's bucket MSM
over the setup's window tables (six launches) the commitments; 96 bytes a blob come back to the host
for ``g1_compress`` and the SHA-256 wire binding. The coefficients stay on
the card; ``commit_full`` decodes them for the prover when asked.
``plain=True`` takes the plain versions of the kernels.

Wire format: sidecar commitments are SSZ ``Bytes32``, a KZG commitment a
48-byte G1 point, so the 32-byte wire commitment is
``sha256(tag || compressed_point)``; aggregate proofs ship the real
points and every verifier checks the hash binding before the pairing.

The memo is keyed, as in JAX, on the grid's SHA-256: a view's recommit
of an honest sidecar is a hit, a corrupted grid misses, recomputes and is
rejected.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from pos_evolution_tpu_torch.config import mainnet_config
from pos_evolution_tpu_torch.crypto.bls12_381 import g1_compress
from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.kzg import aggregate, fr, ntt
from pos_evolution_tpu_torch.kzg.setup import device_setup
from pos_evolution_tpu_torch.ops import fp, pairing

__all__ = ["KzgCellScheme", "CHUNK_BYTES"]

# bytes per Fr element: 16 < 31 keeps every chunk canonically < r AND
# the domain small (N = n_cells * cell_bytes/16)
CHUNK_BYTES = 16

_WIRE_TAG = b"pev-kzg-wire-v1"


class _Commitment:
    """A memo entry: the affine point, its 48-byte compression, the wire
    commitment, and the coefficients' canonical digits [N, 22] on the
    device, decoded to ints at the first ``coeffs`` read."""

    __slots__ = ("point", "comp", "wire", "digits", "_coeffs")

    def __init__(self, point, comp: bytes, wire: bytes, digits: torch.Tensor):
        self.point, self.comp, self.wire, self.digits = point, comp, wire, digits
        self._coeffs = None

    @property
    def coeffs(self) -> tuple:
        if self._coeffs is None:
            self._coeffs = tuple(fr.digits_to_ints(self.digits))
        return self._coeffs


class KzgCellScheme:
    """KZG commitments and aggregated multiproofs for the DAS cell grid,
    under config ``cfg`` (mainnet's by default), on ``device``."""

    name = "kzg"
    # capability flag: a server serves ONE aggregate proof per (block,
    # sampled set) instead of per-cell merkle branches
    aggregates = True

    def __init__(self, device="cuda", *, plain: bool = False, cfg=None):
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.cfg = mainnet_config() if cfg is None else cfg
        # commit memo: (n_cells, m, grid digest) -> _Commitment; locked, as
        # the JAX package's, for callers on several threads
        self._memo: OrderedDict = OrderedDict()
        self._memo_lock = threading.Lock()
        self._memo_cap = 256

    # -- geometry --------------------------------------------------------------

    def geometry(self) -> tuple[int, int, int]:
        """(n_cells, m, N) for the config; loud on bad shapes."""
        c = self.cfg
        n_cells = 2 * c.das_cells_per_blob
        if c.das_cell_bytes % CHUNK_BYTES:
            raise ValueError("das_cell_bytes must be a multiple of "
                             f"{CHUNK_BYTES} for the kzg scheme")
        m = c.das_cell_bytes // CHUNK_BYTES
        if m & (m - 1) or n_cells & (n_cells - 1):
            raise ValueError("kzg scheme needs power-of-two cell count "
                             "and chunks per cell")
        return n_cells, m, n_cells * m

    @staticmethod
    def depth_for(n_cells: int) -> int:
        return 0            # no branch walk: proofs are aggregates

    def setup(self):
        return device_setup(self.geometry()[2], self.cfg.kzg_setup_seed, self.device,
                            plain=self.plain)

    # -- wire binding ----------------------------------------------------------

    @staticmethod
    def wire_bind(compressed_point: bytes) -> bytes:
        """48-byte G1 point -> the 32-byte wire commitment the sidecar
        container / graffiti digest carry."""
        return hashlib.sha256(_WIRE_TAG + bytes(compressed_point)).digest()

    @staticmethod
    def cell_values(cell) -> tuple:
        """One cell row (cell_bytes,) u8 -> its m Fr evaluations."""
        raw = np.ascontiguousarray(np.asarray(cell), dtype=np.uint8).tobytes()
        return tuple(int.from_bytes(raw[o:o + CHUNK_BYTES], "little")
                     for o in range(0, len(raw), CHUNK_BYTES))

    # -- commit ----------------------------------------------------------------

    def _evaluations(self, grids: torch.Tensor) -> torch.Tensor:
        """(G, n_cells, W) uint8 grids -> [G, N, 22] canonical Fr digits of
        their evaluations, domain index i + n_cells*j for chunk j of cell i,
        on the grids' device (each 16-byte chunk is 11 digits, the rest 0)."""
        g, n_cells, width = grids.shape
        m = width // CHUNK_BYTES
        chunks = grids.reshape(g, n_cells, m, CHUNK_BYTES).transpose(1, 2)
        b = chunks.reshape(g, n_cells * m, CHUNK_BYTES).to(torch.int32)
        b = torch.nn.functional.pad(b, (0, 2)).reshape(g, n_cells * m, 6, 3)
        limbs = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)          # 24-bit
        digits = torch.stack([limbs & fr.MASK, limbs >> fr.BITS], dim=-1)
        digits = digits.reshape(g, n_cells * m, 12)[..., :11]
        return torch.nn.functional.pad(digits, (0, fr.L - 11)).contiguous()

    def _commit_device(self, grids: torch.Tensor):
        """(points affine [G, 2, 32], inf [G], coefficient digits [G, N, 22])
        of G grids on the device: K10 to Montgomery form, the INTT and the
        canonical pass; K11's bucket MSM over the setup's window tables."""
        setup = self.setup()
        with fp.plain_mode(self.plain):
            evals = fr.to_mont(self._evaluations(grids))
            coeffs = fr.from_mont(ntt.intt(evals))
        aff, inf = pairing.g1_msm_fixed(setup.window_tables(plain=self.plain), coeffs,
                                        plain=self.plain)
        return aff, inf, coeffs

    def _check_grids(self, grids: torch.Tensor) -> None:
        n_cells, _m, _n = self.geometry()
        want = (n_cells, self.cfg.das_cell_bytes)
        if grids.dim() != 3 or tuple(grids.shape[1:]) != want or grids.dtype != torch.uint8:
            raise ValueError(f"grids {grids.dtype} {tuple(grids.shape)} do not match the das "
                             f"config (G, {want[0]}, {want[1]}) uint8")

    def commit_entries(self, grids: torch.Tensor) -> list[_Commitment]:
        """The memo entries of G grids (G, n_cells, W) uint8, the misses
        computed together in one batch on the device."""
        self._check_grids(grids)
        n_cells, m, _n = self.geometry()
        host = np.ascontiguousarray(grids.cpu().numpy())
        keys = [(n_cells, m, hashlib.sha256(g.tobytes()).digest()) for g in host]
        out: list = [None] * len(keys)
        with self._memo_lock:
            for i, key in enumerate(keys):
                hit = self._memo.get(key)
                if hit is not None:
                    self._memo.move_to_end(key)
                    out[i] = hit
        miss = [i for i, e in enumerate(out) if e is None]
        fresh: dict = {}
        for i in miss:                          # a grid twice in one batch: once
            fresh.setdefault(keys[i], i)
        if fresh:
            idx = list(fresh.values())
            batch = torch.from_numpy(host[idx]).to(self.device)
            aff, inf, coeffs = self._commit_device(batch)
            points = pairing.g1_decode_points(aff, inf)
            with self._memo_lock:
                for j, (key, point) in enumerate(zip(fresh, points)):
                    comp = g1_compress(point)
                    self._memo[key] = _Commitment(point, comp, self.wire_bind(comp), coeffs[j])
                    self._memo.move_to_end(key)
                entries = {key: self._memo[key] for key in fresh}
                while len(self._memo) > self._memo_cap:
                    self._memo.popitem(last=False)
            for i in miss:
                out[i] = entries[keys[i]]
        return out

    def commit_batch(self, grids: torch.Tensor) -> torch.Tensor:
        """Wire commitments of G grids: (G, n_cells, W) uint8 -> (G, 8) int32
        words on the grids' device, as ``MerkleCellScheme.commit_batch``
        returns its roots."""
        wires = b"".join(e.wire for e in self.commit_entries(grids))
        rows = torch.from_numpy(np.frombuffer(wires, dtype=np.uint8).reshape(-1, 32).copy())
        return rows_to_words(rows.to(grids.device))

    def commit_full(self, cells):
        """(point, compressed, coeffs, wire_commitment) for one grid,
        memoized by content digest."""
        grid = cells if isinstance(cells, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(cells, dtype=np.uint8))
        e = self.commit_entries(grid[None])[0]
        return e.point, e.comp, e.coeffs, e.wire

    def commit(self, cells) -> bytes:
        grid = cells if isinstance(cells, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(cells, dtype=np.uint8))
        return words_to_rows(self.commit_batch(grid[None])).cpu().numpy().tobytes()

    # -- single-blob proofs ------------------------------------------------------

    def prove_cells(self, cells, indices) -> list[bytes]:
        """Aggregate proof for a batch of this one blob's cells, encoded as
        an opaque list[bytes]."""
        point, _comp, coeffs, wire = self.commit_full(cells)
        n_cells, m, _n = self.geometry()
        grid = np.asarray(cells)
        claims = [(0, int(i), self.cell_values(grid[int(i)])) for i in indices]
        proof = aggregate.prove(self.setup(), n_cells, m, [(wire, point, list(coeffs))], claims,
                                plain=self.plain)
        return self.encode_proof(proof)

    def verify_cells(self, commitment: bytes, cells, indices, proof: list[bytes]) -> bool:
        """Check sampled cells of one blob against its 32-byte wire
        commitment via the aggregate pairing equation."""
        n_cells, m, _n = self.geometry()
        try:
            decoded = self.decode_proof(proof)
        except (ValueError, IndexError):
            return False
        claims = [(0, int(i), self.cell_values(cells[j])) for j, i in enumerate(indices)]
        return aggregate.verify(self.setup(), n_cells, m, [bytes(commitment)], claims, decoded,
                                self.wire_bind, plain=self.plain)

    # -- committee aggregates ----------------------------------------------------

    def prove_aggregate(self, grids, samples) -> dict:
        """One proof for everything a committee sampled from one block.
        grids: per-blob cell grids; samples: [(blob, cell), ...]."""
        n_cells, m, _n = self.geometry()
        blobs = []
        for grid in grids:
            point, _comp, coeffs, wire = self.commit_full(grid)
            blobs.append((wire, point, list(coeffs)))
        claims = [(int(b), int(c), self.cell_values(np.asarray(grids[int(b)])[int(c)]))
                  for b, c in samples]
        return aggregate.prove(self.setup(), n_cells, m, blobs, claims, plain=self.plain)

    def verify_aggregate(self, wire_commitments, samples, cells, proof: dict) -> bool:
        """Committee-side check: sampled cell bytes + per-blob wire
        commitments + the (points, W, W') proof -> one pairing verdict."""
        n_cells, m, _n = self.geometry()
        claims = [(int(b), int(c), self.cell_values(np.asarray(cells[j])))
                  for j, (b, c) in enumerate(samples)]
        return aggregate.verify(self.setup(), n_cells, m, [bytes(wc) for wc in wire_commitments],
                                claims, proof, self.wire_bind, plain=self.plain)

    # -- proof wire encoding -----------------------------------------------------

    @staticmethod
    def encode_proof(proof: dict) -> list[bytes]:
        return ([aggregate.PROOF_TAG]
                + [bytes(p) for p in proof["points"]]
                + [bytes(proof["w"]), bytes(proof["wp"])])

    @staticmethod
    def decode_proof(parts: list[bytes]) -> dict:
        parts = [bytes(p) for p in parts]
        if len(parts) < 4 or parts[0] != aggregate.PROOF_TAG:
            raise ValueError("malformed kzg aggregate proof")
        return {"points": parts[1:-2], "w": parts[-2], "wp": parts[-1]}

    @staticmethod
    def proof_n_bytes(proof: dict) -> int:
        return aggregate.proof_n_bytes(proof)
