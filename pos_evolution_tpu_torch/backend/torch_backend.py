"""The port's ExecutionBackend: one object with an explicit device that
serves the spec layer's device calls (the counterpart of
``pos_evolution_tpu/backend/jax_backend.py``).

Each call runs the port's own code on ``device``: the shuffle
(``ops/shuffle``), the epoch sweep and the churn (``ops/epoch``), the
block sweep (``ops/transition``, Queue 2 B8), the merkle entries (kernel
K2), sync and DAS verification (K1, K2, K6, K7), the Fr NTT (K10) and the
G1 MSM (K11); on a CPU device their plain PyTorch versions. Results come
back as host numpy where the JAX backend returns numpy. No call checks a
backend name, and none falls back to the host when the device is CUDA:
the one sized choice, ``das_verify``'s, keeps batches under the crossover
(``ops/merkle_device.small_batch_floor``) on the host path the JAX
backend also keeps them on. ``subtree_weights`` is the JAX backend's host
loop. The JAX backend's sharded mode is ROADMAP Queue 1 item 3 and
raises here.
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows

__all__ = ["TorchBackend"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"TorchBackend: {what} is not ported yet (ROADMAP Queue 1 item 3, the multi-GPU mode)")


class TorchBackend:
    """The spec layer's device seam on ``device`` (CUDA unless the caller
    asks for another; raises without it). ``accelerated_epoch`` routes
    ``specs/epoch.process_epoch`` through ``epoch_sweep``."""

    accelerated_epoch = True

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # the spec memoizes permutations by this name: one entry a device
        self.name = f"torch:{self.device.type}"
        self.epoch_sweeps = 0      # epoch boundaries this object has swept

    def __repr__(self):
        return f"TorchBackend(device={str(self.device)!r})"

    def _t(self, a) -> torch.Tensor:
        """A host array on this backend's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # --- sharded mode (item 3) ----------------------------------------------------

    def enable_sharded(self, *args, **kwargs):
        raise _not_ported("the sharded mode")

    # --- registry-wide reductions -------------------------------------------------

    def shuffle_permutation(self, seed: bytes, n: int, rounds: int) -> np.ndarray:
        """p[i] = compute_shuffled_index(i, n, seed) as uint64; the
        identity at ``rounds=0``."""
        from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation
        return shuffle_permutation(bytes(seed), int(n), int(rounds), self.device) \
            .cpu().numpy().astype(np.uint64)

    def committee_weight_sums(self, effective_balance: np.ndarray,
                              masks: np.ndarray) -> np.ndarray:
        """Effective balance summed under each mask row, uint64 (the numpy
        backend's dtype; the JAX backend's promotes to float64)."""
        eff = self._t(np.asarray(effective_balance).astype(np.int64))
        m = self._t(np.asarray(masks, dtype=bool))
        return torch.where(m, eff, 0).sum(dim=-1).cpu().numpy().astype(np.uint64)

    def segment_sum(self, values: np.ndarray, segment_ids: np.ndarray,
                    num_segments: int) -> np.ndarray:
        vals = np.asarray(values)
        out_dtype = vals.dtype
        work = vals.astype(np.int64) if vals.dtype == np.uint64 else vals
        v = self._t(work)
        out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=self.device)
        out.index_add_(0, self._t(np.asarray(segment_ids, dtype=np.int64)), v)
        return out.cpu().numpy().astype(out_dtype)

    def subtree_weights(self, parent: np.ndarray, node_weight: np.ndarray) -> np.ndarray:
        """Each node's weight folded into its ancestors (``parent[i] < i``):
        the JAX backend's host reverse sweep."""
        w = node_weight.astype(np.int64).copy()
        for i in range(len(w) - 1, 0, -1):
            p = parent[i]
            if p >= 0:
                w[p] += w[i]
        return w

    def variant_tally(self, block_idx, vote_slot, weight, active, lo_slot, hi_slot,
                      n_blocks):
        """Per-block weight of the active votes in ``[lo_slot, hi_slot]``
        (``ops/variant_tally.windowed_vote_tally_device`` on this device)."""
        from pos_evolution_tpu_torch.ops.variant_tally import windowed_vote_tally_device
        return windowed_vote_tally_device(block_idx, vote_slot, weight, active, lo_slot,
                                          hi_slot, n_blocks, self.device)

    def link_tally(self, link_idx, weight, active, n_links):
        """Per-link weight of the active votes
        (``ops/variant_tally.link_tally_device`` on this device)."""
        from pos_evolution_tpu_torch.ops.variant_tally import link_tally_device
        return link_tally_device(link_idx, weight, active, n_links, self.device)

    # --- the state transition -----------------------------------------------------

    def epoch_sweep(self, state, cfg, dense=None):
        """The epoch boundary's sweep over a spec ``BeaconState`` on the
        device (``ops/epoch.process_epoch_dense``): an ``EpochResult`` of
        host numpy, one device-to-host copy a column, for
        ``specs/epoch.py``'s write-back. ``dense`` is the staged registry
        when the caller has one (the churn reads it too)."""
        from pos_evolution_tpu_torch.ops.epoch import (
            EpochResult,
            _host,
            densify,
            process_epoch_dense,
        )
        from pos_evolution_tpu_torch.specs.helpers import get_current_epoch
        if dense is None:
            dense = densify(state, self.device)
        self.epoch_sweeps += 1
        out = process_epoch_dense(
            dense, get_current_epoch(state), int(state.finalized_checkpoint.epoch),
            np.asarray(state.justification_bits, dtype=bool),
            int(state.previous_justified_checkpoint.epoch),
            int(state.current_justified_checkpoint.epoch),
            int(state.slashings.sum()), cfg)
        return EpochResult(registry=type(out.registry)(*(_host(c) for c in out.registry)),
                           **{f: _host(getattr(out, f)) for f in EpochResult._fields[1:]})

    def block_sweep(self, state, rows) -> None:
        """One block's attestations applied on the device with the resident
        carry (``ops/transition.apply_attestation_rows_device``)."""
        from pos_evolution_tpu_torch.ops.transition import apply_attestation_rows_device
        apply_attestation_rows_device(state, rows, self.device)

    def multi_block_apply(self, state, signed_blocks, validate_result=True,
                          pre_block=None, on_applied=None) -> None:
        """A parent-linked run of blocks on one carried state
        (``ops/transition.apply_block_chain``)."""
        from pos_evolution_tpu_torch.ops.transition import apply_block_chain
        apply_block_chain(state, signed_blocks, validate_result,
                          pre_block=pre_block, on_applied=on_applied)

    # --- merkleization (K2) -----------------------------------------------------------

    def merkle_level(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """sha256(left[i] || right[i]) over (N, 32) uint8 rows, through K2."""
        from pos_evolution_tpu_torch.ops.merkle_device import pair_hash_rows
        return pair_hash_rows(left, right, self.device)

    def _words(self, rows) -> torch.Tensor:
        return rows_to_words(self._t(np.asarray(rows, dtype=np.uint8).reshape(-1, 32)))

    def merkleize(self, chunks: np.ndarray, limit: int | None = None) -> bytes:
        """Merkle root of (N, 32) uint8 chunks padded to ``limit``, every
        level through K2."""
        from pos_evolution_tpu_torch.ops.merkle_device import merkleize
        return merkleize(self._words(chunks), limit)

    def build_multiproof_paths(self, leaves: np.ndarray, indices, depth: int):
        """``(leaves[indices] (S, 32), branches (S, depth, 32))`` uint8 rows
        off one tree built through K2."""
        from pos_evolution_tpu_torch.ops.merkle_device import build_multiproof_paths
        leaf, branches = build_multiproof_paths(self._words(leaves), indices, depth)
        s = branches.shape[0]
        return (words_to_rows(leaf).cpu().numpy(),
                words_to_rows(branches.reshape(-1, 8)).reshape(s, depth, 32).cpu().numpy())

    # --- sync committees and data availability ------------------------------------

    def sync_update_verify(self, batch):
        """Light-client update batch (``ops/sync_verify``): K6, K1, K2."""
        from pos_evolution_tpu_torch.ops.sync_verify import verify_batch_device
        return verify_batch_device(batch, self.device)

    def das_verify(self, batch):
        """DAS sample batch (``ops/das_verify``): K6 and K2 on a CUDA device
        from the crossover up; below it (a sample is about 16 pairs of
        hashing), in ``"host"`` mode or on a CPU device, the host path."""
        from pos_evolution_tpu_torch.ops import merkle_device
        from pos_evolution_tpu_torch.ops.das_verify import (
            verify_samples_device,
            verify_samples_host,
        )
        mode = merkle_device.get_mode()
        floor = merkle_device.small_batch_floor(per_item_pairs=16)
        if (mode == "host" or self.device.type != "cuda"
                or (mode == "auto" and batch.size < floor)):
            return verify_samples_host(batch)
        return verify_samples_device(batch, self.device)

    def das_reconstruct(self, cells: np.ndarray, present: np.ndarray):
        """Erasure-reconstruction check of one blob through K7."""
        from pos_evolution_tpu_torch.ops.das_verify import reconstruct_check_device
        return reconstruct_check_device(cells, present, self.device)

    # --- KZG ----------------------------------------------------------------------------

    def fr_ntt(self, values: np.ndarray, inverse: bool = False) -> np.ndarray:
        """[..., n, 22] Montgomery digits, transformed along -2 by K10."""
        from pos_evolution_tpu_torch.kzg.ntt import ntt
        out = ntt(self._t(np.asarray(values).astype(np.int32)), bool(inverse))
        return out.cpu().numpy().astype(np.int64)

    def g1_msm(self, setup, coeffs):
        """sum_j coeffs[j] [tau^j]G1 over a host ``TrustedSetup``'s powers,
        by K11's ladder route: affine ints, or None for infinity."""
        from pos_evolution_tpu_torch.crypto.bls12_381 import R
        from pos_evolution_tpu_torch.kzg import fr
        from pos_evolution_tpu_torch.ops.pairing import (
            g1_decode_points,
            g1_encode_points,
            g1_msm,
        )
        scalars = [int(s) % R for s in coeffs]
        n = len(scalars)
        if n == 0 or n > setup.n:
            raise ValueError(f"msm size {n} vs setup of {setup.n} powers")
        pts, inf = g1_encode_points(list(setup.powers_g1[:n]), self.device)
        digits = fr.ints_to_digits(scalars, self.device)
        aff, is_inf = g1_msm(pts[None], inf[None], digits[None])
        return g1_decode_points(aff, is_inf)[0]
