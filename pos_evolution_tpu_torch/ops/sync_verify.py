"""Batched light-client sync-update verification (port of
``pos_evolution_tpu/ops/sync_verify.py``).

A light client's work per update is one participation-weighted
sync-aggregate verification and two merkle-branch checks into the
attested state. A batch of B updates over S-lane sync committees runs
both checks at once:

- signatures: each update's committee lanes become rows of one (B * S)-row
  midstate table (the first SHA-256 block of every lane's signature,
  ``ops/aggregation.precompute_pk_states``, kernel K6), so kernel K1
  (``ops/aggregation.aggregate_verify_batch``) verifies the B aggregates
  with committees ``arange(B * S).reshape(B, S)``; K1 takes at most 65,535
  committees, so B <= 65,535;
- participation counts and weights: ``aggregate_bits_and_weights``;
- branches: the walk over depth, each level a select of (sibling, value)
  or (value, sibling) by the index bit, then one K2 launch
  (``ops/merkle_device.pair_hash``) over the whole batch.

``verify_batch_host`` is the numpy/hashlib oracle; ``verify_batch_device``
equals it key for key and dtype for dtype. ``plain=True`` takes the plain
versions of K1, K2 and K6 on any device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from pos_evolution_tpu_torch.device import resolve_device, rows_to_words, words_to_rows
from pos_evolution_tpu_torch.ops.aggregation import (
    _PREFIX,
    aggregate_bits_and_weights,
    aggregate_verify_batch,
    messages_to_words,
    pack_signature_words,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops.merkle_device import pair_hash
from pos_evolution_tpu_torch.ssz.hash import sha256_pairs

__all__ = [
    "SyncUpdateBatch",
    "fakebls_fast_aggregate_verify",
    "merkle_roots_host",
    "merkle_roots_device",
    "merkle_walk",
    "verify_batch_host",
    "verify_batch_device",
]


@dataclass
class SyncUpdateBatch:
    """Dense form of B light-client updates over S-lane sync committees
    (array-level only). Branch groups with ``*_present == False`` still
    flow through the walk; their verdicts are masked off."""

    pubkeys: np.ndarray       # (B, S, 48) u8 — committee pubkeys per update
    bits: np.ndarray          # (B, S) bool  — participation bits
    weights: np.ndarray       # (B, S) i64   — per-lane weight (1 = count)
    messages: np.ndarray      # (B, 32) u8   — signing roots
    signatures: np.ndarray    # (B, 96) u8   — aggregate signatures
    fin_leaf: np.ndarray      # (B, 32) u8   — finalized header roots
    fin_branch: np.ndarray    # (B, FD, 32) u8
    fin_index: np.ndarray     # (B,) i64
    fin_root: np.ndarray      # (B, 32) u8   — attested state roots
    fin_present: np.ndarray   # (B,) bool
    sc_leaf: np.ndarray       # (B, 32) u8   — next-sync-committee roots
    sc_branch: np.ndarray     # (B, SD, 32) u8
    sc_index: np.ndarray      # (B,) i64
    sc_root: np.ndarray       # (B, 32) u8
    sc_present: np.ndarray    # (B,) bool

    @property
    def size(self) -> int:
        return self.bits.shape[0]


def fakebls_fast_aggregate_verify(pubkeys, message: bytes, signature: bytes) -> bool:
    """The FakeBLS scheme's ``FastAggregateVerify`` by hashlib (the port's
    copy of ``pos_evolution_tpu/crypto/bls.py::FakeBLS``): a signature is
    H(prefix | pubkey | message) and its two chain hashes, an aggregate
    their XOR; an empty signer set never verifies."""
    if not pubkeys:
        return False
    acc = 0
    for pk in pubkeys:
        h1 = hashlib.sha256(_PREFIX + bytes(pk) + bytes(message)).digest()
        h2 = hashlib.sha256(h1).digest()
        acc ^= int.from_bytes(h1 + h2 + hashlib.sha256(h2).digest(), "big")
    return acc.to_bytes(96, "big") == bytes(signature)


def _index_bits(index: np.ndarray, depth: int) -> np.ndarray:
    """(B,) indices -> (B, depth) bool: bit d selects right-child at level d."""
    idx = np.asarray(index, dtype=np.int64)
    return ((idx[:, None] >> np.arange(depth, dtype=np.int64)[None, :]) & 1).astype(bool)


# --- merkle walk: host / device ----------------------------------------------

def merkle_roots_host(leaf: np.ndarray, branch: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Recompute the branch roots for a batch of proofs (numpy/hashlib)."""
    value = np.ascontiguousarray(leaf, dtype=np.uint8)
    branch = np.asarray(branch, dtype=np.uint8)
    bits = _index_bits(index, branch.shape[1])
    for d in range(branch.shape[1]):
        sib = branch[:, d]
        right_child = bits[:, d][:, None]
        left = np.where(right_child, sib, value)
        right = np.where(right_child, value, sib)
        value = sha256_pairs(np.ascontiguousarray(left), np.ascontiguousarray(right))
    return value


def merkle_walk(leaf_words, branch_words, index_bits, *, plain: bool = False):
    """The batched branch walk on the tensors' device: leaf (B, 8) and
    branch (B, D, 8) int32 words, index bits (B, D) bool -> (B, 8) roots.
    Each level is a select, then one ``pair_hash`` (K2) over the batch."""
    value = leaf_words
    for d in range(branch_words.shape[1]):
        sib = branch_words[:, d]
        right_child = index_bits[:, d, None]
        value = pair_hash(torch.where(right_child, sib, value),
                          torch.where(right_child, value, sib), plain=plain)
    return value


def _rows_on(rows: np.ndarray, dev) -> torch.Tensor:
    """(..., 32) uint8 rows -> (-1, 8) int32 words on ``dev``."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8).reshape(-1, 32)
    return rows_to_words(torch.from_numpy(rows).to(dev))


def merkle_roots_device(leaf: np.ndarray, branch: np.ndarray, index: np.ndarray,
                        device="cuda", *, plain: bool = False) -> np.ndarray:
    """The device counterpart of ``merkle_roots_host`` (the same bytes)."""
    dev = resolve_device(device)
    b, depth = branch.shape[0], branch.shape[1]
    roots = merkle_walk(_rows_on(leaf, dev), _rows_on(branch, dev).reshape(b, depth, 8),
                        torch.from_numpy(_index_bits(index, depth)).to(dev), plain=plain)
    return words_to_rows(roots).cpu().numpy()


# --- whole-batch verification -------------------------------------------------

def _result(sig_ok, participation, weight, fin_root, fin_ok, sc_root, sc_ok) -> dict:
    return {
        "sig_ok": np.asarray(sig_ok, dtype=bool),
        "participation": np.asarray(participation, dtype=np.int32),
        "weight": np.asarray(weight, dtype=np.int64),
        "fin_root": np.asarray(fin_root, dtype=np.uint8),
        "fin_ok": np.asarray(fin_ok, dtype=bool),
        "sc_root": np.asarray(sc_root, dtype=np.uint8),
        "sc_ok": np.asarray(sc_ok, dtype=bool),
    }


def verify_batch_host(batch: SyncUpdateBatch) -> dict:
    """numpy/hashlib reference path (the oracle the device path must match)."""
    b = batch.size
    sig_ok = np.zeros(b, dtype=bool)
    for i in range(b):
        lanes = np.nonzero(batch.bits[i])[0]
        pks = [batch.pubkeys[i, j].tobytes() for j in lanes]
        sig_ok[i] = fakebls_fast_aggregate_verify(pks, batch.messages[i].tobytes(),
                                                  batch.signatures[i].tobytes())
    participation = batch.bits.sum(axis=1, dtype=np.int32)
    weight = np.where(batch.bits, batch.weights, 0).sum(axis=1, dtype=np.int64)
    fin_root = merkle_roots_host(batch.fin_leaf, batch.fin_branch, batch.fin_index)
    fin_ok = (fin_root == batch.fin_root).all(axis=1) & batch.fin_present
    sc_root = merkle_roots_host(batch.sc_leaf, batch.sc_branch, batch.sc_index)
    sc_ok = (sc_root == batch.sc_root).all(axis=1) & batch.sc_present
    return _result(sig_ok, participation, weight, fin_root, fin_ok, sc_root, sc_ok)


def verify_batch_device(batch: SyncUpdateBatch, device="cuda", *, plain: bool = False) -> dict:
    """The batch on ``device`` (CUDA unless the caller asks for another):
    the committee lanes' midstates by K6, the aggregates by K1, the walks
    by K2; ``plain=True`` takes their plain versions."""
    dev = resolve_device(device)
    b, s = batch.bits.shape
    pk_states = precompute_pk_states(np.asarray(batch.pubkeys).reshape(b * s, 48), dev,
                                     plain=plain)
    committees = torch.arange(b * s, dtype=torch.int32, device=dev).reshape(b, s)
    msg_words = messages_to_words(np.ascontiguousarray(batch.messages, dtype=np.uint8))
    sig_words = pack_signature_words([batch.signatures[i].tobytes() for i in range(b)])
    bits = torch.from_numpy(np.ascontiguousarray(batch.bits, dtype=bool)).to(dev)
    sig_ok = aggregate_verify_batch(
        pk_states, committees, bits, torch.from_numpy(msg_words.view(np.int32)).to(dev),
        torch.from_numpy(sig_words.reshape(b, 24).view(np.int32)).to(dev), plain=plain)
    participation, weight = aggregate_bits_and_weights(
        bits, torch.from_numpy(np.asarray(batch.weights, dtype=np.int64)).to(dev))
    fin_root = merkle_roots_device(batch.fin_leaf, batch.fin_branch, batch.fin_index, dev,
                                   plain=plain)
    fin_ok = (fin_root == batch.fin_root).all(axis=1) & batch.fin_present
    sc_root = merkle_roots_device(batch.sc_leaf, batch.sc_branch, batch.sc_index, dev,
                                  plain=plain)
    sc_ok = (sc_root == batch.sc_root).all(axis=1) & batch.sc_present
    return _result(sig_ok.cpu().numpy(), participation.cpu().numpy(), weight.cpu().numpy(),
                   fin_root, fin_ok, sc_root, sc_ok)
