"""One mainnet epoch at the array level, on one device.

The port's main path: the workload of ``bench.py`` and of one epoch of
``sim/dense_driver.DenseSimulation`` in the JAX package, composed of the
port's own functions:

1. registry setup: tables to the device, pubkey midstates
   (``load_inputs``);
2. committees: the swap-or-not shuffle, ``perm[:A*C].reshape(A, C)``
   (``epoch_committees``);
3. sign: the honest committee aggregates (kernel K1);
4. verify: all A aggregates (kernel K1 again);
5. head: one ``head_and_weights`` pass per slot over the full
   latest-message table, with the slot salted into ``msg_epoch[0]`` and
   ``boost_idx`` as ``bench.py`` does (``head_passes``);
6. sweep: ``process_epoch_dense`` with ``bench.py``'s arguments.

At full width n = 2^20 validators, 32 slots x 64 committees: A = 2048
aggregates of C = 512 signers.

Run: ``python -m pos_evolution_tpu_torch.epoch [--n N] [--seed S] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.config import Config, mainnet_config
from pos_evolution_tpu_torch.convert import registry_to_torch, store_to_torch
from pos_evolution_tpu_torch.device import checksum_tree, resolve_device, words_to_torch
from pos_evolution_tpu_torch.ops.aggregation import (
    aggregate_signatures_batch,
    aggregate_verify_batch,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops.epoch import DenseRegistry, EpochResult, process_epoch_dense
from pos_evolution_tpu_torch.ops.forkchoice import DenseStore, head_and_weights
from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation

N_MAINNET = 1 << 20
GWEI = 10**9


class EpochInputs(NamedTuple):
    """Everything one epoch consumes, as numpy arrays (and plain values)."""

    pubkeys: np.ndarray           # (N, 48) uint8
    registry: DenseRegistry       # numpy columns
    store: DenseStore             # numpy columns and scalars
    agg_bits: np.ndarray          # (A, C) bool, ~99% set
    msg_words: np.ndarray         # (A, 8) uint32 signing roots
    shuffle_seed: bytes           # 32 bytes
    shuffle_rounds: int
    slots: int
    committees_per_slot: int
    capacity: int
    salt: int                     # slot s salts with t = salt * slots + s
    sweep_args: tuple             # (current, finalized, bits, prev_just, cur_just, slashings)
    cfg: Config


class EpochTensors(NamedTuple):
    """The tensors ``load_inputs`` puts on the device."""

    registry: DenseRegistry
    store: DenseStore
    pk_states: torch.Tensor       # (N, 8) int32 words
    bits: torch.Tensor            # (A, C) bool
    msg_words: torch.Tensor       # (A, 8) int32 words


class EpochOutputs(NamedTuple):
    committees: torch.Tensor      # (A, C) int32 validator indices
    aggregates: torch.Tensor      # (A, 24) int32 words
    ok: torch.Tensor              # bool[A]
    heads: torch.Tensor           # int32[slots]
    weights: torch.Tensor         # int64[slots, capacity]
    result: EpochResult


def _flags(rng, n: int) -> np.ndarray:
    """Participation flags: all three set for ~95% of validators, random
    for the rest, so that the sweep justifies and finalizes."""
    return np.where(rng.random(n) < 0.95, 7, rng.integers(0, 8, n)).astype(np.uint8)


def build_epoch_inputs(n: int = N_MAINNET, seed: int = 0, *, slots: int = 32,
                       committees_per_slot: int = 64, capacity: int = 64,
                       shuffle_rounds: int | None = None,
                       cfg: Config | None = None) -> EpochInputs:
    """The epoch's inputs from ``numpy.random.default_rng(seed)``.

    Registry and message table as ``bench.py`` builds them, with three
    changes that make the outputs worth comparing: the fork-choice tree is
    a random branching tree with some non-viable leaves and some
    validators without a message (``bench.py`` uses a chain); ~95% of
    validators carry all participation flags, so that the sweep justifies
    and finalizes (``bench.py`` draws every flag at random); and the
    signatures are not random but made by the honest committees during
    the run, so that verification must come out all True.
    """
    cfg = cfg or mainnet_config()
    rounds = cfg.shuffle_round_count if shuffle_rounds is None else shuffle_rounds
    a = slots * committees_per_slot
    if n < a:
        raise ValueError(f"need at least one validator per committee: n={n} < A={a}")
    c = n // a
    rng = np.random.default_rng(seed)

    reg = DenseRegistry(
        effective_balance=np.full(n, 32 * GWEI, np.int64),
        balance=rng.integers(31 * GWEI, 33 * GWEI, n).astype(np.int64),
        activation_epoch=np.zeros(n, np.int64),
        exit_epoch=np.full(n, 2**62, np.int64),
        withdrawable_epoch=np.full(n, 2**62, np.int64),
        slashed=np.zeros(n, bool),
        prev_flags=_flags(rng, n),
        cur_flags=_flags(rng, n),
        inactivity_scores=np.zeros(n, np.int64),
    )
    pubkeys = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    agg_bits = rng.random((a, c)) < 0.99
    msg_words = rng.integers(0, 2**32, (a, 8), dtype=np.uint64).astype(np.uint32)

    parent = np.array([-1] + [rng.integers(max(0, i - 3), i) for i in range(1, capacity)],
                      dtype=np.int32)
    store = DenseStore(
        parent=parent,
        slot=np.arange(capacity, dtype=np.int32),
        rank=rng.permutation(capacity).astype(np.int32),
        real=np.ones(capacity, bool),
        leaf_viable=rng.random(capacity) < 0.9,
        justified_idx=np.int32(0),
        msg_block=rng.integers(-1, capacity, n).astype(np.int32),
        msg_epoch=np.zeros(n, np.int64),
        weight=reg.effective_balance,
        boost_idx=np.int32(capacity - 1),
        boost_amount=np.int64(32 * GWEI * (n // 32) // 4),
    )
    current_epoch = 10
    shuffle_seed = hashlib.sha256(b"shuffle" + seed.to_bytes(8, "little")
                                  + current_epoch.to_bytes(8, "little")).digest()
    return EpochInputs(
        pubkeys=pubkeys, registry=reg, store=store, agg_bits=agg_bits,
        msg_words=msg_words, shuffle_seed=shuffle_seed, shuffle_rounds=rounds,
        slots=slots, committees_per_slot=committees_per_slot, capacity=capacity,
        salt=seed, sweep_args=(current_epoch, 8, np.zeros(4, bool), 8, 9, 0),
        cfg=cfg)


def load_inputs(inputs: EpochInputs, device="cuda") -> EpochTensors:
    """Stage 1: the registry, store, bitlists and messages to ``device``,
    and each validator's pubkey midstate."""
    dev = resolve_device(device)
    return EpochTensors(
        registry=registry_to_torch(inputs.registry, dev),
        store=store_to_torch(inputs.store, dev),
        pk_states=precompute_pk_states(inputs.pubkeys, dev),
        bits=torch.from_numpy(inputs.agg_bits).to(dev),
        msg_words=words_to_torch(inputs.msg_words, dev))


def epoch_committees(inputs: EpochInputs, device="cuda") -> torch.Tensor:
    """Stage 2: the (A, C) int32 committees, the shuffled prefix."""
    n = inputs.pubkeys.shape[0]
    a, c = inputs.agg_bits.shape
    perm = shuffle_permutation(inputs.shuffle_seed, n, inputs.shuffle_rounds, device)
    return perm[: a * c].reshape(a, c)


def head_passes(store: DenseStore, inputs: EpochInputs):
    """Stage 5: one head query per slot -> (heads int32[slots], weights
    int64[slots, capacity])."""
    capacity = inputs.capacity
    heads, weights = [], []
    for s in range(inputs.slots):
        t = inputs.salt * inputs.slots + s
        msg_epoch = store.msg_epoch.clone()
        msg_epoch[0] = t
        st = store._replace(
            msg_epoch=msg_epoch,
            boost_idx=torch.tensor(t % capacity, dtype=torch.int32,
                                   device=store.parent.device))
        h, w = head_and_weights(st, capacity)
        heads.append(h)
        weights.append(w)
    return torch.stack(heads), torch.stack(weights)


def run_epoch(inputs: EpochInputs, device="cuda", *, plain: bool = False) -> EpochOutputs:
    """Run one epoch on ``device`` (CUDA unless asked otherwise; raises
    without it). ``plain=True`` runs the aggregation's plain PyTorch
    version instead of kernel K1 on any device: the reference the kernel
    is held against."""
    dev = resolve_device(device)
    t = load_inputs(inputs, dev)
    committees = epoch_committees(inputs, dev)
    aggregates = aggregate_signatures_batch(t.pk_states, committees, t.bits, t.msg_words,
                                            plain=plain)
    ok = aggregate_verify_batch(t.pk_states, committees, t.bits, t.msg_words, aggregates,
                                plain=plain)
    heads, weights = head_passes(t.store, inputs)
    result = process_epoch_dense(t.registry, *inputs.sweep_args, inputs.cfg)
    return EpochOutputs(committees, aggregates, ok, heads, weights, result)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_MAINNET, help="validators")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inputs = build_epoch_inputs(args.n, args.seed)
    t0 = time.perf_counter()
    out = run_epoch(inputs, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "n": args.n,
        "aggregates": int(out.ok.numel()),
        "verified": int(out.ok.sum()),
        "heads": out.heads.tolist(),
        "finalize_epoch": int(out.result.finalize_epoch),
        "checksum": checksum_tree(out),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_seconds_first_call": wall,
    }))


if __name__ == "__main__":
    main()
