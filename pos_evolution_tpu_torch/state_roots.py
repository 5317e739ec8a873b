"""The registry-scale state roots around one epoch, on one device.

The port's second slice: the SSZ roots of the BeaconState's five
registry-scale fields (``validators``, ``balances``,
``previous_epoch_participation``, ``current_epoch_participation``,
``inactivity_scores``; ``pos_evolution_tpu/specs/containers.py:553-569``),
in two passes around the first slice's epoch:

1. load: the epoch's registry and the static validator columns to the
   device (``load_columns``);
2. pre: a full build of the five field trees at the pre-epoch state;
3. epoch: ``epoch.run_epoch``;
4. post: the incremental dirty-path rehash at the post-epoch state that
   the epoch's sweep produced (``EpochResult.registry``).

Each root computation drives all five trees through one ``LevelSweeper``:
one kernel-K2 launch per tree level across every dirty field, after the
validator-root pass over the changed validators (four launches). At
n = 2^20 that is 4 + 20 launches per root computation, the 20 set by the
registry tree's depth.

Run: ``python -m pos_evolution_tpu_torch.state_roots [--n N] [--seed S] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.config import Config, mainnet_config
from pos_evolution_tpu_torch.convert import registry_to_torch
from pos_evolution_tpu_torch.device import resolve_device
from pos_evolution_tpu_torch.epoch import (
    N_MAINNET,
    EpochInputs,
    EpochOutputs,
    build_epoch_inputs,
    run_epoch,
)
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.ops.epoch import DenseRegistry, i64_to_epoch_bits
from pos_evolution_tpu_torch.ops.merkle_device import LevelSweeper
from pos_evolution_tpu_torch.ssz.incremental import (
    ValidatorRegistry,
    _pack_uint_chunks,
    _RegistryField,
    _TreeField,
)

FIELDS = ("validators", "balances", "previous_epoch_participation",
          "current_epoch_participation", "inactivity_scores")


class ValidatorColumns(NamedTuple):
    """The static validator columns the dense registry lacks (numpy from
    ``validator_columns``, tensors from ``load_columns``)."""

    pubkeys: np.ndarray                       # (N, 48) uint8, the epoch's pubkeys
    withdrawal_credentials: np.ndarray        # (N, 32) uint8
    activation_eligibility_epoch: np.ndarray  # (N,) int64


class RegistryState(NamedTuple):
    """The five registry-scale fields of a BeaconState, on one device."""

    validators: ValidatorRegistry
    balances: torch.Tensor                      # int64 (N,) Gwei
    previous_epoch_participation: torch.Tensor  # uint8 (N,) flags
    current_epoch_participation: torch.Tensor   # uint8 (N,) flags
    inactivity_scores: torch.Tensor             # int64 (N,)


class StateRoots(NamedTuple):
    pre: dict                # field -> 32-byte root of the pre-epoch state (full build)
    post: dict               # field -> 32-byte root of the post-epoch state (incremental)
    dirty: dict              # field -> leaves the update re-hashed (validator rows for validators)
    epoch: EpochOutputs
    trees: "RegistryScaleTrees"


def validator_columns(inputs: EpochInputs) -> ValidatorColumns:
    """The epoch's pubkeys and, from ``numpy.random.default_rng(seed + 1)``
    (``seed`` = ``build_epoch_inputs``'s, kept in ``inputs.salt``, so that
    its own draws stay as they are), 0x01 execution-address withdrawal
    credentials. Every validator of the epoch's registry is a genesis
    validator (activation epoch 0), so its eligibility epoch is 0 too."""
    n = inputs.pubkeys.shape[0]
    rng = np.random.default_rng(inputs.salt + 1)
    credentials = np.zeros((n, 32), np.uint8)
    credentials[:, 0] = 1
    credentials[:, 12:] = rng.integers(0, 256, (n, 20), dtype=np.uint8)
    return ValidatorColumns(inputs.pubkeys, credentials, np.zeros(n, np.int64))


def registry_state(reg: DenseRegistry, cols: ValidatorColumns) -> RegistryState:
    """A dense registry and the static columns (tensors on its device) as
    the five fields; the FAR_FUTURE sentinel becomes 2^64 - 1."""
    return RegistryState(
        validators=ValidatorRegistry(
            pubkeys=cols.pubkeys,
            withdrawal_credentials=cols.withdrawal_credentials,
            effective_balance=reg.effective_balance,
            slashed=reg.slashed,
            activation_eligibility_epoch=cols.activation_eligibility_epoch,
            activation_epoch=i64_to_epoch_bits(reg.activation_epoch),
            exit_epoch=i64_to_epoch_bits(reg.exit_epoch),
            withdrawable_epoch=i64_to_epoch_bits(reg.withdrawable_epoch)),
        balances=reg.balance,
        previous_epoch_participation=reg.prev_flags,
        current_epoch_participation=reg.cur_flags,
        inactivity_scores=reg.inactivity_scores)


def _uint_list_field(byte_len: int, limit: int) -> _TreeField:
    """``List[uint<8*byte_len>, limit]`` packed 32 // byte_len per chunk."""
    per_chunk = 32 // byte_len
    return _TreeField(chunker=lambda v: _pack_uint_chunks(v, byte_len), mix=True,
                      length_of=lambda v: v.shape[0], limit=-(-limit // per_chunk))


class RegistryScaleTrees:
    """Persistent trees of the five fields, limits as ``BeaconState``'s
    (``VALIDATOR_REGISTRY_LIMIT`` = 2^40: 2^38 chunks for a uint64 list,
    2^35 for a uint8 list). ``plain=True`` hashes every level with K2's
    plain version: the reference the kernel is held against."""

    def __init__(self, cfg: Config | None = None, *, plain: bool = False):
        limit = (cfg or mainnet_config()).validator_registry_limit
        self.plain = plain
        self.fields = {
            "validators": _RegistryField(limit),
            "balances": _uint_list_field(8, limit),
            "previous_epoch_participation": _uint_list_field(1, limit),
            "current_epoch_participation": _uint_list_field(1, limit),
            "inactivity_scores": _uint_list_field(8, limit),
        }

    def roots(self, state: RegistryState) -> dict:
        """field -> 32-byte root, all trees through one ``LevelSweeper``."""
        sweeper = LevelSweeper(plain=self.plain)
        fins = {f: self.fields[f].root_deferred(getattr(state, f), sweeper) for f in FIELDS}
        sweeper.run()
        return {f: fin() for f, fin in fins.items()}

    def dirty(self) -> dict:
        """field -> leaves the last ``roots`` re-hashed (validator rows for
        the registry)."""
        return {f: (self.fields[f].reg_tree.dirty_rows if f == "validators"
                    else self.fields[f].tree.dirty) for f in FIELDS}


def load_columns(inputs: EpochInputs, device="cuda") -> ValidatorColumns:
    """The static columns as tensors on ``device``."""
    dev = resolve_device(device)
    return ValidatorColumns(*(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                              for c in validator_columns(inputs)))


def run_state_roots(inputs: EpochInputs, device="cuda", *, plain: bool = False) -> StateRoots:
    """Pre-epoch roots (full build), ``run_epoch``, post-epoch roots
    (incremental), on ``device`` (CUDA unless asked otherwise; raises
    without it). ``plain=True`` takes the kernels' plain versions on any
    device, in the roots and in the epoch."""
    dev = resolve_device(device)
    cols = load_columns(inputs, dev)
    trees = RegistryScaleTrees(inputs.cfg, plain=plain)
    pre = trees.roots(registry_state(registry_to_torch(inputs.registry, dev), cols))
    out = run_epoch(inputs, dev, plain=plain)
    post = trees.roots(registry_state(out.result.registry, cols))
    return StateRoots(pre, post, trees.dirty(), out, trees)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_MAINNET, help="validators")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inputs = build_epoch_inputs(args.n, args.seed)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_state_roots(inputs, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "n": args.n,
        "pre": {f: r.hex() for f, r in res.pre.items()},
        "post": {f: r.hex() for f, r in res.post.items()},
        "dirty": res.dirty,
        "finalize_epoch": int(res.epoch.result.finalize_epoch),
        "launches": dict(kernels.launches),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_seconds_first_call": wall,
    }))


if __name__ == "__main__":
    main()
