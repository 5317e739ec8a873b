"""The spec state transition on one device: a chain of full blocks through
``specs/``, the spec layer of the JAX package copied into the port, over
the port's backend (``backend/torch_backend.py``).

1. Genesis of ``n`` validators (``specs/genesis.make_genesis``).
2. A block a slot through ``specs/validator.build_block``, each carrying
   the previous slot's attestations, one aggregate of its whole committee
   for every committee (signed by kernel K1, ``committee_attestations``),
   and a sync aggregate of the whole sync committee;
   each block goes through ``state_transition(state, sb, True)`` (the
   signature and state-root checks included). At n = 2^20 under the
   mainnet config that is 64 committees of 512 a slot. Slot 32 crosses
   the first epoch boundary, so ``process_epoch`` runs (the backend's
   epoch sweep and the registry churn on the device).
3. With ``replay``: the same blocks (or those after a kept state)
   through a fresh fork-choice store's ``on_block_batch`` (checkpoint
   sync and backfill), one carried state
   through the backend's ``multi_block_apply``, so that the block sweep's
   resident columns (Queue 2 B8) are reused or patched from block to
   block.

Every ``hash_tree_root`` of a ``BeaconState`` goes through the port's
incremental merkleizer (``ssz/incremental.state_root``), on a CUDA device
through kernel K2.

Run: ``python -m pos_evolution_tpu_torch.spec_chain [--n 1048576] [--slots 33]
[--replay] [--device cuda|cpu]``; one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from pos_evolution_tpu_torch import config as spec_config
from pos_evolution_tpu_torch.backend import get_backend, use_backend
from pos_evolution_tpu_torch.device import (
    card_line,
    resolve_device,
    words_to_bytes,
    words_to_numpy,
    words_to_torch,
)
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.ops.aggregation import (
    committee_aggregates,
    messages_to_words,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops import transition as b8
from pos_evolution_tpu_torch.specs.containers import Attestation
from pos_evolution_tpu_torch.specs.epoch import process_epoch
from pos_evolution_tpu_torch.specs.forkchoice import (
    get_forkchoice_store,
    on_block_batch,
    on_tick,
)
from pos_evolution_tpu_torch.specs.genesis import make_genesis
from pos_evolution_tpu_torch.specs.helpers import (
    compute_committee,
    compute_epoch_at_slot,
    compute_signing_root,
    get_active_validator_indices,
    get_committee_count_per_slot,
    get_domain,
    get_seed,
)
from pos_evolution_tpu_torch.specs.transition import process_slot, state_transition
from pos_evolution_tpu_torch.specs.validator import (
    build_block,
    make_attestation_data,
    make_sync_aggregate,
)
from pos_evolution_tpu_torch.ssz import hash_tree_root
from pos_evolution_tpu_torch.ssz import incremental

N_MAINNET = 1 << 20


def committee_attestations(state, slot: int, head_root: bytes, pk_states) -> list:
    """One aggregate of its whole committee for every committee of
    ``slot``: ``specs/validator.attest_all_committees``'s attestations,
    with the active set, the seed and each committee's signing root
    computed once, and the aggregates from kernel K1's wrapper
    ``committee_aggregates`` over ``pk_states`` (``ops/aggregation.
    precompute_pk_states`` of the registry's pubkeys, on a device; the
    plain version on the CPU): the XOR of the signers' FakeBLS signatures,
    the bytes ``bls.Aggregate`` of their ``bls.Sign`` gives."""
    domain_type = spec_config.DOMAIN_BEACON_ATTESTER
    spe = spec_config.cfg().slots_per_epoch
    epoch = compute_epoch_at_slot(slot)
    per_slot = get_committee_count_per_slot(state, epoch)
    active = get_active_validator_indices(state, epoch)
    seed = get_seed(state, epoch, domain_type)
    committees = [compute_committee(active, seed, (slot % spe) * per_slot + i, per_slot * spe)
                  for i in range(per_slot)]
    datas = [make_attestation_data(state, slot, i, head_root) for i in range(per_slot)]
    roots = [compute_signing_root(d, get_domain(state, domain_type, int(d.target.epoch)))
             for d in datas]
    sigs = _k1_aggregates(pk_states, committees, roots)
    return [Attestation(aggregation_bits=np.ones(c.shape[0], dtype=bool), data=d, signature=sig)
            for c, d, sig in zip(committees, datas, sigs)]


def _k1_aggregates(pk_states, committees, roots) -> list:
    """Each committee's aggregate of ``roots[i]`` by K1: lanes padded to
    the widest committee with clear bits."""
    dev = pk_states.device
    width = max(c.shape[0] for c in committees)
    members = np.zeros((len(committees), width), dtype=np.int32)
    bits = np.zeros((len(committees), width), dtype=bool)
    for i, c in enumerate(committees):
        members[i, :c.shape[0]] = c
        bits[i, :c.shape[0]] = True
    msgs = messages_to_words(np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(-1, 32))
    out = committee_aggregates(pk_states, torch.from_numpy(members).to(dev),
                               torch.from_numpy(bits).to(dev), words_to_torch(msgs, dev))
    return [words_to_bytes(w) for w in words_to_numpy(out)]


def _k2() -> int:
    return kernels.launches["merkle_level"]


@dataclass
class ChainRun:
    """A chain's result: its ``summary`` (the JSON line's numbers), the
    final ``state``, the ``blocks``, the ``genesis`` state and ``anchor``
    block (untouched copies), ``pre_epoch`` (the state ``process_epoch``
    meets at the first epoch boundary: the last slot's block and its
    ``process_slot`` applied; None when the chain stops short of it),
    ``roots`` (the state root after every block) and ``kept`` (copies of
    the state after the blocks ``run_chain`` was asked to keep, by block
    number)."""

    summary: dict
    state: object
    blocks: list
    genesis: object
    anchor: object
    pre_epoch: object = None
    roots: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)


def run_chain(n: int = N_MAINNET, slots: int = 33, *, device="cuda", cfg=None,
              keep=()) -> ChainRun:
    """Genesis and a block a slot for ``slots`` slots on ``device`` under
    ``cfg`` (mainnet by default), every block checked by
    ``state_transition``; a copy of the state after each block numbered
    in ``keep`` is kept for ``replay``. Sets the active config and backend
    for its duration."""
    cfg = cfg or spec_config.mainnet_config()
    dev = resolve_device(device)
    with spec_config.use_config(cfg), use_backend("torch", device=dev):
        return _run_chain(n, slots, dev, cfg, set(keep))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_chain(n, slots, dev, cfg, keep) -> ChainRun:
    b8.reset_session()
    t0 = time.perf_counter()
    k0 = _k2()
    state, anchor = make_genesis(n)
    genesis_root = hash_tree_root(state)
    _sync(dev)
    genesis_s = time.perf_counter() - t0
    genesis_k2 = _k2() - k0
    genesis, anchor = state.copy(), anchor.copy()

    build_ms, attest_ms, transition_ms, roots, blocks = [], [], [], [], []
    head = hash_tree_root(anchor)
    atts = []
    pre_epoch, kept = None, {}
    pk_states = precompute_pk_states(state.validators.pubkeys, dev)
    b8_0 = b8.session_stats()
    k0, htr0 = _k2(), incremental.stats()["htr_calls"]
    for slot in range(1, slots + 1):
        t0 = time.perf_counter()
        agg = make_sync_aggregate(state, head)
        sb = build_block(state, slot, attestations=atts, sync_aggregate=agg)
        t1 = time.perf_counter()
        state_transition(state, sb, True)
        _sync(dev)
        t2 = time.perf_counter()
        build_ms.append((t1 - t0) * 1e3)
        transition_ms.append((t2 - t1) * 1e3)
        blocks.append(sb)
        head = hash_tree_root(sb.message)
        roots.append(bytes(sb.message.state_root))
        if slot in keep:
            kept[slot] = state.copy()
        if (slot + 1) % cfg.slots_per_epoch == 0 and pre_epoch is None:
            pre_epoch = state.copy()
            process_slot(pre_epoch)
        t0 = time.perf_counter()
        atts = committee_attestations(state, slot, head, pk_states)
        attest_ms.append((time.perf_counter() - t0) * 1e3)
    k2 = _k2() - k0
    htr = incremental.stats()["htr_calls"] - htr0
    b8_1 = b8.session_stats()
    summary = {
        "n": n, "slots": slots, "config": cfg.name, "device": card_line(dev),
        "genesis_s": genesis_s, "genesis_k2_launches": genesis_k2,
        "genesis_root": genesis_root.hex(),
        "attestations_per_block": [len(b.message.body.attestations) for b in blocks],
        "build_ms": build_ms, "transition_ms": transition_ms, "attest_ms": attest_ms,
        "k2_launches": k2, "state_roots": htr,
        "k2_launches_per_state_root": k2 / htr if htr else 0.0,
        "epoch_sweeps": get_backend().epoch_sweeps,
        "b8": {k: b8_1[k] - b8_0[k] for k in b8_0},
        "b8_ms_per_sweep": ((b8_1["seconds"] - b8_0["seconds"]) * 1e3
                            / max(b8_1["sweeps"] - b8_0["sweeps"], 1)),
        "finalized_epoch": int(state.finalized_checkpoint.epoch),
        "final_root": hash_tree_root(state).hex(),
    }
    return ChainRun(summary, state, blocks, genesis, anchor, pre_epoch, roots, kept)


def boundary(pre_epoch, *, device="cuda", cfg=None):
    """The first epoch boundary again: ``process_epoch`` on a copy of
    ``pre_epoch`` (``ChainRun.pre_epoch``) on ``device``, timed alone.
    Returns (post-boundary state, ms)."""
    cfg = cfg or spec_config.mainnet_config()
    dev = resolve_device(device)
    state = pre_epoch.copy()
    with spec_config.use_config(cfg), use_backend("torch", device=dev):
        _sync(dev)
        t0 = time.perf_counter()
        process_epoch(state)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    return state, ms


def replay(run: ChainRun, *, device="cuda", cfg=None, start: int = 0) -> dict:
    """``run``'s blocks after block ``start`` through a fresh store's
    ``on_block_batch``: from its genesis when ``start`` is 0, else
    anchored (checkpoint sync) at block ``start`` and the state after it,
    which ``run_chain(keep=)`` kept. Returns the replay's numbers and
    final state root."""
    cfg = cfg or spec_config.mainnet_config()
    dev = resolve_device(device)
    chain = run.blocks[start:]
    with spec_config.use_config(cfg), use_backend("torch", device=dev):
        b8.reset_session()
        if start:
            anchor_state, anchor = run.kept[start], run.blocks[start - 1].message
        else:
            anchor_state, anchor = run.genesis, run.anchor
        store = get_forkchoice_store(anchor_state, anchor)
        last = chain[-1].message
        on_tick(store, int(anchor_state.genesis_time) + cfg.seconds_per_slot * int(last.slot))
        s0, k0 = b8.session_stats(), _k2()
        t0 = time.perf_counter()
        on_block_batch(store, chain)
        _sync(dev)
        seconds = time.perf_counter() - t0
        s1 = b8.session_stats()
        final = store.block_states[hash_tree_root(last)]
        return {
            "blocks": len(chain), "seconds": seconds,
            "blocks_per_s": len(chain) / seconds,
            "k2_launches": _k2() - k0,
            "b8": {k: s1[k] - s0[k] for k in s0},
            "finalized_epoch": int(store.finalized_checkpoint.epoch),
            "final_root": hash_tree_root(final).hex(),
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_MAINNET, help="validators")
    ap.add_argument("--slots", type=int, default=33)
    ap.add_argument("--replay", action="store_true",
                    help="replay the blocks through a fresh store's on_block_batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = run_chain(args.n, args.slots, device=args.device)
    out = dict(run.summary)
    if run.pre_epoch is not None:
        _post, out["process_epoch_ms"] = boundary(run.pre_epoch, device=args.device)
    if args.replay:
        out["replay"] = replay(run, device=args.device)
    out["launches"] = {k: v for k, v in kernels.launches.items() if v}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
