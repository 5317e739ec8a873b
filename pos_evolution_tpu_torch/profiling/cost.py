"""Work and memory tables of the hot paths (port of
``pos_evolution_tpu/profiling/cost.py``).

The JAX package reads FLOPs, bytes and memory off XLA's compiler
(``cost_analysis()``, ``memory_analysis()``). Torch has no such analysis,
so this module runs each hot path once on its device and counts the
rest: the same seven hot paths (attestation aggregation, fork-choice
rescan + incremental head, dense epoch sweep, sync-committee merkle
walk, swap-or-not shuffle, the SHA-256 merkle level sweep) at the same
validator count ``n`` and fork-choice ``capacity``, on the port's
functions, with the JAX emission's keys:

    {"kernel": {"flops", "bytes_accessed", "transcendentals",
                "argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "generated_code_bytes", "peak_bytes"}}

- ``argument_bytes`` / ``output_bytes``: the bytes of the tensors (and
  numpy arrays) the call takes and returns. They equal the JAX
  package's on the same arrays, with two exceptions: XLA leaves out
  arguments a function never reads (``forkchoice.head_and_weights``:
  the store's ``slot`` and ``msg_epoch`` columns without an expiry
  window) where the port counts every tensor it is given, and XLA's
  tuple outputs carry an 8-byte pointer a leaf
  (``head_and_weights``, ``head_from_buckets``, ``process_epoch_dense``);
- ``peak_bytes``: on the card, the arguments plus the most the call
  allocated above what was held before it
  (``torch.cuda.reset_peak_memory_stats``, ``max_memory_allocated``),
  the counterpart of XLA's arguments + outputs + temps; ``None`` on the
  CPU. ``temp_bytes`` is the peak less arguments and outputs;
- ``generated_code_bytes``: the size of the hand-written kernel libraries
  (``ops/kernels.py``) whose kernels the call launched, else 0;
- ``flops`` and ``bytes_accessed``: the work the hot path's definition
  requires, counted from its shapes (and, where it depends on them, its
  inputs) by the formula written beside each entry, whatever implements
  it: 32-bit integer operations (this system's device math is integer)
  and each input byte read once, each output byte written once. This is
  the yardstick a roofline share reads before and after a redesign;
- ``transcendentals`` and ``alias_bytes``: 0 (integer math; torch donates
  no buffers).

A hot path that fails records ``{"error": ...}`` instead of killing the
sweep — a table with one hole beats no table.

CLI: ``python -m pos_evolution_tpu_torch.profiling.cost [--json out.json]
[--n 4096] [--capacity 64] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

# SHA-256 in 32-bit integer operations (3-input LOP3 and IADD3, one funnel
# shift per rotate): a round is Sigma1 (3 SHF + LOP3), Ch (LOP3), T1 (2
# IADD3), Sigma0 (3 SHF + LOP3), Maj (LOP3), e (IADD), a (IADD3) = 14, 64
# rounds and the 8-word feed-forward; a schedule word is sigma0 and sigma1
# (2 SHF + SHR + LOP3 each) and 2 IADD3, 48 words
OPS_COMPRESS = 64 * 14 + 8
OPS_SCHEDULE = 48 * 10
# a 64-byte message (a sibling pair) is two compressions under SHA-256's
# padding: the message block with its schedule, the padding block's
# schedule a constant
OPS_PAIR = 2 * OPS_COMPRESS + OPS_SCHEDULE
# the dense epoch's integer operations a validator: justification's three
# masked sums (active, previous and current target), the inactivity update
# (a test and an add), rewards and penalties (three flags a multiply and a
# divide each, the inactivity penalty's multiply and divide, two adds to
# apply them), slashings (a test), the effective-balance hysteresis (two
# tests and a write) and the flag rotation (a move)
OPS_EPOCH_VALIDATOR = 3 + 2 + 10 + 1 + 3 + 1
# a validator's registry row read (effective balance, balance, three epochs,
# inactivity score: 8 B each; slashed and both flag bytes) and the columns
# the epoch writes (balance, effective balance, inactivity score, both flags)
BYTES_EPOCH_READ = 6 * 8 + 3
BYTES_EPOCH_WRITE = 3 * 8 + 2


def _arrays(tree):
    """Every tensor and numpy array in a tree of tuples, lists, named
    tuples and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _arrays(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _arrays(v)


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor) else int(a.nbytes)
               for a in _arrays(tree))


def _library_bytes(grown: dict) -> int:
    """Bytes of the libraries of the kernels in ``grown`` (launch counts
    by kernel name), each source's library counted once."""
    from pos_evolution_tpu_torch.ops import kernels
    paths = {kernels._library_path(name) for name, n in grown.items() if n}
    return sum(p.stat().st_size for p in paths if p.exists())


def analyze_fn(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on its device and return its memory row:
    argument, output, peak and temp bytes, and the generated code of the
    kernels it launched. On the card the call runs twice, the first to
    build kernels and warm the allocator. The collector runs before the
    measured call and is off during it: ``memory_allocated()`` builds dicts
    after its snapshot, and a collection there that freed earlier garbage
    put the peak below ``held`` (a negative peak on the card)."""
    from pos_evolution_tpu_torch.ops import kernels
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in _arrays((args, kwargs)))
    collecting = gc.isenabled()
    if cuda:
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        gc.collect()
        gc.disable()
    try:
        if cuda:
            # the peak reset first: it is then at least any later ``held``
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        before = dict(kernels.launches)
        out = fn(*args, **kwargs)
        grown = {k: v - before[k] for k, v in kernels.launches.items()}
        row = {"argument_bytes": _nbytes((args, kwargs)), "output_bytes": _nbytes(out),
               "alias_bytes": 0, "generated_code_bytes": _library_bytes(grown),
               "peak_bytes": None, "temp_bytes": None}
        if cuda:
            torch.cuda.synchronize()
            row["peak_bytes"] = torch.cuda.max_memory_allocated() - held + row["argument_bytes"]
            row["temp_bytes"] = row["peak_bytes"] - row["argument_bytes"] - row["output_bytes"]
    finally:
        if collecting:
            gc.enable()
    return row


def hot_path_specs(n: int = 4096, capacity: int = 64, device="cuda") -> dict:
    """name -> zero-arg builder returning ``(fn, args, kwargs, work)`` for
    each hot path at validator count ``n``, fork-choice capacity
    ``capacity``, on ``device``; ``work`` is ``{"flops", "bytes_accessed"}``
    by the formula beside each. The inputs are the JAX package's (the same
    generator, seed and draws). Builders are lazy so one import failure
    doesn't sink the others."""
    from pos_evolution_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    gwei = 10**9

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words(shape) -> torch.Tensor:
        return put(rng.integers(0, 2**32, shape, dtype=np.uint64)
                   .astype(np.uint32).view(np.int32))

    def _aggregation():
        from pos_evolution_tpu_torch.ops.aggregation import aggregate_verify_batch
        a_total = max(n // 512, 4)
        lanes = max(n // a_total, 1)
        pk_states = words((n, 8))
        committees = put(rng.permutation(n)[:a_total * lanes]
                         .reshape(a_total, lanes).astype(np.int32))
        bits = rng.random((a_total, lanes)) < 0.99
        msgs = words((a_total, 8))
        sigs = words((a_total, 24))
        # each set-bit signer: its FakeBLS signature, three chained
        # compressions (from its midstate), two with their schedules (the
        # first's is built once a committee), then 24 words masked and
        # folded (48); a committee's 24 words compared; a set-bit signer's
        # midstate row (32 B), every lane's index (4 B) and bit (1 B), the
        # messages and signatures read once, a verdict byte written
        n_set = int(bits.sum())
        work = {"flops": n_set * (3 * OPS_COMPRESS + 2 * OPS_SCHEDULE + 48)
                + a_total * (OPS_SCHEDULE + 24),
                "bytes_accessed": n_set * 32 + a_total * lanes * 5
                + a_total * (32 + 96 + 1)}
        return aggregate_verify_batch, (pk_states, committees, put(bits), msgs,
                                        sigs), {}, work

    def _dense_store():
        from pos_evolution_tpu_torch.ops.forkchoice import DenseStore
        parent = np.arange(-1, capacity - 1, dtype=np.int32)
        return DenseStore(
            parent=put(parent),
            slot=torch.arange(capacity, dtype=torch.int32, device=dev),
            rank=put(rng.permutation(capacity).astype(np.int32)),
            real=torch.ones(capacity, dtype=torch.bool, device=dev),
            leaf_viable=torch.ones(capacity, dtype=torch.bool, device=dev),
            justified_idx=torch.tensor(0, dtype=torch.int32, device=dev),
            msg_block=put(rng.integers(0, capacity, n).astype(np.int32)),
            msg_epoch=torch.zeros(n, dtype=torch.int64, device=dev),
            weight=put(np.full(n, 32 * gwei, np.int64)),
            boost_idx=torch.tensor(capacity - 1, dtype=torch.int32, device=dev),
            boost_amount=torch.tensor(32 * gwei, dtype=torch.int64, device=dev),
        )

    def _head_work(scan: int) -> dict:
        # the subtree sums (each block adds its three columns into its
        # parent once) and the descent (each block's weight and rank
        # compared once); the tree's parent, rank (4 B), real and viable
        # (1 B) columns and the boost's scalars read; the head (4 B) and
        # the subtree weights (8 B a block) written
        return {"flops": scan + 5 * capacity,
                "bytes_accessed": capacity * (4 + 4 + 1 + 1 + 8) + 4 + 4 + 8 + 4}

    def _forkchoice_rescan():
        from pos_evolution_tpu_torch.ops.forkchoice import head_and_weights
        st = _dense_store()
        # the scan of the latest-message table: a test and an add a message,
        # its block (4 B) and weight (8 B) read
        work = _head_work(2 * n)
        work["bytes_accessed"] += n * 12
        return head_and_weights, (st,), {"capacity": capacity}, work

    def _forkchoice_incremental():
        from pos_evolution_tpu_torch.ops.forkchoice import (
            head_from_buckets,
            rebuild_buckets,
        )
        st = _dense_store()
        buckets = rebuild_buckets(st.msg_block, st.weight, capacity)
        # the resident buckets (8 B a block) read instead of the table
        work = _head_work(0)
        work["bytes_accessed"] += capacity * 8
        return head_from_buckets, (st.parent, st.real, st.rank, st.leaf_viable,
                                   st.justified_idx, buckets, st.boost_idx,
                                   st.boost_amount), {"capacity": capacity}, work

    def _epoch():
        from pos_evolution_tpu_torch.config import mainnet_config
        from pos_evolution_tpu_torch.ops.epoch import DenseRegistry, process_epoch_dense
        far = np.full(n, 2**62, np.int64)
        reg = DenseRegistry(
            effective_balance=put(np.full(n, 32 * gwei, np.int64)),
            balance=put(rng.integers(31 * gwei, 33 * gwei, n).astype(np.int64)),
            activation_epoch=torch.zeros(n, dtype=torch.int64, device=dev),
            exit_epoch=put(far),
            withdrawable_epoch=put(far),
            slashed=torch.zeros(n, dtype=torch.bool, device=dev),
            prev_flags=put(rng.integers(0, 8, n).astype(np.uint8)),
            cur_flags=put(rng.integers(0, 8, n).astype(np.uint8)),
            inactivity_scores=torch.zeros(n, dtype=torch.int64, device=dev),
        )
        bits = torch.zeros(4, dtype=torch.bool, device=dev)
        scalars = [torch.tensor(v, dtype=torch.int64, device=dev) for v in (10, 8, 8, 9, 0)]
        work = {"flops": n * OPS_EPOCH_VALIDATOR,
                "bytes_accessed": n * (BYTES_EPOCH_READ + BYTES_EPOCH_WRITE)}
        return process_epoch_dense, (reg, scalars[0], scalars[1], bits, *scalars[2:],
                                     mainnet_config()), {}, work

    def _sync_verify():
        from pos_evolution_tpu_torch.ops.sync_verify import merkle_walk
        batch, depth = 8, 6
        leaf = words((batch, 8))
        branch = words((batch, depth, 8))
        idx_bits = put(rng.integers(0, 2, (batch, depth)).astype(bool))
        # a pair hash a level of each branch; the leaf, branch nodes (32 B)
        # and index bits (1 B) read, the roots written
        work = {"flops": batch * depth * OPS_PAIR,
                "bytes_accessed": batch * (32 + depth * 33 + 32)}
        return merkle_walk, (leaf, branch, idx_bits), {}, work

    def _shuffle():
        from pos_evolution_tpu_torch.ops.shuffle import (
            _seed_words,
            _shuffle_rounds,
            host_pivots,
        )
        seed = bytes(range(32))
        rounds = 10

        def swap_or_not(seed_words, pivots):
            idx0 = torch.arange(n, dtype=torch.int32, device=dev)
            return _shuffle_rounds(seed_words, pivots, idx0, n, rounds)

        # a round: one digest a 256-index block (a compression with its
        # schedule) and, an index, the flip (a subtract and a modulo), the
        # position (a max), the bit's address, shift and mask (4) and the
        # select; the seed (32 B) and pivots (8 B a round) read, the
        # permutation (4 B an index) written
        blocks = -(-n // 256)
        work = {"flops": rounds * (blocks * (OPS_COMPRESS + OPS_SCHEDULE) + n * 8),
                "bytes_accessed": 32 + 8 * rounds + 4 * n}
        return swap_or_not, (_seed_words(seed), put(host_pivots(seed, n, rounds))), {}, work

    def _merkle_level():
        # one level of the SSZ merkle tree over n sibling pairs (the 2n-leaf
        # tree's first level), the kernel behind hash_tree_root, DAS
        # commitments and checkpoint digests (K2 on the card): a pair hash
        # each (two compressions), 64 B read and 32 B written a pair
        from pos_evolution_tpu_torch.ops.merkle_device import merkle_level
        pairs = words((n, 16))
        work = {"flops": n * OPS_PAIR, "bytes_accessed": n * 96}
        return merkle_level, (pairs[:, :8], pairs[:, 8:]), {}, work

    return {
        "aggregation.aggregate_verify_batch": _aggregation,
        "forkchoice.head_and_weights": _forkchoice_rescan,
        "forkchoice.head_from_buckets": _forkchoice_incremental,
        "epoch.process_epoch_dense": _epoch,
        "sync_verify.merkle_walk": _sync_verify,
        "shuffle.swap_or_not": _shuffle,
        "merkle_device.level_sweep": _merkle_level,
    }


def analyze_hot_paths(n: int = 4096, capacity: int = 64, device="cuda") -> dict:
    """The full emission: per-hot-path work and memory rows plus the
    device they ran on (``"cuda"`` or ``"cpu"``)."""
    from pos_evolution_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    kernels = {}
    for name, build in hot_path_specs(n=n, capacity=capacity, device=dev).items():
        try:
            fn, args, kwargs, work = build()
            row = analyze_fn(fn, *args, **kwargs)
            row.update(work, transcendentals=0)
            kernels[name] = row
        except Exception as e:
            kernels[name] = {"error": f"{e!r:.200}"}
    return {"backend": dev.type, "n_validators": n,
            "forkchoice_capacity": capacity, "kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the cost table to this path")
    ap.add_argument("--n", type=int, default=4096,
                    help="validator count for the analyzed shapes")
    ap.add_argument("--capacity", type=int, default=64,
                    help="fork-choice tree capacity")
    ap.add_argument("--device", default="cuda",
                    help="the device the hot paths run on (cuda, or cpu)")
    args = ap.parse_args(argv)
    table = analyze_hot_paths(n=args.n, capacity=args.capacity, device=args.device)
    blob = json.dumps(table, indent=1, sort_keys=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(blob + "\n")
    print(blob)
    errors = [k for k, v in table["kernels"].items() if "error" in v]
    if errors:
        print(f"# cost: {len(errors)} hot path(s) failed to analyze: "
              f"{', '.join(errors)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
