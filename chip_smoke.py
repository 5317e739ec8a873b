#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pos_evolution_tpu_torch``) on one GPU.

Phases, in order; any mismatch or exception ends the run non-zero:

1. build every kernel from the sources in this checkout;
2. hold kernel K1 (``csrc/agg_sig.cu``) against its plain PyTorch version
   at the main path's shapes (A=2048 committees of C=512, N=2^20
   validators), and against hashlib FakeBLS on a few committees; honest
   aggregates verify, a flipped word and an empty bitlist do not;
3. cross-check the whole epoch on the card against the CPU at a small size,
   and the shuffle against the spec's per-index swap-or-not;
4. drive the main path once -- ``run_epoch`` on 2^20 validators on cuda --
   with the launch counts zeroed just before and read just after, and hold
   every output against the same epoch with the plain aggregation;
5. time K1, its plain version and the whole epoch with CUDA events after a
   warm-up, and work out K1's bound from this run's inputs;
6. hold kernel K2 (``csrc/merkle_level.cu``) against its plain PyTorch
   version at the slice's largest level (4,194,304 pairs, the validator
   leaves' first level at N=2^20) and at N in {1, 3, 511, 513}, bit for
   bit, and against hashlib on spot rows; a zero-size call launches
   nothing;
7. drive the second slice's path once -- ``run_state_roots`` on 2^20
   validators on cuda: the five registry-scale field roots before (full
   build) and after (incremental) the epoch -- with the launch counts
   zeroed just before and read just after; hold both root sets against the
   same run with the plain versions, the incremental roots against a fresh
   build of the post-epoch state, and three balance chunks and three
   validators against the roots by hashlib branch proofs;
8. cross-check the roots on the card against the CPU at a small size;
9. time K2 (per launch at 4,194,304 and 1,048,576 pairs), its plain
   version, the full build and the incremental update, and the roots
   path's stages, and work out K2's bound from this run's pair counts;
10. drive the third slice's path once -- ``DenseSimulation`` on 2^20
    validators, mainnet config, 90 shuffle rounds, ``run_epochs(4)``, then
    its ``state_digest`` -- with the launch counts zeroed just before and
    read just after: K1 twice a slot, K2 in the digest, every walk check
    true, 64 x 128 aggregates verified, finality reached; the same run with
    ``plain=True`` gives identical metrics, summary and digest; K1 at the
    path's shape (A=64, C=512) against its plain version;
11. a faulted and adversarial run at 2^20 (drops, delays, a crash window,
    an equivocator controlling 1/16, the default monitors) for 2 epochs,
    and the same run checkpointed after epoch 1 and resumed on the card:
    equal metrics, monitor violations, evidence and digest;
12. the dense driver on the card against the CPU at n = 256 (honest) and
    n = 384 (the faulted composition);
13. time the dense path: seconds per simulated epoch, its phase budget,
    and the device's busy share under ``torch.profiler`` over one epoch;
    K1 at the path's shape against its bound;
14. count the SASS instructions of every kernel (``cuobjdump -sass``), by
    opcode group, per signer and per pair, and the two bounds they give;
15. hold the field kernels K3 (``csrc/fp_modmul.cu``), K4
    (``csrc/fp_addsub.cu``) and K5 (``csrc/alg_mul.cu``) against their
    plain versions at the BLS path's shapes, digit for digit: K3 on the
    4096 x 144 products of an Fq12 multiply over the doubled Miller batch
    and on edge values, every registered K4 tape over 4096 lanes (the
    single ops at [4096, 12, 32]), K5 for d = 2, 6, 12 and the sparse line
    plan at 4096 lanes and for the 9 Fq2 squarings of a cyclotomic
    squaring;
16. drive the fourth slice's path once -- ``bls_verify.run`` at 2048
    aggregates over 262,144 signers (BASELINE config 3): setup, signature
    decompression, hash-to-G2, the batched pairing and the swapped-pair
    negative control -- with the launch counts zeroed just before and read
    just after: every aggregate verifies, exactly the swapped pair fails,
    K3-K5 launched and K1, K2 not;
17. hold that path at B = 2: the ``plain=True`` run on the card and the
    CPU run equal the kernel run in the aggregate keys, Miller values,
    final exponentiation and verdicts; 8 aggregates' hashed messages and
    verdicts equal the port's oracle copy; the field launches and other
    aten ops of each verify stage at B = 2;
18. time K3-K5 per launch at the path's shapes against their plain
    versions and bounds (every K4 tape against the bytes of its rows, by
    CUDA events and by ``torch.profiler``), the wrappers' calls, and the
    pairing stage under ``torch.profiler``;
19. the integer bound of K3 from its SASS count, and the SASS census of
    K4 and K5.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and
prints no result. Run from the repository root: ``python3 chip_smoke.py``.
"""

import contextlib
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pos_evolution_tpu_torch import bls_verify  # noqa: E402
from pos_evolution_tpu_torch.convert import registry_to_torch  # noqa: E402
from pos_evolution_tpu_torch.crypto import bls12_381 as oracle  # noqa: E402
from pos_evolution_tpu_torch.device import (  # noqa: E402
    MASK32,
    checksum_tree,
    words_to_bytes,
    words_to_numpy,
    words_to_torch,
)
from pos_evolution_tpu_torch.epoch import (  # noqa: E402
    N_MAINNET,
    build_epoch_inputs,
    epoch_committees,
    head_passes,
    load_inputs,
    run_epoch,
)
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels, tower  # noqa: E402
from pos_evolution_tpu_torch.ops.aggregation import (  # noqa: E402
    _committee_aggregates,
    aggregate_signatures_batch,
    aggregate_verify_batch,
    committee_aggregates,
    precompute_pk_states,
)
from pos_evolution_tpu_torch.ops import merkle_device  # noqa: E402
from pos_evolution_tpu_torch.ops.epoch import FAR_FUTURE_I64, process_epoch_dense  # noqa: E402
from pos_evolution_tpu_torch.ops.merkle_device import _merkle_level, merkle_level  # noqa: E402
from pos_evolution_tpu_torch.ops.pairing import (  # noqa: E402
    fast_aggregate_verify_batch,
    g2_affine_encode,
)
from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation  # noqa: E402
from pos_evolution_tpu_torch.ssz import incremental  # noqa: E402
from pos_evolution_tpu_torch.ssz.merkle import (  # noqa: E402
    ZERO_HASHES,
    _depth_for,
    is_valid_merkle_branch,
)
from pos_evolution_tpu_torch.state_roots import (  # noqa: E402
    FIELDS,
    RegistryScaleTrees,
    load_columns,
    registry_state,
    run_state_roots,
    validator_columns,
)
from pos_evolution_tpu_torch.config import mainnet_config  # noqa: E402
from pos_evolution_tpu_torch.resilience import state_digest  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_adversary import DenseEquivocator  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_driver import DenseSimulation  # noqa: E402
from pos_evolution_tpu_torch.sim.dense_monitors import default_dense_monitors  # noqa: E402
from pos_evolution_tpu_torch.sim.faults import DenseCrashWindow, DenseFaultPlan  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x 128 lanes x 2 flops
# per FMA x 1.98 GHz. An SM issues at most one warp instruction per clock on
# each of its 4 schedulers, 128 32-bit lane operations per clock, so no
# integer work runs faster than 67e12 / 2 lane instructions per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_LANE_OPS_PER_S = 67e12 / 2

# SHA-256 in the fewest sm_90 instructions (3-input LOP3 and IADD3, one
# funnel shift per rotate): a round is Sigma1 (3 SHF + LOP3), Ch (LOP3),
# T1 (2 IADD3), Sigma0 (3 SHF + LOP3), Maj (LOP3), e (IADD), a (IADD3) = 14;
# a schedule word is sigma0 and sigma1 (2 SHF + SHR + LOP3 each) and 2 IADD3
# = 10; the feed-forward is 8 adds.
OPS_COMPRESS_ROUNDS = 64 * 14 + 8
OPS_SCHEDULE = 48 * 10
K1_SOURCE = "pos_evolution_tpu_torch/csrc/agg_sig.cu"
K1_REPLACES = "pos_evolution_tpu/ops/pallas_aggregation.py:47"
FAKEBLS_PREFIX = b"fakebls-sig-pad!"
STAGES = ("registry", "shuffle", "sign", "verify", "head", "sweep")

# K2 per pair: the message compression with its schedule, then the padding
# block's compression from a precomputed schedule (2,288 instructions); two
# 32-byte nodes read, one written.
OPS_K2_PAIR = 2 * OPS_COMPRESS_ROUNDS + OPS_SCHEDULE
BYTES_K2_PAIR = 96
K2_SOURCE = "pos_evolution_tpu_torch/csrc/merkle_level.cu"
K2_REPLACES = "pos_evolution_tpu/ops/pallas_sha256.py:88"
K2_LARGEST = 4_194_304          # the validator leaves' first level at N = 2^20
ROOT_STAGES = ("load", "pre", "epoch", "post")
SMALL = dict(slots=4, committees_per_slot=4, capacity=16, shuffle_rounds=10)

# the dense path: 2^20 validators, mainnet config, 4 epochs
DENSE_EPOCHS = 4
DENSE_SMALL = dict(slots_per_epoch=8, max_committees_per_slot=4)
# SM count and boost clock of the H100 SXM; its INT32 pipe has 64 lanes per
# SM, where LOP3 and SHF issue and nowhere else
H100_SMS, H100_CLOCK_HZ, INT32_LANES = 132, 1.98e9, 64
INT_PIPE_LANE_OPS_PER_S = H100_SMS * INT32_LANES * H100_CLOCK_HZ

# the BLS path (BASELINE config 3): 2048 aggregates of 128 lanes, 262,144
# signers; its Miller loop runs the doubled batch of 4096 lanes
BLS_AGGREGATES, BLS_SIGNERS = 2048, 262_144
BLS_LANES = 2 * BLS_AGGREGATES
BLS_SMALL, BLS_ORACLE = 2, 8
FIELD_KERNELS = {   # name -> (source, the JAX function it replaces)
    "fp_modmul": ("pos_evolution_tpu_torch/csrc/fp_modmul.cu", "pos_evolution_tpu/ops/fp.py:204"),
    "fp_addsub": ("pos_evolution_tpu_torch/csrc/fp_addsub.cu", "pos_evolution_tpu/ops/fp.py:210"),
    "alg_mul": ("pos_evolution_tpu_torch/csrc/alg_mul.cu", "pos_evolution_tpu/ops/tower.py:129"),
}
FQ_BYTES = 128                       # one element: 32 int32 digits
# 32x32->64-bit partial products of one K3 product: 12 x 12 for a * b, 13 x 13
# for the quotient estimate, 78 for its low product with p. Hopper issues 64
# 32-bit integer multiplies per SM per clock (the CUDA guide's table, cc 9.0),
# one IMAD.WIDE each at best.
PP_MODMUL = 144 + 169 + 78
IMUL_PER_S = H100_SMS * 64 * H100_CLOCK_HZ
# (d, sparse slots) of K5's calls on the path: Fq2, Fq6, Fq12 and the line
ALG_SHAPES = ((2, None), (6, None), (12, None), (12, (0, 1, 2, 3, 8, 9)))
ADDSUB_OPS = ("modadd", "modsub", "modneg", "canon")     # K4's one-step tapes


def say(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fakebls_aggregate(pubkeys, members, bits, msg: bytes) -> bytes:
    """XOR of hashlib FakeBLS signatures (prefix | pubkey | msg, then two
    chain hashes) over the set-bit members."""
    acc = np.zeros(96, np.uint8)
    for v, b in zip(members, bits):
        if b:
            h1 = hashlib.sha256(FAKEBLS_PREFIX + pubkeys[v].tobytes() + msg).digest()
            h2 = hashlib.sha256(h1).digest()
            h3 = hashlib.sha256(h2).digest()
            acc ^= np.frombuffer(h1 + h2 + h3, np.uint8)
    return acc.tobytes()


def spec_shuffled_index(index: int, n: int, seed: bytes, rounds: int) -> int:
    """The spec's scalar swap-or-not shuffle, written out with hashlib."""
    for r in range(rounds):
        h = hashlib.sha256(seed + bytes([r])).digest()
        pivot = int.from_bytes(h[:8], "little") % n
        flip = (pivot + n - index) % n
        position = max(index, flip)
        source = hashlib.sha256(seed + bytes([r])
                                + (position // 256).to_bytes(4, "little")).digest()
        if (source[(position % 256) // 8] >> (position % 8)) % 2:
            index = flip
    return index


def stage_ms(inputs, dev) -> list:
    """ms of each of ``STAGES``: ``run_epoch``'s stages called one by one,
    with a CUDA event recorded after each."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
    ev[0].record()
    t = load_inputs(inputs, dev)
    ev[1].record()
    committees = epoch_committees(inputs, dev)
    ev[2].record()
    aggs = aggregate_signatures_batch(t.pk_states, committees, t.bits, t.msg_words)
    ev[3].record()
    aggregate_verify_batch(t.pk_states, committees, t.bits, t.msg_words, aggs)
    ev[4].record()
    head_passes(t.store, inputs)
    ev[5].record()
    process_epoch_dense(t.registry, *inputs.sweep_args, inputs.cfg)
    ev[6].record()
    torch.cuda.synchronize()
    return [x.elapsed_time(y) for x, y in zip(ev, ev[1:])]


def mismatches(a, b, path="out"):
    """Names of the tensor leaves of two output trees that differ."""
    if isinstance(a, torch.Tensor):
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        return [] if same else [path]
    names = getattr(a, "_fields", range(len(a)))
    return [m for name, x, y in zip(names, a, b) for m in mismatches(x, y, f"{path}.{name}")]


def k1_bound(bits: torch.Tensor, a: int) -> dict:
    """Least time for K1's work on this run's inputs: the set-bit signers'
    midstate rows (32 B), committee indices (4 B) and bits (1 B) per lane,
    messages and the output once; 3 compressions per set-bit signer
    (the first from a schedule built once per committee) plus masking and
    folding 24 words."""
    n_set = int(bits.sum())
    lanes = bits.numel()
    nbytes = n_set * 32 + lanes * 5 + a * 32 + a * 96
    ops = n_set * (3 * OPS_COMPRESS_ROUNDS + 2 * OPS_SCHEDULE + 48) + a * OPS_SCHEDULE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_LANE_OPS_PER_S * 1e3
    return {"set_bits": n_set, "ops": ops, "bytes": nbytes, "ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def k2_bound(pairs: int) -> dict:
    """Least time for K2's work on ``pairs`` sibling pairs."""
    t_ops = pairs * OPS_K2_PAIR / PEAK_LANE_OPS_PER_S * 1e3
    t_bytes = pairs * BYTES_K2_PAIR / HBM_BYTES_PER_S * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes"}


def rand_words(rng, rows: int, dev) -> torch.Tensor:
    return words_to_torch(rng.integers(0, 2**32, (rows, 8), dtype=np.uint64)
                          .astype(np.uint32), dev)


def row_bytes(t: torch.Tensor) -> bytes:
    return words_to_bytes(words_to_numpy(t))


def sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def validator_root(pubkey: bytes, credentials: bytes, fields) -> bytes:
    """hash_tree_root(Validator) with hashlib: pubkey (two chunks, hashed),
    credentials, then effective balance, slashed and the four epochs, each
    a little-endian uint64 (the bool one byte) in its own chunk."""
    eff, slashed, *epochs = fields
    leaves = [sha(pubkey[:32], pubkey[32:] + bytes(16)), credentials,
              int(eff).to_bytes(8, "little") + bytes(24), bytes([int(slashed)]) + bytes(31)]
    leaves += [int(e).to_bytes(8, "little") + bytes(24) for e in epochs]
    while len(leaves) > 1:
        leaves = [sha(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    return leaves[0]


def tree_branch(tree, index: int) -> list:
    """Branch of leaf ``index`` of a ``ChunkTree``: siblings from its
    occupied levels on the card (zero-subtree roots past a level's end),
    then the zero-subtree roots up to its limit's depth."""
    branch = []
    for d, layer in enumerate(tree.levels[:-1]):
        sib = (index >> d) ^ 1
        branch.append(row_bytes(layer[sib]) if sib < layer.shape[0] else ZERO_HASHES[d])
    depth = _depth_for(tree.limit)
    return branch + ZERO_HASHES[len(tree.levels) - 1:depth]


def root_stage_ms(inputs, dev) -> list:
    """ms of each of ``ROOT_STAGES``: ``run_state_roots``'s stages called
    one by one, with a CUDA event recorded after each."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(ROOT_STAGES) + 1)]
    ev[0].record()
    cols = load_columns(inputs, dev)
    pre_state = registry_state(registry_to_torch(inputs.registry, dev), cols)
    ev[1].record()
    trees = RegistryScaleTrees(inputs.cfg)
    trees.roots(pre_state)
    ev[2].record()
    out = run_epoch(inputs, dev)
    ev[3].record()
    trees.roots(registry_state(out.result.registry, cols))
    ev[4].record()
    torch.cuda.synchronize()
    return [x.elapsed_time(y) for x, y in zip(ev, ev[1:])]


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (host clock,
    ending in a synchronize), the device's busy ms (kernel time summed) and
    each kernel's share of that (``k1_ms``, ``k2_ms``, ``kernel_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    per = {name: 0.0 for name in kernels.KERNELS}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:    # kernels and copies; host ops would count twice
            busy += e.self_device_time_total
            for name in per:
                if f"{name}_kernel" in e.key:
                    per[name] += e.self_device_time_total
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "k1_ms": per["agg_sig"] / 1e3,
            "k2_ms": per["merkle_level"] / 1e3,
            "kernel_ms": {name: us / 1e3 for name, us in per.items()}}


def device_ms(fn, kernel: str, reps: int):
    """Mean device ms per launch of ``kernel`` over ``reps`` calls of ``fn``
    under ``torch.profiler`` (its kernel time, not the host's); None where
    the profiler recorded no time for the kernel."""
    ms = profiled(lambda: [fn() for _ in range(reps)])["kernel_ms"][kernel]
    return ms / reps if ms > 0 else None


def sync_count(fn) -> int:
    """Host syncs of one call of ``fn``, counted by CUDA's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def roots_work(trees, state) -> tuple:
    """(ms, K2 launches, pairs) of one ``trees.roots(state)``."""
    merkle_device.reset_stats()
    before = kernels.launches["merkle_level"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    trees.roots(state)
    end.record()
    end.synchronize()
    return (start.elapsed_time(end), kernels.launches["merkle_level"] - before,
            merkle_device.stats()["pairs"])


def dense_sim(dev, n: int = N_MAINNET, **kw) -> DenseSimulation:
    """The dense path's run: mainnet config and its 90 shuffle rounds, or
    the tests' small config below 2^20."""
    cfg = mainnet_config() if n == N_MAINNET else mainnet_config().replace(**DENSE_SMALL)
    kw.setdefault("shuffle_rounds", cfg.shuffle_round_count if n == N_MAINNET else 6)
    return DenseSimulation(n, cfg, device=dev, **kw)


def chaos_sim(dev, n: int, seed: int = 21) -> DenseSimulation:
    """The faulted and adversarial composition of the CPU tests, its crash
    window and the equivocator's share scaled to ``n``."""
    plan = DenseFaultPlan(seed=seed, drop_p=0.1, delay_p=0.08, gst_slot=10,
                          crashes=(DenseCrashWindow(n * 300 // 384, n * 340 // 384, 3, 9),))
    return dense_sim(dev, n, seed=seed, check_walk_every=0, fault_plan=plan,
                     adversaries=[DenseEquivocator(controlled=range(n * 24 // 384), seed=2)],
                     monitors=default_dense_monitors(parity_every=4))


def run_record(sim, epochs: int) -> dict:
    """Run ``sim`` to ``epochs`` and what two runs must agree on."""
    sim.run_epochs(epochs)
    summary = sim.summary()
    summary.pop("dense_phases", None)
    return {"metrics": sim.metrics, "summary": summary,
            "violations": [(v["monitor"], v["kind"], v["slot"]) for v in sim.monitor_violations],
            "implicated": [np.flatnonzero(m.implicated).tolist() for m in sim.monitors
                           if hasattr(m, "implicated")],
            "digest": state_digest(sim)}


def sass_census() -> dict:
    """Each kernel's SASS from its built library (``cuobjdump -sass``), by
    opcode group: {kernel: {"body": {...}, "total": {...}}}. K1's body is
    what follows the block's barrier (every signer runs it; before it,
    warp 0 builds the schedule once per block); K2's is the whole kernel
    (one pair per thread, straight-line). None when cuobjdump is absent."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    line_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    groups = ("LOP3", "SHF", "IADD3", "IMAD")
    out = {}
    for name in kernels.KERNELS:
        text = subprocess.run([tool, "-sass", str(kernels._library_path(name))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        ops = line_re.findall(text)
        if name == "agg_sig":
            cut = next(i for i, op in enumerate(ops) if op.startswith("BAR"))
            body = ops[cut + 1:]
        else:
            body = ops
        def census(seq):
            c = {g: 0 for g in (*groups, "other")}
            for op in seq:
                base = op.split(".")[0]
                c[base if base in groups else "other"] += 1
            c["all"] = len(seq)
            c["IMAD_WIDE"] = sum(op.startswith("IMAD.WIDE") for op in seq)   # within IMAD
            return c
        out[name] = {"body": census(body), "total": census(ops)}
    return out


def sass_bounds(census: dict, units: int) -> dict:
    """Least ms for ``units`` signers or pairs at ``census`` instructions
    each: the issue bound (every instruction at 128 lanes per SM per
    clock), the integer-pipe bound (LOP3 and SHF at 64), and that bound
    with IADD3 on the integer pipe too."""
    issue = units * census["all"] / PEAK_LANE_OPS_PER_S * 1e3
    int_only = units * (census["LOP3"] + census["SHF"]) / INT_PIPE_LANE_OPS_PER_S * 1e3
    int_iadd = units * (census["LOP3"] + census["SHF"] + census["IADD3"]) \
        / INT_PIPE_LANE_OPS_PER_S * 1e3
    imul = units * census["IMAD"] / IMUL_PER_S * 1e3
    return {"issue_ms": issue, "int_pipe_ms": int_only, "int_pipe_with_iadd3_ms": int_iadd,
            "imad_ms": imul}


def field_digits(rng, shape, edges: bool = True) -> torch.Tensor:
    """Canonical int32 digits [*shape, 32] of seeded values in [0, 2p)
    (the top digit drawn below 2p's), the edge values 0, 1, p-1, p, 2p-1
    in the first rows."""
    d = rng.integers(0, 1 << fp.BITS, (*shape, fp.L), dtype=np.int32)
    d[..., -1] = rng.integers(0, int(fp.TWO_P[-1]), shape, dtype=np.int32)
    if edges:
        flat = d.reshape(-1, fp.L)
        for i, v in enumerate((0, 1, fp.P_INT - 1, fp.P_INT, 2 * fp.P_INT - 1)[:len(flat)]):
            flat[i] = fp.to_limbs(v)
    return torch.from_numpy(d)


def digit_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def field_bound(nbytes: int, partial_products: int, other_ops: int = 0) -> dict:
    """Least ms for a field kernel's work: its bytes at the memory rate,
    its partial products at the integer-multiply rate (plus any other lane
    instructions at the issue rate), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (partial_products / IMUL_PER_S + other_ops / PEAK_LANE_OPS_PER_S) * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "partial_products": partial_products}


def alg_mul_partial_products(d: int, slots) -> int:
    """One K5 element's partial products: d * dy products as K3, then per
    output component 12 words times each of its nonzero coefficients and
    one Barrett reduction (K3's 169 + 78)."""
    tpos, tneg, _, _ = tower._plan(d, slots)
    nonzero = ((tpos + tneg) != 0).sum(axis=(0, 1))            # per output component
    return d * tpos.shape[1] * PP_MODMUL + int((12 * nonzero + 169 + 78).sum())


def oracle_check(job):
    """The port's oracle copy on one aggregate (run in a worker process):
    FastAggregateVerify of the compressed signature, and the hashed
    message as digits."""
    pubkeys, message, signature = job
    return (oracle.PyBLS.FastAggregateVerify(pubkeys, message, signature),
            g2_affine_encode(oracle.hash_to_g2(message)))


class OpCount:
    """Counts the aten ops that make a new tensor (about one kernel launch
    each on the card) while the ``with`` block runs; views are not counted."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        makes_tensor = {}          # op -> whether it returns a new tensor (schemas are slow to read)

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                new = makes_tensor.get(func)
                if new is None:
                    new = makes_tensor[func] = not any(r.alias_info for r in func._schema.returns)
                counter.ops += new
                return func(*args, **(kwargs or {}))

        self.ops = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def bls_phases(dev, card: str, census) -> list:
    """Phases 15-19: the field kernels K3-K5 and the real-BLS verify path
    (BASELINE config 3). Returns K3-K5's rows of the kernels line."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(15)
    err = {}

    # 15. K3-K5 against their plain versions at the path's shapes
    shape3 = (BLS_LANES, 144)                     # an Fq12 multiply's products
    a3, b3 = field_digits(rng, shape3).to(dev), field_digits(rng, shape3).to(dev)
    got = fp.modmul(a3, b3)
    ref = fp._modmul(a3, b3)
    err["fp_modmul"] = digit_err(got, ref)
    check(torch.equal(got, ref), f"K3 differs from its plain version at {shape3}")
    edge_vals = [0, 1, 2, fp.P_INT - 1, fp.P_INT, fp.P_INT + 1, 2 * fp.P_INT - 2,
                 2 * fp.P_INT - 1]
    e = torch.from_numpy(np.stack([fp.to_limbs(v) for v in edge_vals])).to(dev)
    got = fp.modmul(e[:, None], e[None])          # broadcast, products up to (2p - 1)^2
    ref = fp._modmul(e[:, None], e[None])
    err["fp_modmul"] = max(err["fp_modmul"], digit_err(got, ref))
    check(torch.equal(got, ref), "K3 differs from its plain version on the edge values")
    got_np = got.cpu().numpy()
    for i, x in enumerate(edge_vals):
        for j, y in enumerate(edge_vals):
            v = fp.from_limbs(got_np[i, j])
            check(v < 2 * fp.P_INT and v % fp.P_INT == x * y % fp.P_INT,
                  f"K3 edge product {i} x {j} is wrong")
    del got, ref
    shape4 = (BLS_LANES, 12)
    tape_in = {}
    err["fp_addsub"] = 0
    for name, tape in sorted(fp.TAPES.items()):
        lanes = shape4 if name in ADDSUB_OPS else (BLS_LANES,)
        args = [field_digits(rng, lanes + sh).to(dev) for sh in tape.in_shapes]
        tape_in[name] = args
        got, ref = fp.run_tape(tape, *args), fp._run_tape(tape, *args)
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref, strict=True):
            err["fp_addsub"] = max(err["fp_addsub"], digit_err(g, r))
            check(torch.equal(g, r), f"K4 tape {name} differs from its plain version at {lanes}")
    alg_in = {}
    err["alg_mul"] = 0
    for d, slots in ALG_SHAPES:
        dy = d if slots is None else len(slots)
        x, y = field_digits(rng, (BLS_LANES, d)).to(dev), field_digits(rng, (BLS_LANES, dy)).to(dev)
        alg_in[d, slots] = (x, y)
        got, ref = tower.alg_mul(x, y, slots), tower._alg_mul(x, y, slots)
        err["alg_mul"] = max(err["alg_mul"], digit_err(got, ref))
        check(torch.equal(got, ref), f"K5 differs from its plain version at d={d} slots={slots}")
    sq9 = fp.run_tape(fp.TAPES["fq12_cyclotomic_pre"], field_digits(rng, (BLS_LANES, 12)).to(dev))
    got, ref = tower.alg_mul(sq9, sq9), tower._alg_mul(sq9, sq9)
    err["alg_mul"] = max(err["alg_mul"], digit_err(got, ref))
    check(torch.equal(got, ref), "K5 differs from its plain version on a cyclotomic squaring's 9")
    del got, ref, sq9
    torch.cuda.empty_cache()
    say(f"K3 vs plain at {shape3[0]} x {shape3[1]} products and {len(edge_vals)}^2 broadcast "
        f"edge pairs (values checked mod p); K4's {len(tape_in)} tapes ({', '.join(ADDSUB_OPS)} "
        f"at {list(shape4)}, the rest at {BLS_LANES} lanes); K5 at {BLS_LANES} lanes for d = 2, "
        f"6, 12 and the line plan, and {BLS_LANES} x 9 Fq2 squarings: digit-equal "
        f"(max abs digit error {err})")

    # 16. the BLS path, counted
    inputs = bls_verify.build_inputs(BLS_AGGREGATES, BLS_SIGNERS)
    kernels.reset_launches()
    bls = bls_verify.run(inputs, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    s = bls.summary
    check(all(launches[k] > 0 for k in FIELD_KERNELS)
          and launches["agg_sig"] == 0 and launches["merkle_level"] == 0,
          f"BLS path launches {launches}: want K3-K5, and neither K1 nor K2")
    check(s["verified"] == BLS_AGGREGATES and s["negative_control_rejected"] == [0, 1]
          and s["negative_control_passed"] == BLS_AGGREGATES - 2,
          f"BLS verdicts: {s['verified']} verified, negative control {s['negative_control_rejected']}")
    t = bls.tensors
    for name, x in (("msg_g2", t.msg_g2), ("sig_g2", t.sig_g2)):
        check(x.shape == (BLS_AGGREGATES, 2, 2, fp.L) and x.dtype == torch.int32
              and bool(((x >= 0) & (x < 1 << fp.BITS)).all()), f"{name} is not canonical digits")
    say(f"BLS path B={BLS_AGGREGATES} N={BLS_SIGNERS}: launches {launches}; all "
        f"{s['verified']} aggregates verify; the swapped pair {s['negative_control_rejected']} "
        f"fails, the other {s['negative_control_passed']} pass")
    say(f"[{card}] BLS path summary: {json.dumps(s)}")

    # 17. the path at B = 2: kernels == plain on the card == the CPU; the oracle
    small = bls_verify.VerifyTensors(t.pk_table, *(x[:BLS_SMALL] for x in t[1:]))
    runs = {}
    for name, where, plain in (("kernel", dev, False), ("plain", dev, True), ("cpu", "cpu", False)):
        args = [x.to(where) for x in small]
        stages = {}
        before = dict(kernels.launches)
        counter = OpCount() if name != "plain" else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), counter:
            ok = fast_aggregate_verify_batch(*args, plain=plain, stages=stages)
        torch.cuda.synchronize()
        runs[name] = {"ok": ok.cpu(), "stages": {k: v.cpu() for k, v in stages.items()},
                      "s": time.perf_counter() - t0,
                      "launches": {k: kernels.launches[k] - before[k] for k in FIELD_KERNELS},
                      "ops": getattr(counter, "ops", None)}
        del args
    for name in ("plain", "cpu"):
        check(torch.equal(runs[name]["ok"], runs["kernel"]["ok"]), f"B=2 verdicts: {name} differs")
        bad = [k for k, v in runs["kernel"]["stages"].items()
               if not torch.equal(runs[name]["stages"][k], v)]
        check(not bad, f"B=2: the {name} run differs from the kernel run in {bad}")
        check(not any(runs[name]["launches"].values()), f"the {name} run launched a field kernel")
    check(runs["kernel"]["ok"].tolist() == [True] * BLS_SMALL, "B=2 verdicts")
    say(f"[{card}] BLS path at B={BLS_SMALL}: plain=True on the card and the CPU == the kernel "
        f"run (aggregate keys, Miller values, final exponentiation, verdicts); kernel run "
        f"{runs['kernel']['s']:.3f} s, {runs['kernel']['launches']} field-kernel launches and "
        f"{runs['kernel']['ops']} other ops (counted, so slower); plain run on the card "
        f"{runs['plain']['s']:.3f} s, {runs['cpu']['ops']} ops (counted in the CPU run, "
        f"{runs['cpu']['s']:.3f} s)")
    sig_x, sig_sign, _, _ = g2prep.g2_compressed_to_limbs(
        bls_verify._compress(t.sig_g2[:BLS_SMALL]))
    cand, _ = g2prep.hash_to_g2_candidates(inputs.messages[:BLS_SMALL])
    stage_ops = {}
    for stage, fn in (
            ("sig_decompress", lambda: g2prep.g2_decompress_batch(
                torch.from_numpy(sig_x).to(dev), torch.from_numpy(sig_sign).to(dev))),
            ("hash_finish", lambda: g2prep.hash_to_g2_finish(torch.from_numpy(cand).to(dev))),
            ("pairing", lambda: fast_aggregate_verify_batch(*(x.to(dev) for x in small)))):
        before = dict(kernels.launches)
        with torch.inference_mode(), OpCount() as counter:
            fn()
        stage_ops[stage] = {**{k: kernels.launches[k] - before[k] for k in FIELD_KERNELS},
                            "aten_ops": counter.ops}
    say(f"[{card}] BLS verify stages at B={BLS_SMALL}, field-kernel launches and aten ops "
        f"(one per new tensor, the wrappers' outputs included): {json.dumps(stage_ops)}")
    sig_bytes = bls_verify._compress(t.sig_g2[:BLS_ORACLE])
    k = len(inputs.pk_comp)
    jobs = [([inputs.pk_comp[int(v) % k] for v, b in zip(inputs.committees[i], inputs.bits[i]) if b],
             inputs.messages[i], bytes(sig_bytes[i])) for i in range(BLS_ORACLE)]
    jobs += [(jobs[0][0], jobs[0][1], jobs[1][2]), (jobs[1][0], jobs[1][1], jobs[0][2])]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(len(jobs), os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(oracle_check, jobs))
    oracle_s = time.perf_counter() - t0
    check([r[0] for r in results] == [True] * BLS_ORACLE + [False, False],
          f"oracle verdicts {[r[0] for r in results]}")
    check(bls.verdicts[:BLS_ORACLE].all() and not bls.negative[:2].any(),
          "device verdicts differ from the oracle's")
    msg_np = t.msg_g2[:BLS_ORACLE].cpu().numpy()
    check(all(np.array_equal(msg_np[i], results[i][1]) for i in range(BLS_ORACLE)),
          "hashed messages differ from the oracle's hash_to_g2")
    say(f"BLS path: {BLS_ORACLE} aggregates' hashed messages and verdicts, and the swapped "
        f"pair's, == the port's oracle copy (PyBLS.FastAggregateVerify, {oracle_s:.3f} s)")

    # 18. per-launch times against the plain versions and the bounds
    rows = {}
    n3 = BLS_LANES * 144
    by_shape = {}
    # the shape of phase 15, and the pk-sum tree's first level, K3's largest
    # call on the path (K5 makes the Fq12 products itself)
    for x, y in ((a3, b3), (a3[:BLS_AGGREGATES, :64], b3[:BLS_AGGREGATES, :64])):
        x, y = x.contiguous(), y.contiguous()
        n = x.numel() // fp.L
        out3 = torch.empty_like(x)
        by_shape["x".join(map(str, x.shape[:-1]))] = {
            "ms": time_ms(lambda: kernels.launch("fp_modmul", x.data_ptr(), y.data_ptr(),
                                                 out3.data_ptr(), n, stream), 20),
            "plain_ms": time_ms(lambda: fp._modmul(x, y), 2),
            "bound": field_bound(3 * FQ_BYTES * n, PP_MODMUL * n)}
    rows["fp_modmul"] = dict(by_shape[f"{BLS_LANES}x144"], shape=list(shape3),
                             wrapper_ms=time_ms(lambda: fp.modmul(a3, b3), 20),
                             by_shape=by_shape)
    by_tape, raw, kept = {}, {}, []
    for name, args in tape_in.items():
        tape = fp.TAPES[name]
        _, (largs, keep) = fp._tape_launch(tape, args)
        kept.append(keep)                    # any input copies the raw launches read
        n = largs[-1]
        raw[name] = lambda largs=largs: kernels.launch("fp_addsub", *largs, stream)
        by_tape[name] = {
            "lanes": n, "rows": len(tape.rows) + sum(tape.out_rows), "steps": len(tape.steps),
            "ms": time_ms(raw[name], 20),
            "wrapper_ms": time_ms(lambda: fp.run_tape(tape, *args), 20),
            "bound": field_bound((len(tape.rows) + sum(tape.out_rows)) * FQ_BYTES * n, 0)}
        if name in ADDSUB_OPS:
            plain = getattr(fp, "_" + name)
            by_tape[name]["plain_ms"] = time_ms(lambda: plain(*args), 5)
    for name, fn in raw.items():
        by_tape[name]["device_ms"] = device_ms(fn, "fp_addsub", 10)
    a4, b4 = tape_in["modadd"]
    rows["fp_addsub"] = dict(by_tape["modadd"], shape=list(shape4), by_tape=by_tape,
                             wrapper_ms=time_ms(lambda: fp.modadd(a4, b4), 20))
    by_shape = {}
    for (d, slots), (x, y) in alg_in.items():
        dy = y.shape[-2]
        out5 = torch.empty_like(x)
        q = tower._PLAN_ID[d, slots]
        by_shape[f"d{d}" + ("_line" if slots else "")] = {
            "ms": time_ms(lambda: kernels.launch("alg_mul", x.data_ptr(), d * fp.L, y.data_ptr(),
                                                 dy * fp.L, out5.data_ptr(), BLS_LANES, q,
                                                 stream), 20),
            "plain_ms": time_ms(lambda: tower._alg_mul(x, y, slots), 2),
            "wrapper_ms": time_ms(lambda: tower.alg_mul(x, y, slots), 20),
            "bound": field_bound((2 * d + dy) * FQ_BYTES * BLS_LANES,
                                 alg_mul_partial_products(d, slots) * BLS_LANES)}
    for key, ((d, slots), (x, y)) in zip(by_shape, alg_in.items()):
        by_shape[key]["device_ms"] = device_ms(lambda: tower.alg_mul(x, y, slots), "alg_mul", 10)
    x, y = alg_in[12, None]
    rows["alg_mul"] = dict(by_shape["d12"], shape=[BLS_LANES, 12], by_shape=by_shape,
                           wrapper_ms=time_ms(lambda: tower.alg_mul(x, y), 20))
    for name, r in rows.items():
        extra = r.get("by_tape") or r["by_shape"]
        say(f"[{card}] {name} per launch (CUDA events over 20; device_ms by torch.profiler): "
            + "; ".join(
                f"{k} kernel {v['ms']:.4f} ms, device {v.get('device_ms') or float('nan'):.4f} ms, "
                f"wrapper {v.get('wrapper_ms', float('nan')):.4f} ms, plain "
                f"{v.get('plain_ms', float('nan')):.4f} ms, bound {v['bound']['ms']:.4f} ms "
                f"({v['bound']['by']}), {100 * v['bound']['ms'] / v['ms']:.1f}% of it"
                + (f", {v['lanes']} lanes x {v['rows']} rows, {v['steps']} steps" if "rows" in v
                   else "") for k, v in extra.items()))
    torch.cuda.empty_cache()
    with torch.inference_mode():
        prof = profiled(lambda: fast_aggregate_verify_batch(*t))
    say(f"[{card}] BLS pairing stage at B={BLS_AGGREGATES} under torch.profiler: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.2f}%); by kernel "
        + ", ".join(f"{k} {prof['kernel_ms'][k]:.3f} ms" for k in FIELD_KERNELS))
    say(f"[{card}] BLS path: verify {s['verify_s']:.3f} s (signature decompression "
        f"{s['sig_decompress_s']:.3f}, hash-to-G2 {s['hash_to_g2_s']:.3f}, pairing "
        f"{s['pairing_s']:.3f}); {s['aggregates_per_s']:.3f} aggregates/s, "
        f"{s['attestations_per_s']:.1f} attestations/s")

    # 19. the SASS census's bounds for K3 (straight-line, one element a thread),
    # and the census of K4 (a tape interpreter) and K5
    if census is not None:
        b = sass_bounds(census["fp_modmul"]["body"], n3)
        measured = rows["fp_modmul"]["ms"]
        say(f"[{card}] fp_modmul at {n3} elements: measured {measured:.4f} ms; bounds "
            + ", ".join(f"{k} {v:.4f}" for k, v in b.items())
            + f"; imad / measured {b['imad_ms'] / measured:.3f}")
        for name in ("fp_addsub", "alg_mul"):
            say(f"SASS {name} (whole kernel): {json.dumps(census[name]['total'])}")

    out = []
    for name, r in rows.items():
        source, replaces = FIELD_KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": err[name], "matches_plain": True,
                    "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound"]["ms"], "bound_by": r["bound"]["by"],
                    "library_ms": None, "launches_by_stage": {st: v[name] for st, v in
                                                              s["launches"].items()},
                    "wrapper_ms": r["wrapper_ms"],
                    **({k: {kk: {"ms": vv["ms"], "device_ms": vv.get("device_ms"),
                                 "plain_ms": vv.get("plain_ms"),
                                 "wrapper_ms": vv.get("wrapper_ms"),
                                 "bound_ms": vv["bound"]["ms"]} for kk, vv in r[k].items()}
                        for k in ("by_tape", "by_shape") if k in r})})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs one GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    reports = kernels.build_all()
    say(f"build_seconds {time.perf_counter() - t0:.3f}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")
    for name in ("fp_addsub", "alg_mul"):         # the redesigned field kernels: no spills
        spills = [line for line in reports[name].splitlines() if "spill" in line]
        check(spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                             for line in spills), f"{name} spills registers: {spills}")

    # 2. K1 against its plain version at the main path's shapes
    inputs = build_epoch_inputs(N_MAINNET, seed=0)
    a, c = inputs.agg_bits.shape
    check((a, c) == (2048, 512), f"main path shape {(a, c)}")
    pk = precompute_pk_states(inputs.pubkeys, dev)
    perm = shuffle_permutation(inputs.shuffle_seed, N_MAINNET, inputs.shuffle_rounds, dev)
    committees = perm[: a * c].reshape(a, c)
    bits = torch.from_numpy(inputs.agg_bits).to(dev)
    msgs = words_to_torch(inputs.msg_words, dev)
    k1 = committee_aggregates(pk, committees, bits, msgs)
    plain = _committee_aggregates(pk, committees, bits, msgs)
    torch.cuda.synchronize()
    max_abs_err = int(((k1.long() & MASK32) - (plain.long() & MASK32)).abs().max())
    check(max_abs_err == 0 and torch.equal(k1, plain), "K1 differs from its plain version")
    say(f"K1 vs plain at A={a} C={c} N={N_MAINNET}: bit-equal")

    comm_np = committees.cpu().numpy()
    k1_np = words_to_numpy(k1)
    for i in (0, 1, a // 2, a - 1):
        want = fakebls_aggregate(inputs.pubkeys, comm_np[i], inputs.agg_bits[i],
                                 words_to_bytes(inputs.msg_words[i]))
        check(words_to_bytes(k1_np[i]) == want, f"K1 committee {i} differs from hashlib FakeBLS")
    say("K1 vs hashlib FakeBLS on committees 0, 1, A/2, A-1: equal")

    ok = aggregate_verify_batch(pk, committees, bits, msgs, k1)
    check(bool(ok.all()), "honest aggregates must all verify")
    tampered = k1.clone()
    tampered[5, 3] ^= 1
    ok_t = aggregate_verify_batch(pk, committees, bits, msgs, tampered)
    check(not bool(ok_t[5]) and int(ok_t.sum()) == a - 1, "a flipped word must fail only its own")
    empty = bits.clone()
    empty[7] = False
    ok_e = aggregate_verify_batch(pk, committees, empty, msgs, k1)
    check(not bool(ok_e[7]) and int(ok_e.sum()) == a - 1, "an empty bitlist must fail")
    say("verify: honest all True; flipped word False; empty bitlist False")

    # 3. small cross-device reference and the spec shuffle
    small = build_epoch_inputs(4096, seed=3, slots=4, committees_per_slot=4,
                               capacity=16, shuffle_rounds=10)
    bad = mismatches(run_epoch(small, "cpu"), run_epoch(small, dev))
    check(not bad, f"small epoch: card differs from CPU in {bad}")
    perm_np = perm.cpu().numpy()
    for i in (0, 1, 255, 256, 524287, N_MAINNET - 1):
        check(int(perm_np[i]) == spec_shuffled_index(i, N_MAINNET, inputs.shuffle_seed,
                                                      inputs.shuffle_rounds),
              f"shuffle differs from the spec at index {i}")
    say("small epoch (n=4096): card == CPU; shuffle == spec on 6 indices at n=2^20")
    del pk, perm, committees, plain, tampered

    # 4. the main path, counted
    kernels.reset_launches()
    out = run_epoch(inputs, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["agg_sig"] == 2, f"K1 launches on the main path: {launches}")
    check(bool(out.ok.all()), "every honest aggregate must verify on the main path")
    check(out.heads.shape == (inputs.slots,)
          and out.weights.shape == (inputs.slots, inputs.capacity), "head output shapes")
    ref = run_epoch(inputs, dev, plain=True)
    bad = mismatches(out, ref)
    check(not bad, f"main path differs from the plain-aggregation epoch in {bad}")
    say(f"main path n={N_MAINNET}: launches {launches}; all {a} aggregates verify; "
        f"bit-equal to the plain-aggregation epoch; heads {out.heads.tolist()}; "
        f"finalize_epoch {int(out.result.finalize_epoch)}; checksum {checksum_tree(out)}")
    del ref

    # 5. timings
    pk = precompute_pk_states(inputs.pubkeys, dev)
    committees = out.committees
    stream = torch.cuda.current_stream(dev).cuda_stream
    k1_out = torch.zeros((a, 24), dtype=torch.int32, device=dev)

    def k1_kernel():
        k1_out.zero_()
        kernels.launch("agg_sig", pk.data_ptr(), committees.data_ptr(), bits.data_ptr(),
                       msgs.data_ptr(), k1_out.data_ptr(), a, c, stream)

    k1_ms = time_ms(k1_kernel, 20)
    wrapper_ms = time_ms(lambda: committee_aggregates(pk, committees, bits, msgs), 20)
    plain_ms = time_ms(lambda: _committee_aggregates(pk, committees, bits, msgs), 3)
    bound = k1_bound(bits, a)
    bound_ms, bound_by = bound["ms"], bound["by"]
    say(f"[{card}] K1 kernel {k1_ms:.4f} ms/launch (zeroing the output included), "
        f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {bound['set_bits']} set-bit signers, {bound['ops']} lane "
        f"instructions, {bound['bytes']} bytes)")

    epoch_ms = time_ms(lambda: run_epoch(inputs, dev), 2)
    reps = 2
    stages = [sum(col) / reps for col in zip(*(stage_ms(inputs, dev) for _ in range(reps)))]
    say(f"[{card}] epoch n={N_MAINNET}: {epoch_ms:.3f} ms; stages "
        + ", ".join(f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stages)))

    del pk, committees, k1_out, out

    # 6. K2 against its plain version and hashlib
    rng = np.random.default_rng(11)
    k2_err = 0
    for n in (K2_LARGEST, 1, 3, 511, 513):
        layer = rand_words(rng, 2 * n, dev)
        left, right = layer[0::2], layer[1::2]   # a level's even and odd rows, as trees pass them
        got = merkle_level(left, right)
        ref = _merkle_level(left, right)
        torch.cuda.synchronize()
        err = int(((got.long() & MASK32) - (ref.long() & MASK32)).abs().max())
        k2_err = max(k2_err, err)
        check(err == 0 and torch.equal(got, ref), f"K2 differs from its plain version at N={n}")
        if n == K2_LARGEST:
            for i in (0, 1, n // 2, n - 1):
                check(row_bytes(got[i]) == sha(row_bytes(left[i]), row_bytes(right[i])),
                      f"K2 row {i} differs from hashlib")
    before = kernels.launches["merkle_level"]
    check(merkle_level(layer[:0], layer[:0]).shape == (0, 8)
          and kernels.launches["merkle_level"] == before, "a zero-size K2 call must not launch")
    say(f"K2 vs plain at N={K2_LARGEST}, 1, 3, 511, 513 (strided level views): bit-equal; "
        "4 rows == hashlib; N=0 launches nothing")
    del layer, left, right, got, ref

    # 7. the roots path, counted
    kernels.reset_launches()
    merkle_device.reset_stats()
    incremental.reset_stats()
    roots = run_state_roots(inputs, dev)
    torch.cuda.synchronize()
    root_launches = dict(kernels.launches)
    mstats, istats = merkle_device.stats(), incremental.stats()
    want_k2 = 4 * istats["validator_root_passes"] + mstats["batched_launches"]
    check(root_launches["merkle_level"] == want_k2 and root_launches["agg_sig"] == 2,
          f"roots path launches {root_launches}, want K2 {want_k2} and K1 2")
    say(f"roots path n={N_MAINNET}: launches {root_launches} (validator-root passes "
        f"{istats['validator_root_passes']}, sweeper rounds {mstats['batched_launches']}, "
        f"pairs {mstats['pairs']}); dirty after the epoch {roots.dirty}")
    ref = run_state_roots(inputs, dev, plain=True)
    check(ref.pre == roots.pre and ref.post == roots.post,
          "roots differ from the run with the plain versions")
    del ref
    cols = load_columns(inputs, dev)
    post_state = registry_state(roots.epoch.result.registry, cols)
    check(RegistryScaleTrees(inputs.cfg).roots(post_state) == roots.post,
          "incremental post-epoch roots differ from a fresh build")
    n_val = N_MAINNET
    bal = roots.epoch.result.registry.balance.cpu().numpy()
    reg = {f: getattr(roots.epoch.result.registry, f).cpu().numpy()
           for f in ("effective_balance", "slashed", "activation_epoch", "exit_epoch",
                     "withdrawable_epoch")}
    host_cols = validator_columns(inputs)
    bal_tree = roots.trees.fields["balances"].tree
    reg_tree = roots.trees.fields["validators"].reg_tree.tree
    length = n_val.to_bytes(32, "little")
    for v in (0, 123457, n_val - 1):
        c = v // 4
        leaf = bal[4 * c:4 * c + 4].astype("<u8").tobytes()
        branch = tree_branch(bal_tree, c) + [length]
        check(is_valid_merkle_branch(leaf, branch, len(branch), c, roots.post["balances"]),
              f"balance chunk {c} does not prove against the balances root")
        epochs = [2**64 - 1 if int(reg[f][v]) == FAR_FUTURE_I64 else int(reg[f][v])
                  for f in ("activation_epoch", "exit_epoch", "withdrawable_epoch")]
        vroot = validator_root(
            host_cols.pubkeys[v].tobytes(), host_cols.withdrawal_credentials[v].tobytes(),
            [reg["effective_balance"][v], reg["slashed"][v],
             host_cols.activation_eligibility_epoch[v], *epochs])
        branch = tree_branch(reg_tree, v) + [length]
        check(is_valid_merkle_branch(vroot, branch, len(branch), v, roots.post["validators"]),
              f"validator {v} does not prove against the validators root")
    say("roots path: pre and post == the plain-version run; post == fresh build; "
        "balance chunks and validators 0, 123457, 2^20-1 prove by hashlib branches; "
        "post roots " + ", ".join(f"{f} {roots.post[f].hex()[:16]}" for f in FIELDS))

    # 8. small cross-device reference
    small = build_epoch_inputs(4096, seed=3, **SMALL)
    a_cpu, a_dev = run_state_roots(small, "cpu"), run_state_roots(small, dev)
    check((a_cpu.pre, a_cpu.post, a_cpu.dirty) == (a_dev.pre, a_dev.post, a_dev.dirty),
          "small state roots: card differs from CPU")
    say("small state roots (n=4096): card == CPU")

    # 9. timings
    k2 = {}
    for n in (K2_LARGEST, N_MAINNET):
        left, right = rand_words(rng, n, dev), rand_words(rng, n, dev)
        k2_out = torch.empty((n, 8), dtype=torch.int32, device=dev)

        def k2_kernel():
            kernels.launch("merkle_level", left.data_ptr(), 8, right.data_ptr(), 8,
                           k2_out.data_ptr(), n, stream)

        k2[n] = {"ms": time_ms(k2_kernel, 20),
                 "wrapper_ms": time_ms(lambda: merkle_level(left, right), 20),
                 "plain_ms": time_ms(lambda: _merkle_level(left, right), 2),
                 "bound": k2_bound(n)}
        say(f"[{card}] K2 at {n} pairs: kernel {k2[n]['ms']:.4f} ms/launch, wrapper "
            f"{k2[n]['wrapper_ms']:.4f} ms, plain {k2[n]['plain_ms']:.4f} ms, bound "
            f"{k2[n]['bound']['ms']:.4f} ms ({k2[n]['bound']['by']}: {n * OPS_K2_PAIR} lane "
            f"instructions, {n * BYTES_K2_PAIR} bytes)")
    del left, right, k2_out
    pre_state = registry_state(registry_to_torch(inputs.registry, dev), cols)
    builds, updates = [], []
    for _ in range(3):
        trees = RegistryScaleTrees(inputs.cfg)
        builds.append(roots_work(trees, pre_state))
        updates.append(roots_work(trees, post_state))
    for name, runs in (("full build", builds), ("incremental update", updates)):
        ms = [r[0] for r in runs]
        _, launches_k2, pairs = runs[-1]
        b = k2_bound(pairs)
        say(f"[{card}] {name}: {', '.join(f'{x:.3f}' for x in ms)} ms; {launches_k2} K2 "
            f"launches, {pairs} pairs; K2 bound on those pairs {b['ms']:.4f} ms ({b['by']})")
    trees = RegistryScaleTrees(inputs.cfg)
    syncs = {"full build": sync_count(lambda: trees.roots(pre_state)),
             "incremental update": sync_count(lambda: trees.roots(post_state))}
    trees = RegistryScaleTrees(inputs.cfg)
    prof = {"full build": profiled(lambda: trees.roots(pre_state)),
            "incremental update": profiled(lambda: trees.roots(post_state))}
    for name, p in prof.items():
        say(f"[{card}] {name} under torch.profiler: wall {p['wall_ms']:.3f} ms, device busy "
            f"{p['busy_ms']:.3f} ms ({100 * p['busy_ms'] / p['wall_ms']:.1f}%), K2 "
            f"{p['k2_ms']:.3f} ms; host syncs {syncs[name]} (CUDA sync debug mode)")
    reps = 2
    rstages = [sum(col) / reps for col in zip(*(root_stage_ms(inputs, dev) for _ in range(reps)))]
    say(f"[{card}] roots path n={N_MAINNET}: stages "
        + ", ".join(f"{s} {ms:.3f} ms" for s, ms in zip(ROOT_STAGES, rstages)))

    # 10. the dense path, counted
    del pre_state, post_state, cols, trees, roots
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sim = dense_sim(dev, phase_profile=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run_epochs(DENSE_EPOCHS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run_launches = dict(kernels.launches)
    summary = sim.summary()
    before_digest = dict(kernels.launches)
    digest = state_digest(sim)
    torch.cuda.synchronize()
    dense_launches = dict(kernels.launches)
    digest_k2 = dense_launches["merkle_level"] - before_digest["merkle_level"]
    slots = sim.slot
    check(slots == DENSE_EPOCHS * 32, f"dense path ran {slots} slots")
    check(run_launches["agg_sig"] == 2 * slots and run_launches["merkle_level"] == 0,
          f"dense run launches {run_launches}, want K1 twice a slot ({2 * slots})")
    check(digest_k2 > 0 and dense_launches["agg_sig"] == 2 * slots,
          f"state_digest launches {dense_launches}")
    check(all(sim.walk_checks) and summary["resident_head_equals_spec_walk"],
          f"walk checks {sim.walk_checks}")
    check(summary["aggregates_verified"] == 64 * slots,
          f"aggregates verified {summary['aggregates_verified']}")
    check(summary["finality_reached"] and summary["finalized_epoch"] == DENSE_EPOCHS - 2,
          f"finality: {summary}")
    phases = summary.pop("dense_phases")
    say(f"dense path n={N_MAINNET}, {DENSE_EPOCHS} epochs ({slots} slots): launches "
        f"{dense_launches} (K1 {run_launches['agg_sig']} in the run, K2 {digest_k2} in "
        f"state_digest); summary {json.dumps(summary)}; digest {digest}")
    t_plain = time.perf_counter()
    ref_sim = dense_sim(dev, plain=True)
    ref = run_record(ref_sim, DENSE_EPOCHS)
    plain_s = time.perf_counter() - t_plain
    check(ref["metrics"] == sim.metrics and ref["summary"] == summary
          and ref["digest"] == digest, "dense path differs from the plain=True run")
    del ref_sim
    say(f"dense path: metrics, summary and digest == the plain=True run "
        f"({plain_s:.3f} s for its setup, {DENSE_EPOCHS} epochs and digest)")
    committees = torch.from_numpy(
        sim._inv_perm[: 64 * 512].reshape(512, 64).T.astype(np.int32).copy()).to(dev)
    d_bits = torch.from_numpy(np.random.default_rng(5).random((64, 512)) < 0.99).to(dev)
    d_msgs = rand_words(rng, 64, dev)
    d_pk = sim.pk_states
    got = committee_aggregates(d_pk, committees, d_bits, d_msgs)
    want = _committee_aggregates(d_pk, committees, d_bits, d_msgs)
    dense_k1_err = int(((got.long() & MASK32) - (want.long() & MASK32)).abs().max())
    check(dense_k1_err == 0 and torch.equal(got, want), "K1 at (64, 512) differs from plain")
    say("K1 vs plain at the dense path's shape A=64 C=512: bit-equal")

    # 11. faulted and adversarial at 2^20, checkpoint and resume on the card
    t3 = time.perf_counter()
    full = run_record(chaos_sim(dev, N_MAINNET), 2)
    t4 = time.perf_counter()
    half = chaos_sim(dev, N_MAINNET)
    half.run_epochs(1)
    data = half.checkpoint()
    del half
    resumed = run_record(DenseSimulation.resume(data, device=dev), 2)
    bad = [k for k in full if resumed[k] != full[k]]
    check(not bad, f"chaos run: resumed differs from the uninterrupted run in {bad}")
    check(full["summary"]["resident_head_equals_spec_walk"] and full["implicated"][0],
          "chaos run: parity and evidence")
    say(f"chaos n={N_MAINNET}, 2 epochs: {len(full['violations'])} violations, "
        f"{len(full['implicated'][0])} implicated, {full['summary']['n_blocks']} blocks, "
        f"finalized {full['summary']['finalized_epoch']}; checkpoint {len(data)} bytes after "
        f"epoch 1, resumed on the card == uninterrupted (metrics, violations, evidence, "
        f"digest); {(t4 - t3) / 2:.3f} s per chaos epoch")
    del data

    # 12. the dense driver on the card against the CPU at small size
    for label, make, n, epochs in (("honest", dense_sim, 256, 4), ("chaos", chaos_sim, 384, 3)):
        kw = {"seed": 11, "check_walk_every": 8} if label == "honest" else {}
        a_cpu = run_record(make("cpu", n, **kw), epochs)
        a_dev = run_record(make(dev, n, **kw), epochs)
        bad = [k for k in a_cpu if a_cpu[k] != a_dev[k]]
        check(not bad, f"small dense {label} run: card differs from CPU in {bad}")
    say("small dense runs (honest n=256, chaos n=384): card == CPU")

    # 13. dense timings: a steady epoch, then one under the profiler
    t5 = time.perf_counter()
    sim.run_epochs(DENSE_EPOCHS + 1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t5
    prof_dense = profiled(lambda: sim.run_epochs(DENSE_EPOCHS + 2))
    per_epoch = (t2 - t1) / DENSE_EPOCHS
    say(f"[{card}] dense path: setup {t1 - t0:.3f} s, {DENSE_EPOCHS} epochs {t2 - t1:.3f} s "
        f"= {per_epoch:.3f} s per simulated epoch; epoch {DENSE_EPOCHS + 1} alone "
        f"{steady_s:.3f} s; under torch.profiler epoch {DENSE_EPOCHS + 2} wall "
        f"{prof_dense['wall_ms']:.3f} ms, device busy {prof_dense['busy_ms']:.3f} ms "
        f"({100 * prof_dense['busy_ms'] / prof_dense['wall_ms']:.2f}%), K1 "
        f"{prof_dense['k1_ms']:.3f} ms, K2 {prof_dense['k2_ms']:.3f} ms")
    say(f"[{card}] dense phase budget (4 epochs, every 8th slot fenced): "
        + json.dumps(phases))
    t_digest = time_ms(lambda: state_digest(sim), 2)
    d_out = torch.zeros((64, 24), dtype=torch.int32, device=dev)

    def k1_dense():
        d_out.zero_()
        kernels.launch("agg_sig", d_pk.data_ptr(), committees.data_ptr(), d_bits.data_ptr(),
                       d_msgs.data_ptr(), d_out.data_ptr(), 64, 512, stream)

    dense_k1_ms = time_ms(k1_dense, 50)
    dense_plain_ms = time_ms(lambda: _committee_aggregates(d_pk, committees, d_bits, d_msgs), 5)
    dense_bound = k1_bound(d_bits, 64)
    say(f"[{card}] K1 at A=64 C=512: kernel {dense_k1_ms:.4f} ms, plain {dense_plain_ms:.4f} "
        f"ms, bound {dense_bound['ms']:.5f} ms ({dense_bound['by']}); state_digest "
        f"{t_digest:.3f} ms")

    # 14. SASS census and the two bounds
    census = sass_census()
    if census is None:
        say("SASS census: cuobjdump not found")
    else:
        unit = {"agg_sig": "per signer", "merkle_level": "per pair"}
        for name, c in census.items():
            say(f"SASS {name}: {unit.get(name, 'whole kernel')} {json.dumps(c['body'])}; "
                f"whole kernel {json.dumps(c['total'])}")
        signers = int(bits.sum())
        for name, units, measured in (("agg_sig", signers, k1_ms),
                                      ("merkle_level", K2_LARGEST, k2[K2_LARGEST]["ms"]),
                                      ("merkle_level", N_MAINNET, k2[N_MAINNET]["ms"])):
            b = sass_bounds(census[name]["body"], units)
            say(f"[{card}] {name} at {units} units: measured {measured:.4f} ms; bounds "
                + ", ".join(f"{k} {v:.4f}" for k, v in b.items())
                + f"; measured / int_pipe {b['int_pipe_ms'] / measured:.3f}")

    field_rows = bls_phases(dev, card, census)

    big = k2[K2_LARGEST]
    say(card)
    say(json.dumps({"kernels": [{
        "name": "agg_sig", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches["agg_sig"], "max_abs_err": max_abs_err, "matches_plain": True,
        "ms": k1_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "epoch_ms": epoch_ms,
        "dense_launches": dense_launches["agg_sig"], "dense_ms": dense_k1_ms,
        "dense_plain_ms": dense_plain_ms, "dense_bound_ms": dense_bound["ms"],
        "dense_max_abs_err": dense_k1_err}, {
        "name": "merkle_level", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": root_launches["merkle_level"], "max_abs_err": k2_err,
        "matches_plain": True, "pairs": K2_LARGEST, "ms": big["ms"],
        "wrapper_ms": big["wrapper_ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound"]["ms"], "bound_by": big["bound"]["by"], "library_ms": None,
        "ms_1048576": k2[N_MAINNET]["ms"], "full_build_ms": builds[-1][0],
        "update_ms": updates[-1][0], "dense_launches": digest_k2}, *field_rows]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
