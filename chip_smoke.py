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
   path's stages, and work out K2's bound from this run's pair counts.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and
prints no result. Run from the repository root: ``python3 chip_smoke.py``.
"""

import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pos_evolution_tpu_torch.convert import registry_to_torch  # noqa: E402
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
from pos_evolution_tpu_torch.ops import kernels  # noqa: E402
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
    K2's share of that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = k2_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:    # kernels and copies; host ops would count twice
            busy += e.self_device_time_total
            if "merkle_level" in e.key:
                k2_us += e.self_device_time_total
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "k2_ms": k2_us / 1e3}


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

    big = k2[K2_LARGEST]
    say(card)
    say(json.dumps({"kernels": [{
        "name": "agg_sig", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches["agg_sig"], "max_abs_err": max_abs_err, "matches_plain": True,
        "ms": k1_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "epoch_ms": epoch_ms}, {
        "name": "merkle_level", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": root_launches["merkle_level"], "max_abs_err": k2_err,
        "matches_plain": True, "pairs": K2_LARGEST, "ms": big["ms"],
        "wrapper_ms": big["wrapper_ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound"]["ms"], "bound_by": big["bound"]["by"], "library_ms": None,
        "ms_1048576": k2[N_MAINNET]["ms"], "full_build_ms": builds[-1][0],
        "update_ms": updates[-1][0]}]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
