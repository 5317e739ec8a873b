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
   warm-up, and work out K1's bound from this run's inputs.

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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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
from pos_evolution_tpu_torch.ops.epoch import process_epoch_dense  # noqa: E402
from pos_evolution_tpu_torch.ops.shuffle import shuffle_permutation  # noqa: E402

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

    say(card)
    say(json.dumps({"kernels": [{
        "name": "agg_sig", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches["agg_sig"], "max_abs_err": max_abs_err, "matches_plain": True,
        "ms": k1_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "epoch_ms": epoch_ms}]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
