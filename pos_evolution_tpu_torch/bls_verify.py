"""Real BLS12-381 FastAggregateVerify of an epoch's aggregates, on one device.

The port of ``scripts/bench_config3_real.py``'s ``run`` (BASELINE config 3):
B aggregates of C = N / B lanes over N signers, K distinct keys tiled to N,
every aggregate a real BLS signature (pos-evolution.md:714-717). At the
reference scale B = 2048, N = 262,144 (C = 128), K = 256.

``build_inputs`` makes the JAX script's host draws, in its order and from
its seed: keys, committees, the 0.99 bits with lane 0 set, messages and
the aggregate secret keys. ``run`` then does

    setup (timed, reported):
      pk table     K keys decompressed on the device, tiled to N by gather
      signing      hash-to-G2 of the messages, aggregate sk x H(m) by the
                   device twist ladder, compressed to 96 bytes on the host
    verify path (timed per stage):
      1. signature decompression  g2prep.g2_decompress_batch     [B]
      2. hash-to-G2               g2prep.hash_to_g2_*            [B]
      3. batched pairing          pairing.fast_aggregate_verify_batch
    negative control: signatures 0 and 1 swapped must fail, the rest pass.

Host work stays host work, as in the JAX script (hashlib and one ``pow``
per hash candidate, unpacking the compressed signatures, the aggregate
keys, compressing the signatures) and is timed as stages of its own.
Every field multiply and add runs through kernels K3-K5 on CUDA, or
through their plain versions on the CPU or with ``plain=True``. The
script's watchdog (``utils/watchdog.py``) and its oracle preamble are not
ported.

Run: ``python -m pos_evolution_tpu_torch.bls_verify [--aggregates 2048]
[--signers 262144] [--keys 256] [--seed S] [--device cuda|cpu] [--plain]``
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from pos_evolution_tpu_torch.crypto import bls12_381 as oracle
from pos_evolution_tpu_torch.device import card_line, resolve_device
from pos_evolution_tpu_torch.ops import fp, g2prep, kernels
from pos_evolution_tpu_torch.ops.pairing import (
    fast_aggregate_verify_batch,
    g1_affine_encode,
    g2_affine_encode,
)

SEED = 0xC3
FIELD_KERNELS = ("fp_modmul", "fp_pow", "fp_addsub", "alg_mul")   # fp_pow: K3's ladders


class BlsInputs(NamedTuple):
    """The host draws of ``bench_config3_real.py:79-121``."""
    sks: list                  # K distinct secret keys
    pk_comp: list              # K 48-byte compressed pubkeys
    committees: np.ndarray     # [B, C] int32 validator index per lane
    bits: np.ndarray           # [B, C] bool
    messages: list             # B 32-byte messages
    agg_sk: list               # B aggregate secret keys mod r
    keygen_s: float            # host seconds for the K keys


class VerifyTensors(NamedTuple):
    """The verify path's operands on the device."""
    pk_table: torch.Tensor     # [N, 2, 32]
    committees: torch.Tensor   # [B, C] int32
    bits: torch.Tensor         # [B, C] bool
    msg_g2: torch.Tensor       # [B, 2, 2, 32]
    sig_g2: torch.Tensor       # [B, 2, 2, 32]
    sig_inf: torch.Tensor      # [B] bool


class BlsRun(NamedTuple):
    summary: dict              # the JSON line: stages, verdicts, launches, rates
    tensors: VerifyTensors
    verdicts: torch.Tensor     # [B] bool
    negative: torch.Tensor     # [B] bool, signatures 0 and 1 swapped


def build_inputs(aggregates: int, signers: int, distinct_keys: int = 256,
                 seed: int = SEED) -> BlsInputs:
    """The JAX script's draws: the same generator calls in the same order,
    so the same seed gives the same keys, committees, bits and messages."""
    b, n, k = aggregates, signers, distinct_keys
    c = n // b
    if b * c != n:
        raise ValueError("signers must divide into aggregates")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    sks = [int(rng.integers(2, 2**62)) for _ in range(k)]
    pk_comp = [oracle.g1_compress(oracle.ec_mul(oracle.G1_GEN, sk)) for sk in sks]
    keygen_s = time.perf_counter() - t0
    committees = rng.permutation(n).reshape(b, c).astype(np.int32)
    bits = rng.random((b, c)) < 0.99
    bits[:, 0] = True                            # no empty aggregates
    messages = [rng.bytes(32) for _ in range(b)]
    agg_sk = [sum(sks[int(v) % k] for v in committees[i][bits[i]]) % oracle.R
              for i in range(b)]
    return BlsInputs(sks, pk_comp, committees, bits, messages, agg_sk, keygen_s)


def oracle_tensors(inputs: BlsInputs, device="cuda") -> VerifyTensors:
    """The verify path's operands made by the port's exact oracle instead
    of the device preamble: pubkeys decompressed, messages hashed and
    aggregates signed with Python integers (a reference for small sizes)."""
    dev = resolve_device(device)
    b, c = inputs.committees.shape
    keys = np.stack([g1_affine_encode(oracle.g1_decompress(d)) for d in inputs.pk_comp])
    pk_table = keys[np.arange(b * c) % len(keys)]
    msgs = [oracle.hash_to_g2(m) for m in inputs.messages]
    sigs = [oracle.ec_mul(h, sk) for h, sk in zip(msgs, inputs.agg_sk)]
    return VerifyTensors(
        torch.from_numpy(pk_table).to(dev), torch.from_numpy(inputs.committees).to(dev),
        torch.from_numpy(inputs.bits).to(dev),
        torch.from_numpy(np.stack([g2_affine_encode(h) for h in msgs])).to(dev),
        torch.from_numpy(np.stack([g2_affine_encode(s) for s in sigs])).to(dev),
        torch.tensor([s is None for s in sigs], device=dev))


def _pk_limbs(pk_comp):
    """Compressed pubkeys -> (x limbs [K, 32], sign bool[K]) on the host."""
    xs = np.zeros((len(pk_comp), fp.L), np.int32)
    signs = np.zeros(len(pk_comp), bool)
    for i, d in enumerate(pk_comp):
        v = int.from_bytes(d, "big")
        signs[i] = bool(v & (1 << 381))
        xs[i] = fp.to_limbs(v & ((1 << 381) - 1))
    return xs, signs


def _scalar_bits(scalars, nbits: int = 255) -> np.ndarray:
    """[B, nbits] MSB-first bits of each scalar."""
    out = np.zeros((len(scalars), nbits), bool)
    for i, s in enumerate(scalars):
        out[i] = [(int(s) >> (nbits - 1 - j)) & 1 for j in range(nbits)]
    return out


def _compress(sig_aff: torch.Tensor) -> np.ndarray:
    """Affine signatures [B, 2, 2, 32] -> [B, 96] compressed bytes (host)."""
    a = sig_aff.cpu().numpy()
    rows = []
    for p in a:
        point = (oracle.Fq2(fp.from_limbs(p[0, 0]), fp.from_limbs(p[0, 1])),
                 oracle.Fq2(fp.from_limbs(p[1, 0]), fp.from_limbs(p[1, 1])))
        rows.append(np.frombuffer(oracle.g2_compress(point), np.uint8))
    return np.stack(rows)


class _Stages:
    """Host-clock seconds and field-kernel launches of named stages, each
    ending in a synchronize of the device."""

    def __init__(self, dev: torch.device):
        self.dev, self.seconds, self.launches = dev, {}, {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __call__(self, name, fn, *args):
        self.sync()
        before = {k: kernels.launches[k] for k in FIELD_KERNELS}
        t0 = time.perf_counter()
        out = fn(*args)
        self.sync()
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = {k: kernels.launches[k] - before[k] for k in FIELD_KERNELS}
        return out


def run(inputs: BlsInputs, device="cuda", plain: bool = False) -> BlsRun:
    """Setup, the three timed verify stages and the negative control (see
    the module docstring). ``plain=True`` sends CUDA tensors to the plain
    versions of K3-K5. Raises if a valid aggregate fails or the negative
    control does not reject exactly the swapped pair."""
    dev = resolve_device(device)
    b, c = inputs.committees.shape
    n = b * c
    k = len(inputs.sks)
    st = _Stages(dev)
    with fp.plain_mode(plain), torch.inference_mode():
        # --- setup: pk table, then signing -----------------------------------
        xs, signs = _pk_limbs(inputs.pk_comp)
        pk_uniq, pk_ok = st("pk_decompress", g2prep.g1_decompress_batch,
                            torch.from_numpy(xs).to(dev), torch.from_numpy(signs).to(dev))
        tile = torch.arange(n, device=dev) % k
        pk_table = st("pk_tile", lambda: pk_uniq[tile])
        if not bool(pk_ok.all()):
            raise AssertionError("a pubkey failed to decompress")
        xcand, _ = st("setup_hash_candidates_host", g2prep.hash_to_g2_candidates,
                      inputs.messages)
        msg_aff, ok = st("setup_hash_finish", g2prep.hash_to_g2_finish,
                         torch.from_numpy(xcand).to(dev))
        msg_aff, setup_patched = g2prep.oracle_patch(msg_aff, ok, inputs.messages)
        skbits = st("sign_bits_host", _scalar_bits, inputs.agg_sk)
        sig_aff, sig_inf0 = st("sign", lambda: g2prep.g2_jac_to_affine(
            g2prep.g2_mul_scalar_batch(msg_aff, torch.from_numpy(skbits).to(dev))))
        if bool(sig_inf0.any()):
            raise AssertionError("a signature is at infinity")
        sig_bytes = st("sign_compress_host", _compress, sig_aff)

        # --- verify path -----------------------------------------------------
        xl, sg, inf, noncanon = st("sig_unpack_host", g2prep.g2_compressed_to_limbs,
                                   sig_bytes)
        if noncanon.any():
            raise AssertionError("non-canonical compressed signature encoding")
        sig_g2, sig_ok = st("sig_decompress", g2prep.g2_decompress_batch,
                            torch.from_numpy(xl).to(dev), torch.from_numpy(sg).to(dev))
        if not bool(sig_ok.all()):
            raise AssertionError("a signature failed to decompress")
        xcand2, _ = st("hash_candidates_host", g2prep.hash_to_g2_candidates, inputs.messages)
        msg_g2, ok2 = st("hash_finish", g2prep.hash_to_g2_finish,
                         torch.from_numpy(xcand2).to(dev))
        msg_g2, patched = g2prep.oracle_patch(msg_g2, ok2, inputs.messages)
        t = VerifyTensors(pk_table, torch.from_numpy(inputs.committees).to(dev),
                          torch.from_numpy(inputs.bits).to(dev), msg_g2, sig_g2,
                          torch.from_numpy(inf).to(dev))
        verdicts = st("pairing", fast_aggregate_verify_batch, *t)
        if not bool(verdicts.all()):
            raise AssertionError(f"{int((~verdicts).sum())} valid aggregates failed to verify")

        # --- negative control: swapped signatures must fail --------------------
        swapped = sig_g2.clone()
        swapped[[0, 1]] = sig_g2[[1, 0]]
        negative = st("negative_control", fast_aggregate_verify_batch,
                      *t._replace(sig_g2=swapped))
        rejected = torch.nonzero(~negative).flatten().tolist()
        if rejected != [0, 1]:
            raise AssertionError(f"negative control rejected {rejected}, want [0, 1]")

    verify_stages = ("sig_unpack_host", "sig_decompress", "hash_candidates_host",
                     "hash_finish", "pairing")
    verify_s = sum(st.seconds[s] for s in verify_stages)
    signed = int(inputs.bits.sum())
    summary = {
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "plain": plain,
        "aggregates": b, "signers": n, "lanes_per_aggregate": c, "distinct_keys": k,
        "participating_signers": signed,
        "keygen_host_s": inputs.keygen_s,
        "stage_s": st.seconds,
        "verify_s": verify_s,
        "sig_decompress_s": st.seconds["sig_unpack_host"] + st.seconds["sig_decompress"],
        "hash_to_g2_s": st.seconds["hash_candidates_host"] + st.seconds["hash_finish"],
        "pairing_s": st.seconds["pairing"],
        "verified": int(verdicts.sum()),
        "negative_control_rejected": rejected,
        "negative_control_passed": int(negative.sum()),
        "hash_oracle_rows": {"setup": setup_patched, "verify": patched},
        "launches": st.launches,
        "verify_launches": {kn: sum(st.launches[s][kn] for s in verify_stages)
                            for kn in FIELD_KERNELS},
        "aggregates_per_s": b / verify_s,
        "attestations_per_s": signed / verify_s,
    }
    return BlsRun(summary, t, verdicts, negative)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aggregates", type=int, default=2048)
    ap.add_argument("--signers", type=int, default=262_144)
    ap.add_argument("--keys", type=int, default=256, help="distinct keys, tiled to signers")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plain", action="store_true",
                    help="CUDA tensors take the plain versions of K3-K5")
    args = ap.parse_args(argv)
    inputs = build_inputs(args.aggregates, args.signers, args.keys, args.seed)
    out = run(inputs, args.device, plain=args.plain)
    print(json.dumps(dict(out.summary, card=card_line(resolve_device(args.device)))))


if __name__ == "__main__":
    main()
