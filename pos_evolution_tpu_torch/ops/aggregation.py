"""Batched FakeBLS committee aggregation and aggregate-verify (port of
``pos_evolution_tpu/ops/aggregation.py`` and of the Pallas kernel
``ops/pallas_aggregation.py::_agg_sig_kernel``).

Per signer the FakeBLS signature is three SHA-256 compressions: the
attestation's message block from the signer's pubkey midstate, then two
chain hashes. A committee's aggregate is the XOR of its set-bit signers'
signatures. ``_committee_aggregates`` is the plain PyTorch version;
``committee_aggregates`` is the wrapper of kernel K1 (``csrc/agg_sig.cu``),
which takes the plain version only for tensors on the CPU.

Word arrays (pk_states, msg_words, signatures, aggregates) are int32 bit
patterns (see ``device.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pos_evolution_tpu_torch.device import i32, resolve_device, u32
from pos_evolution_tpu_torch.ops import kernels
from pos_evolution_tpu_torch.ops.sha256 import h0_state, sha256_blocks, sha256_compress

_PREFIX = b"fakebls-sig-pad!"  # FakeBLS.SIG_PREFIX of the reference scheme


def _pad_block(words, length_bits: int):
    """(..., 8) words -> (..., 16): words | 0x80 pad | zeros | bit length."""
    blk = torch.zeros(words.shape[:-1] + (16,), dtype=torch.int64, device=words.device)
    blk[..., 0:8] = u32(words)
    blk[..., 8] = 0x80000000
    blk[..., 15] = length_bits
    return blk


def _chain_hash(words):
    """H(digest) for (..., 8) digest words (32-byte message, one block)."""
    return sha256_compress(h0_state(words.shape[:-1], words.device),
                           _pad_block(words, 256))


def _msg_block2(msg_words):
    """Second signature block: msg(32) | 0x80 pad | length(96 bytes)."""
    return _pad_block(msg_words, 96 * 8)


def pk_blocks(pubkeys_u8: np.ndarray) -> np.ndarray:
    """The first signature block of each validator, (prefix | pubkey):
    (N, 48) uint8 -> (N, 16) big-endian uint32 words."""
    n = pubkeys_u8.shape[0]
    block = np.zeros((n, 64), dtype=np.uint8)
    block[:, 0:16] = np.frombuffer(_PREFIX, dtype=np.uint8)
    block[:, 16:64] = pubkeys_u8
    return block.view(">u4").astype(np.uint32)


def precompute_pk_states(pubkeys_u8: np.ndarray, device="cuda", *,
                         plain: bool = False) -> torch.Tensor:
    """Per-validator midstate: the SHA-256 state after (prefix | pubkey),
    the first block of every signature the validator makes, by kernel K6
    (``sha256_blocks`` over that block alone, unpadded, leaves exactly this
    state). (N, 48) uint8 -> (N, 8) int32 words on ``device``;
    ``plain=True`` takes K6's plain version."""
    blocks = torch.from_numpy(pk_blocks(np.ascontiguousarray(pubkeys_u8, dtype=np.uint8))
                              .view(np.int32))
    return sha256_blocks(blocks.to(resolve_device(device)), plain=plain)


def _xor_reduce(x, dim: int):
    """XOR of ``x`` along ``dim`` by halving (torch has no XOR reduction)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = x[:half] ^ x[half:]
    return x[0]


def _committee_aggregates(pk_states, committees, bits, msg_words):
    """Plain version of K1: (A, 24) int32 aggregate words.

    pk_states (N, 8) words, committees (A, C) validator indices, bits
    (A, C) bool, msg_words (A, 8) words. The message schedule is computed
    once per committee (its lane axis stays size 1 and broadcasts).
    """
    states = u32(pk_states)[committees.long()]        # (A, C, 8)
    block2 = _msg_block2(msg_words)[:, None, :]        # (A, 1, 16)
    h1 = sha256_compress(states, block2)
    h2 = _chain_hash(h1)
    h3 = _chain_hash(h2)
    sigs = torch.cat([h1, h2, h3], dim=-1)             # (A, C, 24)
    masked = torch.where(bits[..., None], sigs, 0)
    return i32(_xor_reduce(masked, dim=1))


def committee_aggregates(pk_states, committees, bits, msg_words):
    """K1's wrapper. CUDA tensors: launch ``csrc/agg_sig.cu`` on the
    current stream, or raise. CPU tensors: the plain version.

    pk_states (N, 8) int32, committees (A, C) int32, bits (A, C) bool,
    msg_words (A, 8) int32, all contiguous on one device -> (A, 24) int32.
    """
    dev = pk_states.device
    if dev.type == "cpu":
        return _committee_aggregates(pk_states, committees, bits, msg_words)
    if dev.type != "cuda":
        raise ValueError(f"committee_aggregates: no kernel for device {dev}")
    a, c = committees.shape
    n = pk_states.shape[0]
    expect = {"pk_states": (pk_states, torch.int32, (n, 8)),
              "committees": (committees, torch.int32, (a, c)),
              "bits": (bits, torch.bool, (a, c)),
              "msg_words": (msg_words, torch.int32, (a, 8))}
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"committee_aggregates: {name} must be {dtype} "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"committee_aggregates: {name} must be contiguous")
    if pk_states.data_ptr() % 16:
        raise ValueError("committee_aggregates: pk_states must be 16-byte aligned")
    if a > 65535:
        raise ValueError(f"committee_aggregates: at most 65535 committees, got {a}")
    out = torch.zeros((a, 24), dtype=torch.int32, device=dev)
    if committees.numel() == 0:
        return out                      # nothing to launch: every aggregate is zero
    if bool(((committees < 0) | (committees >= n)).any()):
        raise ValueError(f"committee_aggregates: committee index outside [0, {n})")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.launch("agg_sig", pk_states.data_ptr(), committees.data_ptr(),
                       bits.data_ptr(), msg_words.data_ptr(), out.data_ptr(),
                       a, c, stream)
    return out


def _aggregates(plain: bool):
    return _committee_aggregates if plain else committee_aggregates


def aggregate_verify_batch(pk_states, committees, bits, msg_words, signatures,
                           *, plain: bool = False):
    """Verify A committee aggregates at once -> bool[A]: the recomputed
    aggregate equals ``signatures`` (A, 24) and the bitlist is non-empty.
    ``plain=True`` takes the plain version on any device: the reference
    the kernel is held against."""
    agg = _aggregates(plain)(pk_states, committees, bits, msg_words)
    return (agg == i32(signatures)).all(dim=-1) & bits.any(dim=-1)


def aggregate_signatures_batch(pk_states, committees, bits, msg_words,
                               *, plain: bool = False):
    """The signer side: the honest committee aggregates (A, 24) int32, from
    the same pipeline the verifier recomputes."""
    return _aggregates(plain)(pk_states, committees, bits, msg_words)


def aggregate_bits_and_weights(bits, committee_weights):
    """The aggregation duty's tally: bits (A, C) bool, committee_weights
    (A, C) int64 -> (participation counts int32[A], participating weight
    int64[A])."""
    count = bits.sum(dim=-1, dtype=torch.int32)
    weight = torch.where(bits, committee_weights.to(torch.int64), 0).sum(dim=-1)
    return count, weight


def messages_to_words(messages_u8: np.ndarray) -> np.ndarray:
    """(A, 32) uint8 signing roots -> (A, 8) big-endian uint32 words."""
    q = messages_u8.reshape(-1, 8, 4).astype(np.uint32)
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]


def pack_signature_words(sig_bytes_list) -> np.ndarray:
    """List of 96-byte signatures -> (A, 24) uint32 words."""
    raw = np.frombuffer(b"".join(bytes(s) for s in sig_bytes_list), dtype=">u4")
    return raw.astype(np.uint32).reshape(len(sig_bytes_list), 24)
