"""SHA-256 as plain PyTorch tensor arithmetic (port of
``pos_evolution_tpu/ops/sha256.py``).

One lane per message: the 64-round compression runs as elementwise ops
over every leading axis at once. Words are int64 values in [0, 2^32)
inside (see ``device.py``); inputs may be any integer dtype, outputs are
int64 values. This is the plain path, on the CPU and the card alike; the
port's CUDA kernels carry the same rounds in ``csrc/sha256.cuh``.

``sha256_blocks`` is the wrapper of kernel K6 (``csrc/sha256_blocks.cu``),
SHA-256 of many equal-length pre-padded messages, whose plain version is
``sha256_words``; ``sha256_rows`` pads byte messages on their device
(``pad_words``) and hashes them through it, the device twin of
``ssz/hash.sha256_batch``.
"""

from __future__ import annotations

import warnings
from functools import lru_cache

import numpy as np
import torch

from pos_evolution_tpu_torch.device import MASK32, i32, resolve_device, u32, words_to_rows
from pos_evolution_tpu_torch.ops import kernels

_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)


def _rotr(x, n: int):
    # x < 2^32, so x << (32 - n) < 2^63: no int64 overflow
    return ((x >> n) | (x << (32 - n))) & MASK32


def h0_state(shape, device) -> torch.Tensor:
    """The initial state broadcast to ``shape + (8,)`` (int64 words)."""
    return torch.as_tensor(H0.astype(np.int64), device=device).expand(*shape, 8)


def _schedule_wk(block: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``w[t] + K[t]`` for the 64 schedule words of (..., 16) block words
    (< 2^32) -> (..., 64). A rotation reads the word doubled into 64 bits
    (x | x << 32: bits n..n+31 of it are ROTR(x, n)), so two rotations cost
    one doubling, two shifts and one mask."""
    m = 0xFFFFFFFF
    w = list(block.unbind(-1))
    for t in range(16, 64):
        x = w[t - 15]
        y = w[t - 2]
        xx = x | (x << 32)
        yy = y | (y << 32)
        s0 = (((xx >> 7) ^ (xx >> 18)) & m) ^ (x >> 3)
        s1 = (((yy >> 17) ^ (yy >> 19)) & m) ^ (y >> 10)
        w.append((w[t - 16] + w[t - 7] + s0 + s1) & m)
    return torch.stack(w, dim=-1) + k


def _rounds(state: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """The 64 rounds over (..., 8) state words and (..., 64) ``w + K``,
    plus the feed-forward."""
    m = 0xFFFFFFFF
    a = state[..., 0]
    b = state[..., 1]
    c = state[..., 2]
    d = state[..., 3]
    e = state[..., 4]
    f = state[..., 5]
    g = state[..., 6]
    h = state[..., 7]
    for t in range(64):
        ee = e | (e << 32)
        t1 = h + (((ee >> 6) ^ (ee >> 11) ^ (ee >> 25)) & m) + (g ^ (e & (f ^ g))) + wk[..., t]
        aa = a | (a << 32)
        s0 = ((aa >> 2) ^ (aa >> 13) ^ (aa >> 22)) & m
        maj = (a & (b | c)) | (b & c)
        h = g
        g = f
        f = e
        e = (d + t1) & m
        d = c
        c = b
        b = a
        a = (t1 + s0 + maj) & m
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=-1)) & m


@lru_cache(maxsize=None)
def _compiled():
    """``_schedule_wk`` and ``_rounds`` through TorchScript, which runs
    their few thousand small tensor ops with less overhead a op than
    eager mode (about twice as fast at the merkle levels' sizes; the same
    ATen ops, so the same words), or as they are where TorchScript is
    unavailable. Scripted at the first call, not at import."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return torch.jit.script(_schedule_wk), torch.jit.script(_rounds)
    except Exception:
        return _schedule_wk, _rounds


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K and the constant ``w + K`` of the padding block of a 64-byte
    message, (64,) int64 on ``device``."""
    k = torch.as_tensor(_K.astype(np.int64), device=device)
    pad = torch.zeros(16, dtype=torch.int64, device=device)
    pad[0], pad[15] = 0x80000000, 512
    return k, _compiled()[0](pad, k)


def sha256_compress(state, block_words):
    """One compression: state (..., 8), block_words (..., 16) -> (..., 8).

    The two leading shapes broadcast against each other, so a block shared
    by many lanes (shape 1 on their axis) has its schedule computed once.
    """
    schedule, rounds = _compiled()
    block = u32(block_words)
    return rounds(u32(state), schedule(block, _constants(block.device)[0]))


def sha256_words(msg_words):
    """SHA-256 over pre-padded messages: (N, 16*blocks) -> (N, 8)."""
    n_blocks = msg_words.shape[-1] // 16
    state = h0_state(msg_words.shape[:-1], msg_words.device)
    for b in range(n_blocks):
        state = sha256_compress(state, msg_words[..., b * 16:(b + 1) * 16])
    return state


def sha256_pair_words(left, right):
    """Merkle combiner H(left || right) for (N, 8) digest words: the
    64-byte message, then the fixed padding block, whose schedule is a
    constant."""
    n = left.shape[0]
    state = sha256_compress(h0_state((n,), left.device),
                            torch.cat([u32(left), u32(right)], dim=-1))
    return _compiled()[1](state, _constants(left.device)[1])


# --- kernel K6 and its plain version ----------------------------------------------

def _sha256_blocks(words):
    """Plain version of K6: ``sha256_words`` as (N, 8) int32 words."""
    return i32(sha256_words(words))


def k6_chains_below() -> int:
    """The message count from which a K6 launch takes one thread a message
    (below it, the warp-specialized chains for messages of at least
    ``k6_chains_min_blocks()`` blocks): the kernel's constant, read from
    its library (built first if needed)."""
    return int(kernels.library("sha256_blocks").sha256_blocks_chains_below())


def k6_chains_min_blocks() -> int:
    """The blocks a message needs for a K6 launch below ``k6_chains_below()``
    messages to take the chains: the kernel's constant."""
    return int(kernels.library("sha256_blocks").sha256_blocks_chains_min_blocks())


def sha256_blocks(words, *, plain: bool = False):
    """K6's wrapper: SHA-256 of N pre-padded messages, (N, 16 * blocks)
    int32 big-endian words -> (N, 8) int32 digest words. CUDA tensors:
    launch ``csrc/sha256_blocks.cu`` on the current stream (its design
    chosen by N and the blocks, ``k6_chains_below``), or raise; rows may be
    strided, each 16-byte aligned. CPU tensors, or ``plain=True`` on any
    device: the plain version. N = 0 returns an empty result without a
    launch."""
    dev = words.device
    if plain or dev.type == "cpu":
        return _sha256_blocks(words)
    if dev.type != "cuda":
        raise ValueError(f"sha256_blocks: no kernel for device {dev}")
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[1] % 16 \
            or not words.shape[1]:
        raise ValueError(f"sha256_blocks: words must be int32 (N, 16 * blocks), blocks >= 1, "
                         f"got {words.dtype} {tuple(words.shape)}")
    if words.stride(1) != 1 or words.stride(0) % 4 or words.data_ptr() % 16:
        raise ValueError(f"sha256_blocks: rows must be contiguous words, 16-byte aligned "
                         f"(strides {words.stride()})")
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if n >= 2**31:
        raise ValueError(f"sha256_blocks: at most 2^31 - 1 messages, got {n}")
    kernels.launch_on(dev, "sha256_blocks", words.data_ptr(), words.stride(0),
                      words.shape[1] // 16, out.data_ptr(), n)
    return out


def pad_words(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 padding of (N, L) uint8 messages on their device -> (N, 16 *
    blocks) int32 big-endian words (``ssz/hash._pad_messages``'s bytes)."""
    n, length = msgs.shape
    total = ((length + 1 + 8 + 63) // 64) * 64
    padded = torch.zeros((n, total), dtype=torch.uint8, device=msgs.device)
    padded[:, :length] = msgs
    padded[:, length] = 0x80
    padded[:, -8:] = torch.tensor(list((length * 8).to_bytes(8, "big")), dtype=torch.uint8,
                                  device=msgs.device)
    return padded.reshape(n, -1, 4).flip(-1).contiguous().view(torch.int32).reshape(n, -1)


def sha256_rows(msgs, device="cuda", *, plain: bool = False) -> torch.Tensor:
    """SHA-256 of N equal-length byte messages through K6: (N, L) uint8 ->
    (N, 32) uint8 digest rows, the bytes of ``ssz/hash.sha256_batch``. A
    numpy array goes to ``device`` (CUDA unless the caller asks for
    another), a tensor stays where it lies; either is padded there
    (``pad_words``) and hashed. ``plain=True``: K6's plain version."""
    if not isinstance(msgs, torch.Tensor):
        msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
        if msgs.ndim != 2:
            raise ValueError("sha256_rows expects a (N, L) uint8 array")
        msgs = torch.from_numpy(msgs).to(resolve_device(device))
    if msgs.shape[0] == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=msgs.device)
    return words_to_rows(sha256_blocks(pad_words(msgs), plain=plain))
