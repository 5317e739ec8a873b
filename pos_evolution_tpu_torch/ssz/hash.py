"""SHA-256 on the host: the spec's ``hash`` and batches of equal-length
messages (the port's copy of ``pos_evolution_tpu/ssz/hash.py``:
``hash_eth2``, ``_pad_messages``, ``sha256_batch`` and ``sha256_pairs``).

These are the oracle and the host path of the port: a hashlib loop for
small batches and the vectorized uint32-lane kernel of the JAX package
for large ones (same bytes either way). ``sha256_pairs``, the spec
layer's merkle combiner, sends large batches to kernel K2 on the active
backend's CUDA device; ``sha256_pairs_host`` never leaves the host. The JAX package's native C++ core
has no counterpart here. The device path is kernel K6
(``ops/sha256.sha256_rows``), padded on the device by ``ops/sha256.pad_words``
to the same bytes as ``_pad_messages``.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["hash_eth2", "sha256", "sha256_batch", "sha256_pairs", "sha256_pairs_host"]


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


hash_eth2 = sha256

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

_H0 = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress(state: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """One compression over a batch: state (N, 8), blocks (N, 16) uint32."""
    w = np.empty(blocks.shape[:-1] + (64,), dtype=np.uint32)
    w[..., :16] = blocks
    for t in range(16, 64):
        s0 = _rotr(w[..., t - 15], 7) ^ _rotr(w[..., t - 15], 18) ^ (w[..., t - 15] >> np.uint32(3))
        s1 = _rotr(w[..., t - 2], 17) ^ _rotr(w[..., t - 2], 19) ^ (w[..., t - 2] >> np.uint32(10))
        w[..., t] = w[..., t - 16] + s0 + w[..., t - 7] + s1
    a, b, c, d, e, f, g, h = (state[..., i].copy() for i in range(8))
    for t in range(64):
        big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + _K[t] + w[..., t]
        big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + big_s0 + maj
    return (state + np.stack([a, b, c, d, e, f, g, h], axis=-1)).astype(np.uint32)


def _pad_messages(msgs: np.ndarray) -> np.ndarray:
    """SHA-256 padding of N equal-length messages: (N, L) uint8 ->
    (N, 16 * blocks) uint32 big-endian words (message, 0x80, zeros, the
    64-bit bit length, to a multiple of 64 bytes)."""
    n, length = msgs.shape
    total = ((length + 1 + 8 + 63) // 64) * 64
    padded = np.zeros((n, total), dtype=np.uint8)
    padded[:, :length] = msgs
    padded[:, length] = 0x80
    padded[:, -8:] = np.frombuffer((length * 8).to_bytes(8, "big"), dtype=np.uint8)
    return padded.reshape(n, -1, 4).view(">u4")[..., 0].astype(np.uint32).reshape(n, -1)


# Below this batch size the lane kernel's ~300 numpy calls per block lose
# to a hashlib loop.
_LANE_THRESHOLD = 1024


def _sha256_lanes(msgs: np.ndarray) -> np.ndarray:
    words = _pad_messages(msgs)
    state = np.broadcast_to(_H0, (msgs.shape[0], 8)).copy()
    for blk in range(words.shape[1] // 16):
        state = _compress(state, words[:, blk * 16:(blk + 1) * 16])
    return state.astype(">u4").view(np.uint8).reshape(msgs.shape[0], 32)


def sha256_batch(msgs: np.ndarray) -> np.ndarray:
    """SHA-256 of N equal-length messages: (N, L) uint8 -> (N, 32) uint8."""
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    if msgs.ndim != 2:
        raise ValueError("sha256_batch expects a (N, L) uint8 array")
    n, length = msgs.shape
    if n == 0:
        return np.empty((0, 32), dtype=np.uint8)
    if n >= _LANE_THRESHOLD:
        return _sha256_lanes(msgs)
    raw = msgs.tobytes()
    return np.frombuffer(b"".join(hashlib.sha256(raw[i * length:(i + 1) * length]).digest()
                                  for i in range(n)), dtype=np.uint8).reshape(n, 32).copy()


def sha256_pairs_host(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """The merkle combiner on the host: sha256(left[i] || right[i]) for
    (N, 32) uint8 rows -> (N, 32) uint8."""
    return sha256_batch(np.concatenate([left, right], axis=1))


def sha256_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """sha256(left[i] || right[i]) for (N, 32) uint8 rows -> (N, 32) uint8:
    kernel K2 on the active backend's device when
    ``ops/merkle_device.device_eligible(N)`` (a CUDA device and at least
    ``merkle_device_min_pairs`` pairs), ``sha256_pairs_host`` otherwise.
    Same bytes either way."""
    from pos_evolution_tpu_torch.ops import merkle_device
    if merkle_device.device_eligible(len(left)):
        return merkle_device.pair_hash_rows(left, right)
    return sha256_pairs_host(left, right)
