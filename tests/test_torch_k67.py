"""The arithmetic of kernels K6 and K7 as the CUDA sources lay it out,
modelled in numpy and held to the references on the CPU (no card needed).

K7 (``csrc/gf256_matmul.cu``) runs the GF(2^8) product as a GF(2)
bit-matrix product on the int8 tensor cores: M_a[p][q] = bit p of a * x^q,
x^q by SWAR xtime of four bytes at once under 0x11B, the inner dimension in
chunks of four indices t0..t0+3 with k-slot 4u + j <-> (t0 + j, bit u) and
16 + 4u + j <-> (t0 + j, bit 4 + u). The model below builds the same A and
B registers with the same shifts and masks, multiplies them as integers and
takes each sum's parity.

K6's warp-specialized design (``csrc/sha256_blocks.cu``) splits a block:
the producer expands the schedule with K[t] folded in (W[t] + K[t]), the
consumer runs the rounds from it (``sha256_blocks.cu::round_kw``).
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pos_evolution_tpu.das import erasure as jera  # noqa: E402
from pos_evolution_tpu_torch.das.erasure import GF_EXP, GF_LOG  # noqa: E402
from pos_evolution_tpu_torch.ops.das_verify import _gf_matmul  # noqa: E402
from pos_evolution_tpu_torch.ops.sha256 import _K, H0, _sha256_blocks  # noqa: E402
from pos_evolution_tpu_torch.ssz.hash import _pad_messages  # noqa: E402

BITS = np.uint32(0x01010101)


# --- the K7 model ------------------------------------------------------------------

def pack4(b):
    """(..., 4) bytes -> (...,) uint32, byte j at bits 8j (the card's
    little-endian words)."""
    b = b.astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def unpack4(v):
    """(...,) uint32 -> (..., 4) bytes."""
    return np.stack([(v >> (8 * j)) & 0xFF for j in range(4)], axis=-1).astype(np.uint8)


def xtime4(v):
    """``gf256_matmul.cu::xtime4``: four field elements times x at once."""
    v = v.astype(np.uint32)
    return (((v & np.uint32(0x7F7F7F7F)) << np.uint32(1))
            ^ (((v >> np.uint32(7)) & BITS) * np.uint32(0x1B))).astype(np.uint32)


def powers4(v):
    """V_q = v * x^q for q = 0..7, four bytes a word."""
    out = [v.astype(np.uint32)]
    for _ in range(7):
        out.append(xtime4(out[-1]))
    return out


def k7_model(a, b):
    """(G|1, r, k) x (G, k, W) uint8 -> (G, r, W) uint8 the kernel's way."""
    g = b.shape[0]
    a = np.broadcast_to(a, (g,) + a.shape[1:])
    (_, r, k), w = a.shape, b.shape[2]
    kp = -(-k // 4) * 4                     # the kernel zero-fills past k
    a = np.pad(a, ((0, 0), (0, 0), (0, kp - k)))
    b = np.pad(b, ((0, 0), (0, kp - k), (0, 0)))
    ch = kp // 4
    # A registers (16 columns x 32 k-slots): Wc = bytes b[t0..t0+3][c]; lane u
    # holds (Wc >> u) & BITS (slots 4u..4u+3) and (Wc >> (u + 4)) & BITS (16 + 4u..)
    wc = pack4(b.reshape(g, ch, 4, w).transpose(0, 1, 3, 2))               # (g, ch, W)
    lo = np.stack([(wc >> np.uint32(u)) & BITS for u in range(4)], -1)      # (g, ch, W, u)
    hi = np.stack([(wc >> np.uint32(u + 4)) & BITS for u in range(4)], -1)
    a_reg = np.concatenate([unpack4(lo).reshape(g, ch, w, 16),
                            unpack4(hi).reshape(g, ch, w, 16)], -1)         # (g, ch, W, 32)
    # B registers (32 k-slots x 8 bit rows): V_q = bytes a[i][t0..t0+3] * x^q;
    # bit row p, lane u holds (V_u >> p) & BITS and (V_{4+u} >> p) & BITS
    vq = powers4(pack4(a.reshape(g, r, ch, 4)))                             # 8 x (g, r, ch)
    b_reg = np.stack([
        np.concatenate([unpack4(np.stack([(vq[u] >> np.uint32(p)) & BITS for u in range(4)],
                                         -1)).reshape(g, r, ch, 16),
                        unpack4(np.stack([(vq[4 + u] >> np.uint32(p)) & BITS
                                          for u in range(4)], -1)).reshape(g, r, ch, 16)], -1)
        for p in range(8)], -1)                                             # (g, r, ch, 32, 8)
    sums = np.einsum("gxwk,gixkp->gwip", a_reg.astype(np.int64), b_reg.astype(np.int64))
    assert sums.max(initial=0) <= 8 * k                 # exact in the kernel's int32
    out = ((sums & 1) << np.arange(8)).sum(-1)          # bit p of each byte: a parity
    return out.transpose(0, 2, 1).astype(np.uint8)


def test_k7_bit_matrix_algebra_exhaustive():
    """All 256 x 256 pairs: M_a from four-byte SWAR xtime (a packed four to
    a word, as the kernel packs a[i][t0..t0+3]) times b's bits, each bit
    row's parity, equals the log/exp product."""
    a = np.arange(256, dtype=np.uint8)
    vq = [unpack4(v).reshape(256) for v in powers4(pack4(a.reshape(64, 4)))]
    m = np.stack([(np.stack(vq, -1) >> p) & 1 for p in range(8)], 1)       # (a, p, q)
    b_bits = (a[:, None] >> np.arange(8)) & 1                              # (b, q)
    sums = np.einsum("apq,bq->abp", m.astype(np.int64), b_bits.astype(np.int64))
    got = ((sums & 1) << np.arange(8)).sum(-1)
    la, lb = np.meshgrid(GF_LOG[a], GF_LOG[a], indexing="ij")
    want = np.where((a[:, None] == 0) | (a[None, :] == 0), 0, GF_EXP[la + lb])
    np.testing.assert_array_equal(got, want)
    assert (m[1] == np.eye(8, dtype=m.dtype)).all()     # M_1 is the identity


@pytest.mark.parametrize("ga,g,r,k,w", [(3, 3, 40, 67, 66), (1, 3, 40, 67, 66),
                                        (2, 2, 9, 1, 4), (1, 2, 17, 33, 12)])
def test_k7_model_product_equals_plain_and_jax(ga, g, r, k, w):
    """A random product through the model equals K7's plain version and the
    JAX package's host ``das/erasure.gf_matmul``; A of one group broadcasts."""
    rng = np.random.default_rng(ga * 1000 + r * 10 + k)
    a = rng.integers(0, 256, (ga, r, k)).astype(np.uint8)
    b = rng.integers(0, 256, (g, k, w)).astype(np.uint8)
    a[0, r // 2] = 0
    b[-1, :, w // 3] = 0
    got = k7_model(a, b)
    plain = _gf_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, plain)
    for j in range(g):
        np.testing.assert_array_equal(got[j], jera.gf_matmul(a[j if ga > 1 else 0], b[j]))


# --- the K6 split: the schedule with K folded in, then the rounds --------------------

M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def k6_schedule_kw(block):
    """The producer's half: (N, 16) words -> (N, 64) W[t] + K[t]."""
    w = [block[:, t] for t in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    return np.stack([(w[t] + int(_K[t])) & M32 for t in range(64)], axis=1)


def k6_rounds_kw(state, kw):
    """The consumer's half, ``round_kw``: h + kw and d + h + kw first, then
    x = Sigma1 + Ch, e' = d + h + kw + x and a' = h + kw + x + Sigma0 + Maj."""
    v = [state[:, i] for i in range(8)]
    for t in range(64):
        a, b, c, d, e, f, g, h = v
        hk = (h + kw[:, t]) & M32
        dhk = (d + hk) & M32
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & M32 & g)
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        x = (s1 + ch) & M32
        v = [(((hk + x) & M32) + s0 + maj) & M32, a, b, c, (dhk + x) & M32, e, f, g]
    return (state + np.stack(v, axis=1)) & M32


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 119, 120, 1000, 2048])
def test_k6_split_formulation_equals_hashlib_and_plain(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (5, length)).astype(np.uint8)
    words = _pad_messages(msgs).astype(np.uint64)            # (5, 16 * blocks), big-endian
    state = np.broadcast_to(H0.astype(np.uint64), (5, 8)).copy()
    for b in range(words.shape[1] // 16):
        state = k6_rounds_kw(state, k6_schedule_kw(words[:, 16 * b:16 * (b + 1)]))
    for i, m in enumerate(msgs):
        assert state[i].astype(">u4").tobytes() == hashlib.sha256(m.tobytes()).digest()
    plain = _sha256_blocks(torch.from_numpy(words.astype(np.uint32).view(np.int32)))
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), state.astype(np.uint32))
