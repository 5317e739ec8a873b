// SHA-256 compression as CUDA device functions, shared by the port's kernels.
//
// Counterpart of pos_evolution_tpu/ops/pallas_sha256.py::_schedule and
// ::_rounds. One thread carries one message: every word lives in a register
// (the loops below are fully unrolled, so array indices are compile-time
// constants), the round constants sit in __constant__ memory, where a
// warp-uniform index is a broadcast, and rotates are single funnel shifts.
#pragma once

#include <cstdint>

namespace sha256 {

static __constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

static __constant__ uint32_t kH0[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}

__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

// Message schedule: w[0..15] holds the block; fills w[16..63].
__device__ __forceinline__ void schedule(uint32_t* w) {
#pragma unroll
  for (int t = 16; t < 64; ++t) {
    w[t] = w[t - 16] + small_sigma0(w[t - 15]) + w[t - 7] + small_sigma1(w[t - 2]);
  }
}

__device__ __forceinline__ void round_step(uint32_t v[8], int t, uint32_t wt) {
  const uint32_t e = v[4];
  const uint32_t a = v[0];
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & v[5]) ^ (~e & v[6]);
  const uint32_t t1 = v[7] + s1 + ch + kK[t] + wt;
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
  v[7] = v[6];
  v[6] = v[5];
  v[5] = v[4];
  v[4] = v[3] + t1;
  v[3] = v[2];
  v[2] = v[1];
  v[1] = a;
  v[0] = t1 + s0 + maj;
}

// One compression from a precomputed 64-word schedule (registers, or shared
// memory when every thread of a block hashes the same block). Updates the
// state in place, feed-forward included.
__device__ __forceinline__ void compress_scheduled(uint32_t state[8], const uint32_t* w) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = state[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) round_step(v, t, w[t]);
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] += v[i];
}

// One compression of a 16-word block, schedule computed on the fly in a
// 16-word ring so that only 16 schedule words are live at a time.
__device__ __forceinline__ void compress(uint32_t state[8], const uint32_t block[16]) {
  uint32_t w[16];
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = block[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = state[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      w[t & 15] += small_sigma0(w[(t + 1) & 15]) + w[(t + 9) & 15] +
                   small_sigma1(w[(t + 14) & 15]);
    }
    round_step(v, t, w[t & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] += v[i];
}

// H(digest) for a 32-byte message: the digest, the 0x80 pad bit and a
// 256-bit length fill one block. Replaces `digest` with the new digest.
__device__ __forceinline__ void chain_hash(uint32_t digest[8]) {
  uint32_t block[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) block[i] = digest[i];
  block[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) block[i] = 0u;
  block[15] = 256u;
#pragma unroll
  for (int i = 0; i < 8; ++i) digest[i] = kH0[i];
  compress(digest, block);
}

}  // namespace sha256
