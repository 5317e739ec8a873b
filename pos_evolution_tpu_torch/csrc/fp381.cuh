// BLS12-381 base-field arithmetic for the port's field kernels (K3-K5).
//
// An element travels as the JAX package's and the plain version's digit
// vector: 32 little-endian 12-bit digits in int32 (128 bytes), a lazy
// residue in [0, 2p). Inside a thread it is 12 little-endian 32-bit words
// (384 bits) in registers, and every operation is exact integer arithmetic
// on those words with 64-bit partial products, so a kernel returns exactly
// the digits of pos_evolution_tpu/ops/fp.py, not merely the same value mod
// p. Digit inputs must be canonical (each digit < 2^12): the conversion
// below packs them without carries.
//
// The reduction is the JAX package's plain Barrett (ops/fp.py:179), not
// Montgomery: with MU = floor(2^768 / p) and x < p * 2^384,
//   q_hat = floor(floor(x / 2^372) * MU / 2^396) mod 2^384,
//   r     = (x - q_hat * p) mod 2^384,
//   out   = r - 2p if r >= 2p else r.
// Its digit algorithm truncates at the same places (the 33-digit window
// x[31:], quotient digits 33..64, 32-digit remainder), which the word
// shifts below reproduce: 372 = 11 * 32 + 20 and 396 = 12 * 32 + 12.

#pragma once

#include <cstdint>

namespace fp381 {

constexpr int kWords = 12;    // 384 bits
constexpr int kDigits = 32;   // 12-bit digits per element

// p, 2p and MU = floor(2^768 / p) (388 bits), little-endian 32-bit words.
// Checked against the Python constants in tests/test_torch_fp.py.
__constant__ uint32_t kP[12] = {
    0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u, 0x6730D2A0u,
    0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu};
__constant__ uint32_t kTwoP[12] = {
    0xFFFF5556u, 0x73FDFFFFu, 0x62A7FFFFu, 0x3D57FFFDu, 0xED61EC48u, 0xCE61A541u,
    0xE70A257Eu, 0xC8EE9709u, 0x869759AEu, 0x96374F6Cu, 0x72FFCD34u, 0x340223D4u};
__constant__ uint32_t kMu[13] = {
    0x6591BA2Eu, 0x13E207F5u, 0x58F1C07Bu, 0x997167A0u, 0x286779D3u, 0xDF4771E0u,
    0xF6A0A94Bu, 0x1B82741Fu, 0xC7A6BA29u, 0x28101B0Cu, 0xCC9E45CEu, 0xD835D2F3u,
    0x00000009u};

// 32 canonical digits (8 groups of 96 bits) -> 12 words.
__device__ __forceinline__ void digits_to_words(const uint32_t* d, uint32_t* w) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t* s = d + 8 * g;
    w[3 * g] = s[0] | (s[1] << 12) | (s[2] << 24);
    w[3 * g + 1] = (s[2] >> 8) | (s[3] << 4) | (s[4] << 16) | (s[5] << 28);
    w[3 * g + 2] = (s[5] >> 4) | (s[6] << 8) | (s[7] << 20);
  }
}

// 12 words -> 32 canonical digits.
__device__ __forceinline__ void words_to_digits(const uint32_t* w, uint32_t* d) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t w0 = w[3 * g], w1 = w[3 * g + 1], w2 = w[3 * g + 2];
    uint32_t* o = d + 8 * g;
    o[0] = w0 & 0xFFFu;
    o[1] = (w0 >> 12) & 0xFFFu;
    o[2] = (w0 >> 24) | ((w1 & 0xFu) << 8);
    o[3] = (w1 >> 4) & 0xFFFu;
    o[4] = (w1 >> 16) & 0xFFFu;
    o[5] = (w1 >> 28) | ((w2 & 0xFFu) << 4);
    o[6] = (w2 >> 8) & 0xFFFu;
    o[7] = w2 >> 20;
  }
}

// One element's digits from device memory (128 bytes, 16-byte aligned).
__device__ __forceinline__ void load(const int32_t* __restrict__ src, uint32_t* w) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t d[kDigits];
#pragma unroll
  for (int k = 0; k < kDigits / 4; ++k) {
    const uint4 v = s[k];
    d[4 * k] = v.x;
    d[4 * k + 1] = v.y;
    d[4 * k + 2] = v.z;
    d[4 * k + 3] = v.w;
  }
  digits_to_words(d, w);
}

__device__ __forceinline__ void store(const uint32_t* w, int32_t* __restrict__ dst) {
  uint32_t d[kDigits];
  words_to_digits(w, d);
  uint4* o = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < kDigits / 4; ++k)
    o[k] = make_uint4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
}

// One element's digits from a row staged in shared memory (8 uint4).
__device__ __forceinline__ void unstage(const uint4* row, uint32_t* w) {
  uint32_t d[kDigits];
#pragma unroll
  for (int k = 0; k < kDigits / 4; ++k) {
    const uint4 v = row[k];
    d[4 * k] = v.x;
    d[4 * k + 1] = v.y;
    d[4 * k + 2] = v.z;
    d[4 * k + 3] = v.w;
  }
  digits_to_words(d, w);
}

// One element's words to a staged row of digits in shared memory.
__device__ __forceinline__ void stage(const uint32_t* w, uint4* row) {
  uint32_t d[kDigits];
  words_to_digits(w, d);
#pragma unroll
  for (int k = 0; k < kDigits / 4; ++k)
    row[k] = make_uint4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
}

// r[0, NA+NB) = a * b, schoolbook by rows; t = a*b + r + c never exceeds 2^64 - 1.
template <int NA, int NB>
__device__ __forceinline__ void mul_full(const uint32_t* a, const uint32_t* b, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NA + NB; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint64_t t = static_cast<uint64_t>(a[i]) * b[j] + r[i + j] + c;
      r[i + j] = static_cast<uint32_t>(t);
      c = t >> 32;
    }
    r[i + NB] = static_cast<uint32_t>(c);
  }
}

// r[0, N) = a * b mod 2^(32 N).
template <int N>
__device__ __forceinline__ void mul_lo(const uint32_t* a, const uint32_t* b, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N - i; ++j) {
      const uint64_t t = static_cast<uint64_t>(a[i]) * b[j] + r[i + j] + c;
      r[i + j] = static_cast<uint32_t>(t);
      c = t >> 32;
    }
  }
}

// r = a - b mod 2^384; returns 1 on underflow (a < b).
__device__ __forceinline__ uint32_t sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint64_t t = static_cast<uint64_t>(a[k]) - b[k] - borrow;
    r[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  return borrow;
}

// r = a + b mod 2^384 (the carry out of the top word is dropped).
__device__ __forceinline__ void add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint64_t t = static_cast<uint64_t>(a[k]) + b[k] + carry;
    r[k] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
}

// r = r - m if r >= m, for a constant-memory modulus multiple m.
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* m) {
  uint32_t mw[kWords], t[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) mw[k] = m[k];
  const uint32_t under = sub(r, mw, t);
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = under ? r[k] : t[k];
}

// Barrett reduction of x (24 words, x < p * 2^384) to [0, 2p), as
// pos_evolution_tpu/ops/fp.py::barrett_reduce computes it.
__device__ __forceinline__ void barrett(const uint32_t* x, uint32_t* r) {
  uint32_t xh[13], mu[13], prod[26], q[kWords], p[kWords], qp[kWords];
#pragma unroll
  for (int i = 0; i < 12; ++i) xh[i] = (x[11 + i] >> 20) | (x[12 + i] << 12);  // x / 2^372
  xh[12] = x[23] >> 20;
#pragma unroll
  for (int i = 0; i < 13; ++i) mu[i] = kMu[i];
  mul_full<13, 13>(xh, mu, prod);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {                   // floor(. / 2^396) mod 2^384
    q[i] = (prod[12 + i] >> 12) | (prod[13 + i] << 20);
    p[i] = kP[i];
  }
  mul_lo<kWords>(q, p, qp);
  sub(x, qp, r);                                       // r < 3p, exact mod 2^384
  cond_sub(r, kTwoP);
}

// r = a * b mod p in [0, 2p), the digits of fp.modmul.
__device__ __forceinline__ void modmul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[24];
  mul_full<kWords, kWords>(a, b, x);
  barrett(x, r);
}

}  // namespace fp381
