// BLS12-381 scalar-field (Fr) Montgomery arithmetic for kernel K10.
//
// An element travels as the JAX package's and the plain version's digit
// vector (pos_evolution_tpu/kzg/fr.py, pos_evolution_tpu_torch/kzg/fr.py):
// 22 little-endian 12-bit digits in int32 (88 bytes), a Montgomery residue
// lazily in [0, 2r) for the radix R = 2^264. Inside a thread it is 8
// little-endian 32-bit words: 2r < 2^256, so the value fits in 256 bits
// (a sum of two residues, up to 4r, does not: mont_add keeps its carry).
// Every operation is exact integer arithmetic, so a kernel returns exactly
// the plain version's digits, not merely the same value mod r. Digit inputs
// must be canonical (each digit < 2^12).
//
// The radix is 2^264, not 2^256: REDC computes
//   m = (T mod 2^264) * n' mod 2^264     (9 words, the top one masked to 8 bits)
//   t = (T + m * r) / 2^264              (a shift by 8 words and 8 bits)
// with n' = -r^-1 mod 2^264. With a, b < 2r and 4r < 2^264, t < 2r without a
// final subtract, as the JAX twin's (fr.py:153-165). add subtracts 2r once
// when the sum reaches it; sub adds 2r on underflow; canon subtracts r once.

#pragma once

#include <cstdint>

#include "fp381.cuh"   // fp381::mul_full, fp381::mul_lo

namespace fr381 {

constexpr int kWords = 8;     // 256 bits
constexpr int kDigits = 22;   // 12-bit digits per element

// r, 2r and n' = -r^-1 mod 2^264 (9 words), little-endian 32-bit words.
// Checked against the Python constants in tests/test_torch_kzg.py.
__constant__ uint32_t kR[8] = {
    0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
    0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};
__constant__ uint32_t kTwoR[8] = {
    0x00000002u, 0xFFFFFFFEu, 0xFFFCB7FDu, 0xA77B4805u,
    0x1343B00Au, 0x6673B010u, 0x533AFA90u, 0xE7DB4EA6u};
__constant__ uint32_t kNp[9] = {
    0xFFFFFFFFu, 0xFFFFFFFEu, 0xFFFE5BFDu, 0x53BA5BFFu,
    0x0004EC06u, 0x181B2C17u, 0xD7BF2839u, 0x3D443AB0u, 0x000000C0u};

// 22 canonical digits (value < 2^256) -> 8 words.
__device__ __forceinline__ void digits_to_words(const uint32_t* d, uint32_t* w) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const uint32_t s0 = d[8 * g], s1 = d[8 * g + 1], s2 = d[8 * g + 2], s3 = d[8 * g + 3];
    const uint32_t s4 = d[8 * g + 4], s5 = d[8 * g + 5];
    const uint32_t s6 = g < 2 ? d[8 * g + 6] : 0u, s7 = g < 2 ? d[8 * g + 7] : 0u;
    w[3 * g] = s0 | (s1 << 12) | (s2 << 24);
    w[3 * g + 1] = (s2 >> 8) | (s3 << 4) | (s4 << 16) | (s5 << 28);
    if (g < 2) w[3 * g + 2] = (s5 >> 4) | (s6 << 8) | (s7 << 20);
  }
}

// 8 words -> 22 canonical digits.
__device__ __forceinline__ void words_to_digits(const uint32_t* w, uint32_t* d) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const uint32_t w0 = w[3 * g], w1 = w[3 * g + 1], w2 = g < 2 ? w[3 * g + 2] : 0u;
    uint32_t* o = d + 8 * g;
    o[0] = w0 & 0xFFFu;
    o[1] = (w0 >> 12) & 0xFFFu;
    o[2] = (w0 >> 24) | ((w1 & 0xFu) << 8);
    o[3] = (w1 >> 4) & 0xFFFu;
    o[4] = (w1 >> 16) & 0xFFFu;
    o[5] = (w1 >> 28) | ((w2 & 0xFFu) << 4);
    if (g < 2) {
      o[6] = (w2 >> 8) & 0xFFFu;
      o[7] = w2 >> 20;
    }
  }
}

// One element's 22 digits from device memory (8-byte aligned: 11 int2 loads).
__device__ __forceinline__ void load(const int32_t* __restrict__ src, uint32_t* w) {
  const int2* s = reinterpret_cast<const int2*>(src);
  uint32_t d[kDigits];
#pragma unroll
  for (int k = 0; k < kDigits / 2; ++k) {
    const int2 v = s[k];
    d[2 * k] = static_cast<uint32_t>(v.x);
    d[2 * k + 1] = static_cast<uint32_t>(v.y);
  }
  digits_to_words(d, w);
}

__device__ __forceinline__ void store(const uint32_t* w, int32_t* __restrict__ dst) {
  uint32_t d[kDigits];
  words_to_digits(w, d);
  int2* o = reinterpret_cast<int2*>(dst);
#pragma unroll
  for (int k = 0; k < kDigits / 2; ++k)
    o[k] = make_int2(static_cast<int32_t>(d[2 * k]), static_cast<int32_t>(d[2 * k + 1]));
}

// r = a - b mod 2^256; returns 1 on underflow (a < b).
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

// r = a + b mod 2^256; returns the carry out of the top word.
__device__ __forceinline__ uint32_t add_raw(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint64_t t = static_cast<uint64_t>(a[k]) + b[k] + carry;
    r[k] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
  return carry;
}

// r = r - m if r >= m, for a constant-memory multiple m of the modulus.
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* m) {
  uint32_t mw[kWords], t[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) mw[k] = m[k];
  const uint32_t under = sub(r, mw, t);
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = under ? r[k] : t[k];
}

// r = REDC(a * b) in [0, 2r), the digits of kzg/fr.py::_mul.
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t t[16], lo[9], np[9], m[9], mr[17], rw[kWords];
  fp381::mul_full<kWords, kWords>(a, b, t);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    lo[i] = t[i];
    np[i] = kNp[i];
  }
  lo[8] &= 0xFFu;                                      // T mod 2^264
  fp381::mul_lo<9>(lo, np, m);
  m[8] &= 0xFFu;                                       // m mod 2^264
#pragma unroll
  for (int i = 0; i < kWords; ++i) rw[i] = kR[i];
  fp381::mul_full<9, kWords>(m, rw, mr);               // m * r, 17 words
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 17; ++k) {                       // u = T + m * r (< 2^520)
    const uint64_t s = static_cast<uint64_t>(mr[k]) + (k < 16 ? t[k] : 0u) + carry;
    mr[k] = static_cast<uint32_t>(s);
    carry = static_cast<uint32_t>(s >> 32);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i)                     // u / 2^264
    r[i] = (mr[8 + i] >> 8) | (mr[9 + i] << 24);
}

// r = a + b, less 2r if >= 2r: kzg/fr.py::_add. The sum reaches 4r > 2^256,
// so its carry out counts: with it the sum exceeds 2r, and the 256-bit
// difference is the exact result (< 2r).
__device__ __forceinline__ void mont_add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  const uint32_t carry = add_raw(a, b, r);
  uint32_t mw[kWords], t[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) mw[k] = kTwoR[k];
  const uint32_t keep = sub(r, mw, t) & (carry ^ 1u);
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = keep ? r[k] : t[k];
}

// r = a - b, plus 2r on underflow: kzg/fr.py::_sub.
__device__ __forceinline__ void mont_sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  const uint32_t mask = 0u - sub(a, b, r);
  uint32_t twor[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) twor[k] = kTwoR[k] & mask;
  add_raw(r, twor, r);
}

// [0, 2r) -> [0, r): kzg/fr.py::_canon.
__device__ __forceinline__ void canon(uint32_t* r) { cond_sub(r, kR); }

}  // namespace fr381
