// The G1 group operations of K11's bucket route (csrc/g1_bucket.cu,
// g1_fill.cu, g1_totals.cu, g1_reduce.cu), in registers: K4's add and sub, K3's product, the
// doubling, the unified add and the mixed add, and points between memory and
// registers as 32-bit words (144 bytes a Jacobian point) or canonical digits.
// Each equals its plain version in ops/pairing.py op for op (g1_double_jac,
// _g1_add_bucket_plain, _g1_madd_plain); every case is a branch where the
// plain versions select.

#pragma once

#include <cstdint>

#include "fp381.cuh"

namespace g1b {

constexpr int kW = fp381::kWords;          // 12 words a base-field element
constexpr int kPt = 3 * kW;                // 36 words a Jacobian point
constexpr int kPtDigits = 3 * fp381::kDigits;
constexpr int kChunk = 32;                 // sorted entries a fill thread sums (pairing.MSM_CHUNK)
constexpr int kSubMax = 64;                // buckets a totals block (pairing.MSM_SUBTREE)

// --- launch sizes (host) -----------------------------------------------------------

inline bool blocks_ok(long long work, int threads, unsigned* blocks) {
  const long long b = (work + threads - 1) / threads;
  if (b < 1 || b > 0x7FFFFFFFLL) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

// B, the buckets a blob: a power of two in [2, 2^15] (c in [2, 16])
inline bool bucket_count_ok(int nb) { return nb >= 2 && nb <= (1 << 15) && (nb & (nb - 1)) == 0; }

// --- base-field ops: K4's ADD and SUB, K3's product, the case tests ---------------

__device__ __forceinline__ void f_add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  fp381::add(a, b, r);
  fp381::cond_sub(r, fp381::kTwoP);
}

__device__ __forceinline__ void f_sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  const uint32_t mask = 0u - fp381::sub(a, b, r);
  uint32_t twop[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) twop[k] = fp381::kTwoP[k] & mask;
  fp381::add(r, twop, r);
}

__device__ __forceinline__ void f_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  fp381::modmul(a, b, r);
}

// a = 0 mod p (its canonical form, K4's CANON, is zero)
__device__ __forceinline__ bool f_zero(const uint32_t* a) {
  uint32_t x[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) x[k] = a[k];
  fp381::cond_sub(x, fp381::kP);
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < kW; ++k) any |= x[k];
  return any == 0;
}

__device__ __forceinline__ void f_copy(const uint32_t* a, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < kW; ++k) r[k] = a[k];
}

__device__ __forceinline__ void f_set(uint32_t* r, uint32_t low) {
#pragma unroll
  for (int k = 0; k < kW; ++k) r[k] = k == 0 ? low : 0u;
}

// --- the group ops ---------------------------------------------------------------

// P = 2P (a = 0), ops/pairing.py::g1_double_jac's tapes op for op.
__device__ __forceinline__ void dbl(uint32_t* X, uint32_t* Y, uint32_t* Z) {
  uint32_t a[kW], b[kW], c[kW], t[kW], e[kW];
  f_mul(X, X, a);                                  // A = X^2
  f_mul(Y, Y, b);                                  // B = Y^2
  f_add(X, b, t);                                  // X + B
  f_mul(b, b, c);                                  // C = B^2
  f_mul(t, t, t);                                  // (X + B)^2
  f_add(a, a, e);                                  // E = (A + A) + A
  f_add(e, a, e);
  f_mul(Y, Z, Z);                                  // YZ
  f_sub(t, a, t);                                  // D = 2 (((X + B)^2 - A) - C)
  f_sub(t, c, t);
  f_add(t, t, t);
  f_mul(e, e, a);                                  // E^2
  f_add(t, t, b);                                  // 2D
  f_sub(a, b, X);                                  // X3 = E^2 - 2D
  f_sub(t, X, t);                                  // D - X3
  f_mul(e, t, t);                                  // E (D - X3)
  f_add(c, c, c);                                  // 8C
  f_add(c, c, c);
  f_add(c, c, c);
  f_sub(t, c, Y);                                  // Y3 = E (D - X3) - 8C
  f_add(Z, Z, Z);                                  // Z3 = 2 YZ
}

// p (36 words: X, Y, Z) = 2 p, in memory: the doubling as one called
// function, for the kernels whose doublings are a loop (the tables' and the
// reduce's Horner), so that they hold one copy of its code. The adds' rare
// P = Q keeps it inline: a call there costs the fill and the totals spills.
static __device__ __noinline__ void dbl_pt(uint32_t* p) {
  uint32_t X[kW], Y[kW], Z[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    X[k] = p[k];
    Y[k] = p[kW + k];
    Z[k] = p[2 * kW + k];
  }
  dbl(X, Y, Z);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    p[k] = X[k];
    p[kW + k] = Y[k];
    p[2 * kW + k] = Z[k];
  }
}

__device__ __forceinline__ void set_zero(uint32_t* X, uint32_t* Y, uint32_t* Z) {
  f_set(X, 0u);
  f_set(Y, 0u);
  f_set(Z, 0u);
}

// One coordinate (12 words, 16-byte aligned) from global or shared memory.
__device__ __forceinline__ void ld_coord(const uint32_t* src, uint32_t* w) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < kW / 4; ++k) {
    const uint4 v = s[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

// The unified add's body, for add_pt below.
__device__ __forceinline__ void add_regs(uint32_t* X1, uint32_t* Y1, uint32_t* Z1,
                                         const uint32_t* q) {
  uint32_t t[kW];
  ld_coord(q + 2 * kW, t);                         // Z2
  if (f_zero(Z1)) {                                // infinity + Q = Q
    ld_coord(q, X1);
    ld_coord(q + kW, Y1);
    f_copy(t, Z1);
    return;
  }
  if (f_zero(t)) return;                           // P + infinity = P
  uint32_t z1z1[kW], z2z2[kW], u1[kW], u2[kW], s1[kW], s2[kW];
  f_mul(Z1, Z1, z1z1);                             // Z1Z1
  f_mul(t, t, z2z2);                               // Z2Z2
  f_mul(X1, z2z2, u1);                             // U1 = X1 Z2Z2
  f_mul(t, z2z2, z2z2);                            // Z2 Z2Z2
  f_mul(Y1, z2z2, s1);                             // S1
  f_mul(Z1, t, z2z2);                              // Z1 Z2 (z2z2 from here)
  ld_coord(q, t);                                  // X2
  f_mul(t, z1z1, u2);                              // U2 = X2 Z1Z1
  f_mul(Z1, z1z1, z1z1);                           // Z1 Z1Z1
  ld_coord(q + kW, t);                             // Y2
  f_mul(t, z1z1, s2);                              // S2
  f_sub(u2, u1, u2);                               // H = U2 - U1
  f_sub(s2, s1, s2);                               // r = S2 - S1
  if (f_zero(u2)) {                                // same x
    if (f_zero(s2)) {                              // P = Q: 2 (U1, S1, Z1 Z2)
      dbl(u1, s1, z2z2);
      f_copy(u1, X1);
      f_copy(s1, Y1);
      f_copy(z2z2, Z1);
    } else {
      set_zero(X1, Y1, Z1);                        // P = -Q
    }
    return;
  }
  uint32_t h2[kW], h3[kW];
  f_mul(u2, u2, h2);                               // H^2
  f_mul(u2, h2, h3);                               // H^3
  f_mul(u1, h2, u1);                               // V = U1 H^2
  f_mul(s2, s2, h2);                               // r^2
  f_sub(h2, h3, h2);                               // r^2 - H^3
  f_add(u1, u1, z1z1);                             // 2V
  f_sub(h2, z1z1, X1);                             // X3 = r^2 - H^3 - 2V
  f_sub(u1, X1, u1);                               // V - X3
  f_mul(s2, u1, u1);                               // r (V - X3)
  f_mul(s1, h3, h3);                               // S1 H^3
  f_sub(u1, h3, Y1);                               // Y3 = r (V - X3) - S1 H^3
  f_mul(u2, z2z2, Z1);                             // Z3 = H (Z1 Z2)
}

// p (36 words: X1, Y1, Z1) += q (36 words: X2, Y2, Z2), both in memory, Q
// read a coordinate at a time: ops/pairing.py::_g1_add_bucket_plain's values
// and cases. Where P = Q it doubles (U1, S1, Z1 Z2), P scaled by Z2, which
// is live, so that X1, Y1, Z1 and Q's coordinates die after the first
// products. Called, not inlined: a kernel holds one copy of its code, and
// its registers are its own (the callers' live values stay in their frames),
// so nothing spills.
static __device__ __noinline__ void add_pt(uint32_t* p, const uint32_t* q) {
  uint32_t X1[kW], Y1[kW], Z1[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    X1[k] = p[k];
    Y1[k] = p[kW + k];
    Z1[k] = p[2 * kW + k];
  }
  add_regs(X1, Y1, Z1, q);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    p[k] = X1[k];
    p[kW + k] = Y1[k];
    p[2 * kW + k] = Z1[k];
  }
}

// P += (x2, y2), an affine addend (Z2 = 1, or the point at infinity where
// q_inf): the unified add with Z2 = 1, U1 = X1, S1 = Y1, Z1 Z2 = Z1 (11
// products), ops/pairing.py::_g1_madd_plain's values and cases.
__device__ __forceinline__ void madd(uint32_t* X1, uint32_t* Y1, uint32_t* Z1,
                                     const uint32_t* x2, const uint32_t* y2, bool q_inf) {
  if (f_zero(Z1)) {                                // infinity + Q = (x2, y2, 1 or 0)
    f_copy(x2, X1);
    f_copy(y2, Y1);
    f_set(Z1, q_inf ? 0u : 1u);
    return;
  }
  if (q_inf) return;                               // P + infinity = P
  uint32_t zz[kW], u2[kW], s2[kW], h[kW], r[kW];
  f_mul(Z1, Z1, zz);                               // Z1Z1
  f_mul(x2, zz, u2);                               // U2 = x2 Z1Z1
  f_mul(Z1, zz, zz);                               // Z1 Z1Z1
  f_mul(y2, zz, s2);                               // S2
  f_sub(u2, X1, h);                                // H = U2 - X1
  f_sub(s2, Y1, r);                                // r = S2 - Y1
  if (f_zero(h)) {
    if (f_zero(r)) dbl(X1, Y1, Z1);
    else set_zero(X1, Y1, Z1);
    return;
  }
  uint32_t h3[kW], v[kW];
  f_mul(h, h, zz);                                 // H^2
  f_mul(h, zz, h3);                                // H^3
  f_mul(X1, zz, v);                                // V = X1 H^2
  f_mul(r, r, zz);                                 // r^2
  f_sub(zz, h3, zz);                               // r^2 - H^3
  f_add(v, v, u2);                                 // 2V
  f_sub(zz, u2, X1);                               // X3
  f_sub(v, X1, v);                                 // V - X3
  f_mul(r, v, v);                                  // r (V - X3)
  f_mul(Y1, h3, h3);                               // Y1 H^3
  f_sub(v, h3, Y1);                                // Y3
  f_mul(h, Z1, Z1);                                // Z3 = H Z1
}

// --- points in memory ----------------------------------------------------------

__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src, uint32_t* X,
                                           uint32_t* Y, uint32_t* Z) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t w[kPt];
#pragma unroll
  for (int k = 0; k < kPt / 4; ++k) {
    const uint4 v = s[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    X[k] = w[k];
    Y[k] = w[kW + k];
    Z[k] = w[2 * kW + k];
  }
}

__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t* X,
                                            const uint32_t* Y, const uint32_t* Z) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < kW / 4; ++k) {
    d[k] = make_uint4(X[4 * k], X[4 * k + 1], X[4 * k + 2], X[4 * k + 3]);
    d[kW / 4 + k] = make_uint4(Y[4 * k], Y[4 * k + 1], Y[4 * k + 2], Y[4 * k + 3]);
    d[kW / 2 + k] = make_uint4(Z[4 * k], Z[4 * k + 1], Z[4 * k + 2], Z[4 * k + 3]);
  }
}

__device__ __forceinline__ void copy_pt(const uint32_t* __restrict__ src,
                                        uint32_t* __restrict__ dst) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < kPt / 4; ++k) d[k] = s[k];
}

__device__ __forceinline__ void load_digits(const int32_t* __restrict__ src, uint32_t* X,
                                            uint32_t* Y, uint32_t* Z) {
  fp381::load(src, X);
  fp381::load(src + fp381::kDigits, Y);
  fp381::load(src + 2 * fp381::kDigits, Z);
}

__device__ __forceinline__ void store_digits(int32_t* __restrict__ dst, const uint32_t* X,
                                             const uint32_t* Y, const uint32_t* Z) {
  fp381::store(X, dst);
  fp381::store(Y, dst + fp381::kDigits);
  fp381::store(Z, dst + 2 * fp381::kDigits);
}

}  // namespace g1b
