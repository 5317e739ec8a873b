// K10: the BLS12-381 scalar-field NTT over Montgomery digits, one launch a
// butterfly stage, and Fr's elementwise ops.
//
// Replaces pos_evolution_tpu/kzg/ntt.py::_device_kernel (:143), the jitted
// Cooley-Tukey ladder of the JAX package, and the field ops it composes,
// pos_evolution_tpu/kzg/fr.py::mul/add/sub/canon (:288-310), XLA-jitted
// functions over [..., 22] int32 digits. The results equal
// pos_evolution_tpu_torch/kzg/ntt.py::_ntt_plain and kzg/fr.py's plain
// versions digit for digit (fr381.cuh: exact arithmetic, the same lazy
// residues in [0, 2r)).
//
// fr_ntt_kernel: stage s of a decimation-in-time transform of size n over G
// rows. One thread a butterfly: with m2 = 2^s, butterfly (block j, k < m2)
// reads rows i0 = 2 m2 j + k and i1 = i0 + m2, multiplies the second by the
// stage's twiddle w_k (the host plan's Montgomery constants, every stage's
// table concatenated, stage s at offset m2 - 1) and writes a + b w_k to i0
// and a - b w_k to i1, as ntt.py::_transform reshapes and stacks. Stage 0
// reads its inputs through the bit-reversal gather (flag 1), and the last
// stage of an inverse multiplies both outputs by n^-1 (flag 2), so the
// gather and the scale take no launches of their own. Stages ping-pong
// between two buffers; a transform of size n is log2 n launches.
//
// fr_ew_kernel: out[e] = op(a[e], b[e]) (MUL, ADD, SUB, CANON, FROM_MONT:
// REDC(a * 1) then canon, INV: a^(r-2) by square-and-multiply from
// Montgomery one, the JAX scan's order, in registers), each operand read at
// its own element stride (0 broadcasts a constant).
//
// Bound on the KZG commit path (9 x 16,384 elements, 14 stages): bytes.
// Each stage reads and writes 88 bytes an element and a twiddle a
// butterfly; a butterfly is one REDC (8x8, 9x9 low and 9x8 word products,
// 190 partial products) and an add and a sub. At 147,456 elements a stage
// moves ~26 MB (7.7 us at 3.35 TB/s) against ~14 M partial products (0.8 us
// on the 64-lane multiplier): bytes bind, and at this size a launch's fixed
// cost is of the same order. The design keeps it simple: one thread an
// element pair, 8-byte loads (an element is 88 bytes, so 16-byte vectors do
// not align), no shared memory, the twiddle read through L1.

#include <cstdint>

#include <cuda_runtime.h>

#include "fr381.cuh"

namespace {

constexpr int kThreads = 128;
enum : int { kMul = 0, kAdd = 1, kSub = 2, kCanon = 3, kFromMont = 4, kInv = 5 };

// Montgomery one (2^264 mod r) and r - 2, little-endian 32-bit words.
__constant__ uint32_t kOneM[8] = {
    0xFFFFFDCBu, 0x00000234u, 0x039EF635u, 0x2E750561u,
    0xBDCE3C3Eu, 0xF1563642u, 0x276A7FA6u, 0x247DB575u};
__constant__ uint32_t kRMinus2[8] = {
    0xFFFFFFFFu, 0xFFFFFFFEu, 0xFFFE5BFEu, 0x53BDA402u,
    0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};

__global__ void __launch_bounds__(kThreads)
fr_ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
              const int32_t* __restrict__ tw, const int32_t* __restrict__ scale,
              int g_rows, int n, int logn, int s, int flags) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int half = n >> 1;
  if (idx >= static_cast<long long>(g_rows) * half) return;
  const long long row = idx / half;
  const int bf = static_cast<int>(idx - row * half);
  const int m2 = 1 << s;
  const int k = bf & (m2 - 1);
  const int i0 = ((bf >> s) << (s + 1)) + k, i1 = i0 + m2;
  int src0 = i0, src1 = i1;
  if (flags & 1) {                                     // the bit-reversal gather
    src0 = static_cast<int>(__brev(static_cast<unsigned>(i0)) >> (32 - logn));
    src1 = static_cast<int>(__brev(static_cast<unsigned>(i1)) >> (32 - logn));
  }
  const int32_t* base = in + row * n * fr381::kDigits;
  uint32_t a[fr381::kWords], b[fr381::kWords], w[fr381::kWords], bw[fr381::kWords];
  uint32_t lo[fr381::kWords], hi[fr381::kWords];
  fr381::load(base + static_cast<long long>(src0) * fr381::kDigits, a);
  fr381::load(base + static_cast<long long>(src1) * fr381::kDigits, b);
  fr381::load(tw + static_cast<long long>(m2 - 1 + k) * fr381::kDigits, w);
  fr381::mont_mul(b, w, bw);
  fr381::mont_add(a, bw, lo);
  fr381::mont_sub(a, bw, hi);
  if (flags & 2) {                                     // the inverse's n^-1
    uint32_t sc[fr381::kWords];
    fr381::load(scale, sc);
    fr381::mont_mul(lo, sc, a);
    fr381::mont_mul(hi, sc, b);
#pragma unroll
    for (int q = 0; q < fr381::kWords; ++q) {
      lo[q] = a[q];
      hi[q] = b[q];
    }
  }
  int32_t* obase = out + row * n * fr381::kDigits;
  fr381::store(lo, obase + static_cast<long long>(i0) * fr381::kDigits);
  fr381::store(hi, obase + static_cast<long long>(i1) * fr381::kDigits);
}

__global__ void __launch_bounds__(kThreads)
fr_ew_kernel(int op, const int32_t* __restrict__ a, long long sa, const int32_t* __restrict__ b,
             long long sb, int32_t* __restrict__ out, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  uint32_t x[fr381::kWords], y[fr381::kWords], r[fr381::kWords];
  fr381::load(a + e * sa, x);
  if (op == kMul || op == kAdd || op == kSub) fr381::load(b + e * sb, y);
  if (op == kMul) {
    fr381::mont_mul(x, y, r);
  } else if (op == kAdd) {
    fr381::mont_add(x, y, r);
  } else if (op == kSub) {
    fr381::mont_sub(x, y, r);
  } else if (op == kCanon) {
#pragma unroll
    for (int q = 0; q < fr381::kWords; ++q) r[q] = x[q];
    fr381::canon(r);
  } else if (op == kFromMont) {
#pragma unroll
    for (int q = 0; q < fr381::kWords; ++q) y[q] = q == 0 ? 1u : 0u;
    fr381::mont_mul(x, y, r);
    fr381::canon(r);
  } else {                                             // kInv: x^(r-2), MSB first
#pragma unroll
    for (int q = 0; q < fr381::kWords; ++q) r[q] = kOneM[q];
#pragma unroll 1
    for (int bit = 254; bit >= 0; --bit) {
      fr381::mont_mul(r, r, y);
      if ((kRMinus2[bit >> 5] >> (bit & 31)) & 1u) {
        fr381::mont_mul(y, x, r);
      } else {
#pragma unroll
        for (int q = 0; q < fr381::kWords; ++q) r[q] = y[q];
      }
    }
  }
  fr381::store(r, out + e * fr381::kDigits);
}

}  // namespace

// Stage s (flags: 1 gather by bit reversal, 2 scale by n^-1) of a transform of
// size n = 2^logn >= 2 over g_rows contiguous rows of n elements (22 int32
// digits each), from `in` to `out` (distinct buffers), on `stream`. Returns
// cudaErrorInvalidValue for a bad shape, else the cudaError_t of the launch.
extern "C" int fr_ntt_launch(const int32_t* in, int32_t* out, const int32_t* tw,
                             const int32_t* scale, int g_rows, int n, int s, int flags,
                             void* stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  if (g_rows < 1 || n < 2 || (1 << logn) != n || logn > 30 || s < 0 || s >= logn ||
      in == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long work = static_cast<long long>(g_rows) * (n / 2);
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fr_ntt_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, out, tw, scale, g_rows, n, logn, s,
                                                       flags);
  return static_cast<int>(cudaGetLastError());
}

// out[e] = op(a[e], b[e]) over n >= 1 elements; sa and sb are element strides
// in digits (even, 0 broadcasts), out is contiguous. Returns
// cudaErrorInvalidValue for a bad op or size, else the launch's cudaError_t.
extern "C" int fr_ew_launch(int op, const int32_t* a, long long sa, const int32_t* b,
                            long long sb, int32_t* out, long long n, void* stream) {
  if (op < kMul || op > kInv || n < 1 || sa % 2 || sb % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fr_ew_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(op, a, sa, b, sb, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fr_ntt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* fr_ew_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
