// K10: the BLS12-381 scalar-field NTT over Montgomery digits, as passes of
// several butterfly stages in shared memory, and Fr's elementwise ops.
//
// Replaces pos_evolution_tpu/kzg/ntt.py::_device_kernel (:143), the jitted
// Cooley-Tukey ladder of the JAX package, and the field ops it composes,
// pos_evolution_tpu/kzg/fr.py::mul/add/sub/canon (:288-310), XLA-jitted
// functions over [..., 22] int32 digits. The results equal
// pos_evolution_tpu_torch/kzg/ntt.py::_ntt_plain and kzg/fr.py's plain
// versions digit for digit (fr381.cuh: exact arithmetic, the same lazy
// residues in [0, 2r)): every butterfly is the plain version's mont_mul,
// mont_add and mont_sub on the same operands.
//
// fr_ntt_pass_kernel: stages [s0, s1) of a decimation-in-time transform of
// size n = 2^logn over G rows, one block a group of positions that those
// stages touch only among themselves. Stage s pairs position i0 (bit s
// clear) with i0 + 2^s and multiplies the second by twiddle w_k, k = i0 mod
// 2^s (the host plan's Montgomery constants as 8-word rows, stage s at offset
// 2^s - 1), then writes a + b w_k and a - b w_k, as ntt.py::_transform
// reshapes and stacks. The first pass (s0 = 0) takes a tile of 2^s1 <=
// 2^kTileLog consecutive positions: it gathers its digit rows through the bit
// reversal, converts them once to 8 words (32 bytes) an element in shared
// memory, stages its stages' twiddles (the table's first 2^s1 - 1 rows, the
// same for every tile) there too, and runs every stage between
// __syncthreads; kTileLog = 8 stages, a tile of 256 (kzg/ntt.py's
// K10_FIRST_LOG), measured faster than tiles of 2^6, 2^7, 2^9 and 2^10 at
// 9 x 16,384 (more tiles fill the card), and inside 48 KB of shared memory
// with its twiddles. A later pass runs up to kLaterLog stages over groups of
// positions o + k 2^s0 (outer offsets by 2^s1): a block takes kLater
// elements, kLater / 2^(s1 - s0) consecutive offsets o for every k, so its
// loads of 32-byte word rows coalesce; its twiddles come through L1. Between
// passes the data stays 8 words an element; the last pass writes digit rows
// and, for an inverse, multiplies by n^-1. A transform of n <= 256 is one
// launch; at the PeerDAS domain (n = 16,384) two.
//
// fr_ew_kernel: out[e] = op(a[e], b[e]) (MUL, ADD, SUB, CANON, FROM_MONT:
// REDC(a * 1) then canon, INV: a^(r-2) by square-and-multiply from
// Montgomery one, the JAX scan's order, in registers), each operand read at
// its own element stride (0 broadcasts a constant).
//
// Bound on the KZG commit path (the INTT at 9 x 16,384, 14 stages): the
// REDCs. A butterfly is one REDC (8x8, 9x9 low and 9x8 word products, 181
// partial products) and an add and a sub; with the n^-1 scale, 2.14e8 partial
// products (0.0128 ms on the 64-lane multiplier) against 27 MB of digit rows
// read and written once (0.0082 ms at 3.35 TB/s). The former design, a launch
// a stage moving 88-byte rows each time, was set by 14 launches and ~370 MB.

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

constexpr int kTileLog = 8;                              // the first pass's tile, 2^8
constexpr int kLaterLog = 9, kLater = 1 << kLaterLog;     // a later pass's block
constexpr int kPassThreads = 256;                        // at most; elems / 2 below
enum : int { kGather = 1, kDigitsOut = 2, kScale = 4 };

__device__ __forceinline__ void ld8(const uint32_t* __restrict__ src, uint32_t* w) {
  const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

__device__ __forceinline__ void st8(const uint32_t* w, uint32_t* __restrict__ dst) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Stages [s0, s1) over blocks of elems = 2^(s1 - s0) x offs positions of one
// row: in is digit rows (kGather) or word rows, out digit rows (kDigitsOut)
// or word rows; tw, scale 8-word rows.
__global__ void __launch_bounds__(kPassThreads)
fr_ntt_pass_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ scale, int n,
                   int logn, int s0, int s1, int flags, int offs, int blocks_per_row) {
  extern __shared__ uint4 smem[];
  uint32_t* data = reinterpret_cast<uint32_t*>(smem);
  const int k = s1 - s0, span = 1 << k, elems = span * offs;
  uint32_t* twid = data + elems * fr381::kWords;            // the first pass's twiddles
  const int row = blockIdx.x / blocks_per_row;
  const int blk = blockIdx.x - row * blocks_per_row;
  const int per_outer = (1 << s0) / offs;                    // blocks an outer group
  const int outer = blk / per_outer;
  const int o0 = (blk - outer * per_outer) * offs;
  const long long base = static_cast<long long>(outer) << s1;
  const long long row0 = static_cast<long long>(row) * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int kk = e / offs, cc = e - kk * offs;
    const long long p = base + o0 + cc + (static_cast<long long>(kk) << s0);
    uint32_t w[fr381::kWords];
    if (flags & kGather) {
      const long long src = __brev(static_cast<unsigned>(p)) >> (32 - logn);
      fr381::load(in + (row0 + src) * fr381::kDigits, w);
    } else {
      ld8(reinterpret_cast<const uint32_t*>(in) + (row0 + p) * fr381::kWords, w);
    }
    st8(w, data + e * fr381::kWords);
  }
  if (flags & kGather) {
    for (int t = threadIdx.x; t < span - 1; t += blockDim.x) {
      uint32_t w[fr381::kWords];
      ld8(tw + static_cast<long long>(t) * fr381::kWords, w);
      st8(w, twid + t * fr381::kWords);
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int ls = 0; ls < k; ++ls) {
    const int half = 1 << ls, s = s0 + ls;
#pragma unroll 1
    for (int bf = threadIdx.x; bf < elems / 2; bf += blockDim.x) {
      const int r = bf / offs, cc = bf - r * offs;
      const int k0 = ((r >> ls) << (ls + 1)) | (r & (half - 1)), k1 = k0 + half;
      const long long ti = ((1LL << s) - 1) + o0 + cc
          + (static_cast<long long>(k0 & (half - 1)) << s0);
      uint32_t a[fr381::kWords], b[fr381::kWords], w[fr381::kWords], bw[fr381::kWords];
      ld8(data + (k0 * offs + cc) * fr381::kWords, a);
      ld8(data + (k1 * offs + cc) * fr381::kWords, b);
      ld8((flags & kGather) ? twid + ti * fr381::kWords : tw + ti * fr381::kWords, w);
      fr381::mont_mul(b, w, bw);
      fr381::mont_add(a, bw, w);
      fr381::mont_sub(a, bw, b);
      st8(w, data + (k0 * offs + cc) * fr381::kWords);
      st8(b, data + (k1 * offs + cc) * fr381::kWords);
    }
    __syncthreads();
  }
  uint32_t sc[fr381::kWords];
  if (flags & kScale) ld8(scale, sc);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int kk = e / offs, cc = e - kk * offs;
    const long long p = base + o0 + cc + (static_cast<long long>(kk) << s0);
    uint32_t w[fr381::kWords], x[fr381::kWords];
    ld8(data + e * fr381::kWords, w);
    if (flags & kScale) {                                  // the inverse's n^-1
      fr381::mont_mul(w, sc, x);
#pragma unroll
      for (int q = 0; q < fr381::kWords; ++q) w[q] = x[q];
    }
    if (flags & kDigitsOut) fr381::store(w, out + (row0 + p) * fr381::kDigits);
    else st8(w, reinterpret_cast<uint32_t*>(out) + (row0 + p) * fr381::kWords);
  }
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

// Stages [s0, s1) of a transform of size n = 2^logn >= 2 over g_rows
// contiguous rows of n elements, from `in` to `out` (distinct buffers), on
// `stream`. flags: 1 the first pass (s0 = 0, s1 - s0 <= 8; `in` digit rows,
// 22 int32 an element, read through the bit reversal), else s1 - s0 <= 9 and
// `in` 8-word rows; 2 `out` digit rows (the last pass), else 8-word rows; 4
// multiply by scale (n^-1, an inverse's last pass). tw: the twiddles as
// 8-word rows (stage s at row 2^s - 1), scale one 8-word row, both 16-byte
// aligned. Returns cudaErrorInvalidValue for a bad shape, else the launch's
// cudaError_t.
extern "C" int fr_ntt_launch(const int32_t* in, int32_t* out, const uint32_t* tw,
                             const uint32_t* scale, int g_rows, int n, int s0, int s1, int flags,
                             void* stream) {
  int logn = 0;
  while (logn < 31 && (1 << logn) < n) ++logn;
  const bool first = flags & kGather;
  const int k = s1 - s0;
  if (g_rows < 1 || n < 2 || (1 << logn) != n || logn > 30 || in == out || flags < 0
      || flags > 7 || s0 < 0 || s1 > logn || k < 1 || (first ? s0 != 0 || k > kTileLog
                                                              : s0 == 0 || k > kLaterLog))
    return static_cast<int>(cudaErrorInvalidValue);
  const int offs = first ? 1 : kLater >> k;
  if (!first && offs > (1 << s0)) return static_cast<int>(cudaErrorInvalidValue);
  const int elems = (1 << k) * offs;
  const long long blocks = static_cast<long long>(g_rows) * (n / elems);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // at most 511 rows of 32 bytes (a first pass's data and twiddles): 16 KB
  const size_t smem = static_cast<size_t>(first ? 2 * elems - 1 : elems) * fr381::kWords * 4;
  const int threads = elems / 2 < kPassThreads ? elems / 2 : kPassThreads;   // a butterfly each
  fr_ntt_pass_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(in, out, tw, scale, n, logn, s0, s1,
                                                            flags, offs, n / elems);
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
