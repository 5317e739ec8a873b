// K11's bucket route, its fill launch: the sum of each run of one bucket
// inside a fixed chunk of sorted entries, by mixed adds. csrc/g1_bucket.cu has
// the route and its earlier launches; this source is built apart so that the
// fill's long straight-line code compiles in parallel with them.
//
// Replaces, with g1_bucket.cu, pos_evolution_tpu/ops/pairing.py::
// _g1_msm_kernel (:386) over the setup's powers; the result equals
// pos_evolution_tpu_torch/ops/pairing.py::_fill_plain digit for digit.
//
// One thread a chunk of kChunk (32) sorted entries of one blob, whatever the
// buckets' sizes: each run of one bucket inside the chunk is summed by mixed
// adds (Jacobian + affine, 11 products, in registers) from the zero point; the
// chunk's first run goes to its part, a run that starts a bucket inside the
// chunk to the bucket's bsum. A negative entry adds -T (y -> 0 - y).

#include <cstdint>

#include <cuda_runtime.h>

#include "g1_bucket.cuh"

namespace {

using namespace g1b;

constexpr int kThreads = 128;

struct FillArgs {
  const int32_t* tables;       // [W n_tab, 2, 32] canonical affine digits
  const uint8_t* tinf;         // [W n_tab]
  const int32_t* ent;          // [G, cap] sorted entries
  const int* start;            // [G, B + 1]
  uint32_t* part;              // [G, chunks, 36] words
  uint32_t* bsum;              // [G, B, 36] words
  int g_rows, cap, chunks, nb;
};

// Thread (g, t): sorted positions [t kChunk, (t + 1) kChunk) of blob g.
__global__ void __launch_bounds__(kThreads) g1_fill_kernel(const __grid_constant__ FillArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.g_rows) * a.chunks) return;
  const int g = static_cast<int>(idx / a.chunks);
  const int t = static_cast<int>(idx - static_cast<long long>(g) * a.chunks);
  const int* st = a.start + static_cast<long long>(g) * (a.nb + 1);
  const int end = st[a.nb];
  const int p0 = t * kChunk;
  if (p0 >= end) return;
  const int p1 = min(p0 + kChunk, end);
  int lo = 0, hi = a.nb - 1;                        // the bucket holding p0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (st[mid] <= p0) lo = mid;
    else hi = mid - 1;
  }
  int i = lo, next = st[i + 1];
  uint32_t X[kW], Y[kW], Z[kW];
  set_zero(X, Y, Z);
  uint32_t* out = a.part + idx * kPt;
  const int32_t* e = a.ent + static_cast<long long>(g) * a.cap;
#pragma unroll 1
  for (int p = p0; p < p1; ++p) {
    if (p == next) {                               // a bucket starts inside the chunk
      store_words(out, X, Y, Z);
      set_zero(X, Y, Z);
      while (st[i + 1] <= p) ++i;
      next = st[i + 1];
      out = a.bsum + (static_cast<long long>(g) * a.nb + i) * kPt;
    }
    const uint32_t v = static_cast<uint32_t>(e[p]);
    const long long key = v & 0x7FFFFFFFu;
    uint32_t x[kW], y[kW];
    fp381::load(a.tables + key * 2 * fp381::kDigits, x);
    fp381::load(a.tables + key * 2 * fp381::kDigits + fp381::kDigits, y);
    if (v >> 31) {                                 // -T: y -> 0 - y (K4's NEG)
      uint32_t zero[kW];
      f_set(zero, 0u);
      f_sub(zero, y, y);
    }
    madd(X, Y, Z, x, y, a.tinf[key] != 0);
  }
  store_words(out, X, Y, Z);
}

}  // namespace

// The bucket runs of chunks of kChunk sorted entries: ent [g_rows, cap],
// start [g_rows, nb + 1], tables [., 2, 32] and tinf [.] -> part [g_rows,
// ceil(cap / kChunk), 36] and bsum [g_rows, nb, 36] words.
extern "C" int g1_bucket_fill_launch(const int32_t* tables, const uint8_t* tinf,
                                     const int32_t* ent, const int* start, uint32_t* part,
                                     uint32_t* bsum, int g_rows, int cap, int nb, void* stream) {
  unsigned blocks;
  if (g_rows < 1 || cap < 1 || !bucket_count_ok(nb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (cap + kChunk - 1) / kChunk;
  if (!blocks_ok(static_cast<long long>(g_rows) * chunks, kThreads, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  FillArgs a{tables, tinf, ent, start, part, bsum, g_rows, cap, chunks, nb};
  g1_fill_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* g1_bucket_fill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
