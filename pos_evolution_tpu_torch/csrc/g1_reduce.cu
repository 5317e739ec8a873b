// K11's bucket route, its last launch: each blob's sum_b b B_b from the
// subtrees of the totals launch (csrc/g1_totals.cu). csrc/g1_bucket.cu has the
// route; this source is built apart so that it compiles in parallel with the
// others.
//
// Replaces, with g1_bucket.cu, pos_evolution_tpu/ops/pairing.py::
// _g1_msm_kernel (:386) over the setup's powers; the result equals
// pos_evolution_tpu_torch/ops/pairing.py::_reduce_plain digit for digit.
//
// g1_reduce_kernel, one block a blob: with B = 2^H buckets (index i = b - 1),
//   sum_b b B_b = S + sum_(k < H) 2^k Q_k,
// S the sum of every bucket and Q_k of those whose index has bit k set. A
// binary tree over the buckets builds them: a node of height h holds S, Q_0 ..
// Q_(h-1) of its 2^h buckets; a parent adds its children's point by point
// (lower child first) and takes the upper child's S as its Q_h: ~2B unified
// adds a blob. The totals launch ran the levels inside each run of 64 buckets
// on the whole card; this block runs the rest, each level's adds spread over
// its threads between __syncthreads, levels ping-ponging between two scratch
// buffers of words. Then thread k + 1 doubles Q_k k times (2^k Q_k, in
// parallel), and a halving tree in shared memory adds S, Q_0, 2 Q_1, ..
// pairwise (an odd last point carried up) to the blob's sum.
//
// Bound: ~2B adds of 16 products a blob, most of them in the totals launch;
// here a chain of ~H - 6 levels, H - 1 doublings and log2 (H + 1) adds.

#include <cstdint>

#include <cuda_runtime.h>

#include "g1_bucket.cuh"

namespace {

using namespace g1b;

constexpr int kReduceThreads = 256;
constexpr int kMaxPts = 16;                        // S, Q_0 .. Q_14 (c <= 16)

// sub: the subtrees [G, nb / sub_n, log2 sub_n + 1, 36] words; scratch: [2, G,
// nb / 2, 36] words (a level above the subtrees holds at most nb / 2 points).
__global__ void __launch_bounds__(kReduceThreads)
g1_reduce_kernel(const uint32_t* __restrict__ sub, uint32_t* __restrict__ scratch,
                 int32_t* __restrict__ out, int g_rows, int nb) {
  __shared__ __align__(16) uint32_t fin[2][kMaxPts * kPt];
  const int g = blockIdx.x, t = threadIdx.x;
  int levels = 0, sub_log = 0;
  while ((1 << levels) < nb) ++levels;
  const int sub_n = nb < kSubMax ? nb : kSubMax;
  while ((1 << sub_log) < sub_n) ++sub_log;
  const long long slab = static_cast<long long>(nb / 2) * kPt;
  uint32_t* buf[2] = {scratch + g * slab, scratch + (static_cast<long long>(g_rows) + g) * slab};
  const uint32_t* src = sub + static_cast<long long>(g) * (nb >> sub_log) * (sub_log + 1) * kPt;
  __align__(16) uint32_t P[kPt];
  int cur = 0;
#pragma unroll 1
  for (int h = sub_log; h < levels; ++h) {
    const int in_pts = h + 1, pts = h + 2;         // points a node below, above
    const int items = (nb >> (h + 1)) * pts;
#pragma unroll 1
    for (int it = t; it < items; it += kReduceThreads) {
      const int m = it / pts, q = it - m * pts;
      const int qa = q < in_pts ? q : 0;           // Q_h = the upper child's S
      const uint32_t* pa = src + (static_cast<long long>(2 * m) * in_pts + qa) * kPt;
      const uint32_t* pc = src + (static_cast<long long>(2 * m + 1) * in_pts + qa) * kPt;
      copy_pt(q < in_pts ? pa : pc, P);
      if (q < in_pts) add_pt(P, pc);
      copy_pt(P, buf[cur] + (static_cast<long long>(m) * pts + q) * kPt);
    }
    __syncthreads();
    src = buf[cur];
    cur ^= 1;
  }
  // src: the root, S and Q_0 .. Q_(levels - 1); point k + 1 <- 2^k Q_k
  if (t <= levels) {
    copy_pt(src + static_cast<long long>(t) * kPt, P);
#pragma unroll 1
    for (int d = 1; d < t; ++d) dbl_pt(P);
    copy_pt(P, fin[0] + t * kPt);
  }
  __syncthreads();
  int m = levels + 1, a = 0;
#pragma unroll 1
  while (m > 1) {                                  // pairwise, an odd last point carried
    const int half = m >> 1;
    if (t < half) {
      copy_pt(fin[a] + 2 * t * kPt, P);
      add_pt(P, fin[a] + (2 * t + 1) * kPt);
      copy_pt(P, fin[a ^ 1] + t * kPt);
    } else if (t == half && (m & 1)) {
      copy_pt(fin[a] + (m - 1) * kPt, fin[a ^ 1] + t * kPt);
    }
    __syncthreads();
    a ^= 1;
    m = half + (m & 1);
  }
  if (t == 0) {
    const uint32_t* r = fin[a];
    store_digits(out + static_cast<long long>(g) * kPtDigits, r, r + kW, r + 2 * kW);
  }
}

}  // namespace

// sum_b b B_b of each blob: the totals launch's subtrees, scratch [2, g_rows,
// nb / 2, 36] words -> out [g_rows, 3, 32] Jacobian digits. nb a power of two
// in [2, 2^15]. Returns cudaErrorInvalidValue for a bad size, else the launch's
// cudaError_t.
extern "C" int g1_bucket_reduce_launch(const uint32_t* sub, uint32_t* scratch, int32_t* out,
                                       int g_rows, int nb, void* stream) {
  if (g_rows < 1 || !bucket_count_ok(nb))
    return static_cast<int>(cudaErrorInvalidValue);
  g1_reduce_kernel<<<g_rows, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sub, scratch, out, g_rows, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* g1_bucket_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
