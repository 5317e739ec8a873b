// K11's bucket route, its totals launch: each bucket's sum, and the bottom
// levels of the reduce's tree. csrc/g1_bucket.cu has the route; this source is
// built apart so that it compiles in parallel with the others.
//
// Replaces, with g1_bucket.cu, pos_evolution_tpu/ops/pairing.py::
// _g1_msm_kernel (:386) over the setup's powers; the results equal
// pos_evolution_tpu_torch/ops/pairing.py::_totals_plain and the lower levels
// of _reduce_plain digit for digit.

#include <cstdint>

#include <cuda_runtime.h>

#include "g1_bucket.cuh"

namespace {

using namespace g1b;

// One block a run of sub_n = min(64, nb) buckets of one blob, thread i its
// bucket: the bucket's sum (its first run, then the parts of the chunks that
// continue it), digits to totals[g, i]; then the reduce's tree over the
// block's buckets in shared memory, levels 0 .. log2 sub_n (a node of height h
// holds S, Q_0 .. Q_(h-1); a parent adds its children's point by point and
// takes the upper child's S as Q_h), the subtree's log2 sub_n + 1 points to
// sub[g, block].
__global__ void __launch_bounds__(kSubMax)
g1_totals_kernel(const uint32_t* __restrict__ part, const uint32_t* __restrict__ bsum,
                 const int* __restrict__ start, int32_t* __restrict__ totals,
                 uint32_t* __restrict__ sub, int chunks, int nb) {
  __shared__ __align__(16) uint32_t lvl[2][kSubMax * kPt];
  const int sub_n = blockDim.x, t = threadIdx.x;
  const int per_blob = nb / sub_n;
  const int g = blockIdx.x / per_blob, sb = blockIdx.x - g * per_blob;
  const int i = sb * sub_n + t;
  const long long idx = static_cast<long long>(g) * nb + i;
  const int* st = start + static_cast<long long>(g) * (nb + 1);
  const int s = st[i], e = st[i + 1];
  __align__(16) uint32_t P[kPt];
  if (s == e) {
#pragma unroll
    for (int k = 0; k < kPt; ++k) P[k] = 0u;
  } else {
    const int t0 = s / kChunk;
    copy_pt(s % kChunk == 0 ? part + (static_cast<long long>(g) * chunks + t0) * kPt
                            : bsum + idx * kPt, P);
#pragma unroll 1
    for (int c = t0 + 1; static_cast<long long>(c) * kChunk < e; ++c)
      add_pt(P, part + (static_cast<long long>(g) * chunks + c) * kPt);
  }
  store_digits(totals + idx * kPtDigits, P, P + kW, P + 2 * kW);
  copy_pt(P, lvl[0] + t * kPt);
  __syncthreads();
  int levels = 0, cur = 1;
  while ((1 << levels) < sub_n) ++levels;
#pragma unroll 1
  for (int h = 0; h < levels; ++h) {
    const int in_pts = h + 1, pts = h + 2;         // points a node below, above
    const int items = (sub_n >> (h + 1)) * pts;
    const uint32_t* src = lvl[cur ^ 1];
    for (int it = t; it < items; it += sub_n) {
      const int m = it / pts, q = it - m * pts;
      const int qa = q < in_pts ? q : 0;           // Q_h = the upper child's S
      const uint32_t* pa = src + ((2 * m) * in_pts + qa) * kPt;
      const uint32_t* pc = src + ((2 * m + 1) * in_pts + qa) * kPt;
      copy_pt(q < in_pts ? pa : pc, P);
      if (q < in_pts) add_pt(P, pc);
      copy_pt(P, lvl[cur] + (m * pts + q) * kPt);
    }
    __syncthreads();
    cur ^= 1;
  }
  if (t <= levels)
    copy_pt(lvl[cur ^ 1] + t * kPt,
            sub + ((static_cast<long long>(g) * per_blob + sb) * (levels + 1) + t) * kPt);
}

}  // namespace

// Each bucket's sum and the bottom of the reduce's tree: part, bsum (as the
// fill left them), start -> totals [g_rows, nb, 3, 32] digits and sub
// [g_rows, nb / min(64, nb), log2 min(64, nb) + 1, 36] words.
extern "C" int g1_bucket_totals_launch(const uint32_t* part, const uint32_t* bsum,
                                       const int* start, int32_t* totals, uint32_t* sub,
                                       int g_rows, int cap, int nb, void* stream) {
  if (g_rows < 1 || cap < 1 || !bucket_count_ok(nb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_n = nb < kSubMax ? nb : kSubMax;
  const long long blocks = static_cast<long long>(g_rows) * (nb / sub_n);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  g1_totals_kernel<<<static_cast<unsigned>(blocks), sub_n, 0,
                     static_cast<cudaStream_t>(stream)>>>(part, bsum, start, totals, sub,
                                                          (cap + kChunk - 1) / kChunk, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* g1_bucket_totals_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
