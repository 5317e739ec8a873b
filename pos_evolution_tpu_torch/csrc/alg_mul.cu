// K5: one multiply in the d-component tower algebra (Fq2, Fq6, Fq12), dense
// or with a sparse right operand, out = x * y as d lazy residues in [0, 2p).
//
// Replaces pos_evolution_tpu/ops/tower.py::alg_mul (:129), an XLA-jitted
// function of the JAX package behind every Fq2/Fq6/Fq12 multiply of the
// pairing and the hash-to-G2 map. The result equals
// pos_evolution_tpu_torch/ops/tower.py::_alg_mul, its plain PyTorch version,
// digit for digit. For each batch element and each output component k:
//   prods[i][j] = x[i] * y[j] mod p        (as K3 computes it, in [0, 2p))
//   v_k = m p + sum_ij T[i][j][k] prods[i][j]   (exact, signed 64-bit columns)
//   out[k] = Barrett(v_k)                  (as K3 reduces)
// where T is the algebra's structure tensor restricted to the right operand's
// slots and m p the plan's offset that keeps v_k >= 0 (ops/tower.py::_mul_plan).
// No Karatsuba and no reassociation: the same d x dy schoolbook products, each
// reduced as K3 reduces it, and the same exact v_k before the one reduction.
//
// The four plans of the path (d = 2, 6, 12, and d = 12 against the line's six
// slots) live in __constant__ memory, uploaded once per device by
// alg_mul_set_plans: d, dy, m, and for each output component the list of its
// nonzero terms (product index, coefficient).
//
// One block takes `per_block` consecutive elements; an operand is read in
// place by an element stride (0 broadcasts a constant such as a Frobenius
// gamma), its d rows contiguous:
//   1. the x and y rows are staged into shared memory with coalesced 16-byte
//      loads (rows padded to 36 words), and each converted to 12 words once;
//   2. one thread per product runs K3's multiply and Barrett reduction on
//      words read from shared memory, into shared memory;
//   3. one thread per (element, component, word) column sums that
//      component's nonzero terms of that word in int64 (|sum| < 2^42);
//   4. one thread per component makes the one signed carry pass and the
//      Barrett reduction, and stages its digits;
//   5. the block writes its output run back with coalesced 16-byte stores.
//
// Bound: the products' 32x32->64-bit partial products (391 per product, as
// K3) on the 64-lane integer-multiply path, plus 12 per nonzero term and one
// reduction per component; operations bind for d >= 6, bytes at d = 2.
//
// Not done: splitting one product's schoolbook over several threads; at
// d = 2 a launch of n elements runs 4n product threads.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kThreads = 160;
constexpr int kPlans = 4;
constexpr int kMaxTerms = 512;
constexpr int kPitch = 9;          // uint4 per staged row: 8 and one of padding

struct Plan {
  int d, dy, m;
  int start[13];                   // terms of component k: kTerms[start[k], start[k + 1])
};

__constant__ Plan kPlan[kPlans];
__constant__ uint16_t kTerms[kMaxTerms];   // (i * dy + j) << 4 | (coefficient + 8)

__host__ __device__ inline size_t shared_bytes(int e, int d, int dy) {
  return static_cast<size_t>(e) * ((d + dy) * kPitch * 16 + d * 13 * 8 + (d + dy + d * dy) * 48);
}

__global__ void __launch_bounds__(kThreads)
alg_mul_kernel(const int32_t* __restrict__ x, long long sx, const int32_t* __restrict__ y,
               long long sy, int32_t* __restrict__ out, int n, int q, int per_block) {
  extern __shared__ uint4 smem[];
  const int d = kPlan[q].d, dy = kPlan[q].dy, np = d * dy;
  const int first = blockIdx.x * per_block;
  const int count = min(per_block, n - first);
  uint4* stage = smem;                                                  // rows of digits
  long long* acc = reinterpret_cast<long long*>(stage + per_block * (d + dy) * kPitch);
  uint32_t* xw = reinterpret_cast<uint32_t*>(acc + per_block * d * 13);  // [e][i][12]
  uint32_t* yw = xw + per_block * d * 12;                                // [e][j][12]
  uint32_t* prods = yw + per_block * dy * 12;                            // [e][i * dy + j][12]
  const int t = threadIdx.x;

  // 1. stage the block's x rows, then its y rows (an element's rows are
  // contiguous, elements sx and sy digits apart), and convert each row once
  const int xrows = count * d, rows = xrows + count * dy;
  for (int u = t; u < rows * 8; u += kThreads) {
    const int r = u >> 3, part = u & 7;
    const int32_t* src;
    if (r < xrows) {
      const int e = r / d;
      src = x + (first + e) * sx + (r - e * d) * 32;
    } else {
      const int e = (r - xrows) / dy;
      src = y + (first + e) * sy + (r - xrows - e * dy) * 32;
    }
    stage[r * kPitch + part] = __ldg(reinterpret_cast<const uint4*>(src) + part);
  }
  __syncthreads();
  for (int r = t; r < rows; r += kThreads) {
    uint32_t w[fp381::kWords];
    fp381::unstage(stage + r * kPitch, w);
    uint32_t* dst = r < xrows ? xw + r * 12 : yw + (r - xrows) * 12;
#pragma unroll
    for (int k = 0; k < fp381::kWords; ++k) dst[k] = w[k];
  }
  __syncthreads();

  // 2. one product per thread
  for (int u = t; u < count * np; u += kThreads) {
    const int e = u / np, pr = u - e * np, i = pr / dy, j = pr - i * dy;
    const uint32_t* xa = xw + (e * d + i) * 12;
    const uint32_t* yb = yw + (e * dy + j) * 12;
    uint32_t a[fp381::kWords], b[fp381::kWords], r[fp381::kWords];
#pragma unroll
    for (int k = 0; k < fp381::kWords; ++k) {
      a[k] = xa[k];
      b[k] = yb[k];
    }
    fp381::modmul(a, b, r);
#pragma unroll
    for (int k = 0; k < fp381::kWords; ++k) prods[u * 12 + k] = r[k];
  }
  __syncthreads();

  // 3. one thread per (element, component, word) column
  for (int u = t; u < count * d * 12; u += kThreads) {
    const int ek = u / 12, w = u - ek * 12, e = ek / d, k = ek - e * d;
    long long s = static_cast<long long>(kPlan[q].m) * fp381::kP[w];
    const uint32_t* col = prods + e * np * 12 + w;
    const int end = kPlan[q].start[k + 1];
    for (int z = kPlan[q].start[k]; z < end; ++z) {
      const int term = kTerms[z];
      s += static_cast<long long>((term & 15) - 8) * col[(term >> 4) * 12];
    }
    acc[ek * 13 + w] = s;
  }
  __syncthreads();

  // 4. one thread per component: the signed carry pass (v >= 0 exactly), Barrett
  for (int u = t; u < count * d; u += kThreads) {
    uint32_t v[24];
    long long carry = 0;
#pragma unroll
    for (int w = 0; w < 12; ++w) {
      const long long s = acc[u * 13 + w] + carry;
      v[w] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    v[12] = static_cast<uint32_t>(carry);
#pragma unroll
    for (int w = 13; w < 24; ++w) v[w] = 0;
    uint32_t r[fp381::kWords];
    fp381::barrett(v, r);
    fp381::stage(r, stage + u * kPitch);
  }
  __syncthreads();

  // 5. the block's output run, coalesced
  uint4* os = reinterpret_cast<uint4*>(out + static_cast<long long>(first) * d * 32);
  for (int u = t; u < count * d * 8; u += kThreads) os[u] = stage[(u >> 3) * kPitch + (u & 7)];
}

int g_plan_d[kPlans], g_plan_dy[kPlans];   // host copies, for the launch shape

}  // namespace

// Uploads the four plans: plans is int32 [4][16] (d, dy, m, start[13]) and
// terms n_terms uint16 entries. Call once per device before any launch.
extern "C" int alg_mul_set_plans(const void* plans, const void* terms, int n_terms) {
  if (n_terms < 1 || n_terms > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(plans);
  for (int q = 0; q < kPlans; ++q) {
    g_plan_d[q] = p[16 * q];
    g_plan_dy[q] = p[16 * q + 1];
    if (g_plan_d[q] < 1 || g_plan_d[q] > 12 || g_plan_dy[q] < 1 || g_plan_dy[q] > 12 ||
        shared_bytes(1, g_plan_d[q], g_plan_dy[q]) > 48 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = cudaMemcpyToSymbol(kPlan, plans, sizeof(Plan) * kPlans);
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(kTerms, terms, sizeof(uint16_t) * n_terms);
  return static_cast<int>(rc);
}

// Launches K5 on `stream` over n >= 1 batch elements of x (n, d, 32) and
// y (n, dy, 32), element e's rows at x + e * sx and y + e * sy (digits; 0
// broadcasts one element), into out (n, d, 32) contiguous, by plan q (0..3,
// as uploaded). Rows and strides are 16-byte aligned int32; the caller has
// checked devices, types and shapes. Returns the cudaError_t of the launch.
extern "C" int alg_mul_launch(const void* x, long long sx, const void* y, long long sy, void* out,
                              int n, int q, void* stream) {
  if (q < 0 || q >= kPlans || g_plan_d[q] < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = g_plan_d[q], dy = g_plan_dy[q];
  // the most elements whose products fit the block, fewer while that leaves
  // under two blocks per SM
  int per_block = kThreads / (d * dy) > 0 ? kThreads / (d * dy) : 1;
  while (per_block > 1 && shared_bytes(per_block, d, dy) > 48 * 1024) --per_block;
  const int spread = (n + 263) / 264;
  if (spread < per_block) per_block = spread;
  const int blocks = (n + per_block - 1) / per_block;
  alg_mul_kernel<<<blocks, kThreads, shared_bytes(per_block, d, dy),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), sx, static_cast<const int32_t*>(y), sy,
      static_cast<int32_t*>(out), n, q, per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alg_mul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
