// K5: one multiply in the d-component tower algebra (Fq2, Fq6, Fq12), dense
// or with a sparse right operand, out = x * y as d lazy residues in [0, 2p).
//
// Replaces pos_evolution_tpu/ops/tower.py::alg_mul (:129), an XLA-jitted
// function of the JAX package behind every Fq2/Fq6/Fq12 multiply of the
// pairing and the hash-to-G2 map. The result equals
// pos_evolution_tpu_torch/ops/tower.py::_alg_mul, its plain PyTorch version,
// digit for digit. For each batch element and each output component k:
//   prods[i][j] = x[i] * y[j] mod p        (as K3 computes it, in [0, 2p))
//   v_k = sum_ij T+[i][j][k] prods[i][j] + m p - sum_ij T-[i][j][k] prods[i][j]
//   out[k] = Barrett(v_k)                  (as K3 reduces)
// where T = T+ - T- is the algebra's structure tensor restricted to the right
// operand's slots (coef, int32 [d * dy * d], row-major) and m p the plan's
// offset that keeps v_k >= 0 (ops/tower.py::_mul_plan). v_k is computed
// exactly (signed 64-bit columns, one carry pass), so any exact method gives
// the JAX function's digits.
//
// The JAX function makes the products one batched modmul, the recombination
// two einsums and three more digit normalizations, each a separate XLA op.
// Here one block takes `per_block` batch elements: one thread per product
// (d * dy of them per element) writes its product's 12 words to shared
// memory, then one thread per output component sums its terms and reduces.
//
// Bound: the products' partial products (391 per product, as K3) on the
// 64-lane integer-multiply path; d * dy products per element against
// (d + dy + d) * 128 bytes moved, so operations bind for d >= 6.
//
// Not tuned: no Karatsuba-style product sharing, coefficients read from
// global memory (L1-resident), one output component per thread.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kMaxThreads = 160;   // d * dy <= 144 products, or 128 of smaller ones

__global__ void __launch_bounds__(kMaxThreads)
alg_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
               const int32_t* __restrict__ coef, int32_t* __restrict__ out, int n, int d,
               int dy, int m, int per_block) {
  extern __shared__ uint32_t prods[];   // [per_block][d * dy][12]
  const int np = d * dy;
  const int first = blockIdx.x * per_block;

  // phase 1: one product per thread
  const int t = threadIdx.x;
  if (t < per_block * np) {
    const int e = t / np, pr = t % np;
    const int elem = first + e;
    if (elem < n) {
      const int i = pr / dy, j = pr % dy;
      uint32_t a[fp381::kWords], b[fp381::kWords], r[fp381::kWords];
      fp381::load(x + (static_cast<int64_t>(elem) * d + i) * fp381::kDigits, a);
      fp381::load(y + (static_cast<int64_t>(elem) * dy + j) * fp381::kDigits, b);
      fp381::modmul(a, b, r);
      uint32_t* dst = prods + static_cast<int64_t>(t) * fp381::kWords;
#pragma unroll
      for (int w = 0; w < fp381::kWords; ++w) dst[w] = r[w];
    }
  }
  __syncthreads();

  // phase 2: one output component per thread
  for (int o = t; o < per_block * d; o += blockDim.x) {
    const int e = o / d, k = o % d;
    const int elem = first + e;
    if (elem >= n) continue;
    int64_t acc[13];
#pragma unroll
    for (int w = 0; w < fp381::kWords; ++w) acc[w] = static_cast<int64_t>(m) * fp381::kP[w];
    acc[12] = 0;
    const uint32_t* base = prods + static_cast<int64_t>(e) * np * fp381::kWords;
    for (int pr = 0; pr < np; ++pr) {
      const int c = coef[pr * d + k];
      if (c == 0) continue;
      const uint32_t* src = base + pr * fp381::kWords;
#pragma unroll
      for (int w = 0; w < fp381::kWords; ++w) acc[w] += static_cast<int64_t>(c) * src[w];
    }
    // |acc[w]| < 2^42: one signed carry pass gives v's words exactly (v >= 0)
    uint32_t v[24];
    int64_t carry = 0;
#pragma unroll
    for (int w = 0; w < 13; ++w) {
      const int64_t s = acc[w] + carry;
      v[w] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
#pragma unroll
    for (int w = 13; w < 24; ++w) v[w] = 0;
    uint32_t r[fp381::kWords];
    fp381::barrett(v, r);
    fp381::store(r, out + (static_cast<int64_t>(elem) * d + k) * fp381::kDigits);
  }
}

}  // namespace

// Launches K5 on `stream` over n >= 1 batch elements of x (n, d, 32) and
// y (n, dy, 32) into out (n, d, 32), all contiguous int32 with 16-byte
// aligned rows; coef is the plan's signed structure tensor, int32
// [d * dy * d], and m its offset multiple of p. The caller has checked
// devices, types and shapes. Returns the cudaError_t of the launch.
extern "C" int alg_mul_launch(const void* x, const void* y, const void* coef, void* out, int n,
                              int d, int dy, int m, void* stream) {
  const int np = d * dy;
  if (d < 1 || dy < 1 || np > 144 || d > 12) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = np >= 128 ? 1 : 128 / np;
  const int threads = per_block * np;
  const size_t shared = static_cast<size_t>(threads) * fp381::kWords * sizeof(uint32_t);
  const int blocks = (n + per_block - 1) / per_block;
  alg_mul_kernel<<<blocks, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(coef), static_cast<int32_t*>(out), n, d, dy, m, per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alg_mul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
