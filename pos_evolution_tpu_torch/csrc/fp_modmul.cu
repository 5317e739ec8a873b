// K3: base-field multiply, out[i] = a[i] * b[i] mod p, a lazy residue in [0, 2p).
//
// Replaces pos_evolution_tpu/ops/fp.py::modmul (:204, through conv_digits :94,
// carry_norm :130 and barrett_reduce :179), an XLA-jitted function of the JAX
// package that the verify path calls tens of thousands of times in sequence.
// The result equals pos_evolution_tpu_torch/ops/fp.py::_modmul, its plain
// PyTorch version, digit for digit: (n, 32) int32 canonical digits in, the
// same out, for any n >= 1 (broadcasting is the wrapper's).
//
// The JAX function vectorizes over digits: outer products contracted by a
// selector matmul, 3 carry folds and a Kogge-Stone lookahead per
// normalization. A GPU thread needs none of that: one thread takes one
// element, packs its 32 digits into 12 32-bit words and multiplies them
// schoolbook with 64-bit partial products (fp381.cuh), exact throughout.
//
// Bound: 391 32x32->64 partial products per element (144 for a*b, 169 for
// the quotient estimate, 78 for its low product with p), each two 32-bit
// multiplies on the 64-lane integer-multiply path; and 384 bytes moved (two
// 128-byte operands read, one written). At the path's largest call (the
// 4096 x 144 products of an Fq12 multiply) the bytes bind at 3.35 TB/s.
// The design reads each operand once with 16-byte vector loads and keeps
// everything else in registers.
//
// Not tuned: no Montgomery or Karatsuba, one element per thread.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fp_modmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t off = static_cast<int64_t>(i) * fp381::kDigits;
  uint32_t x[fp381::kWords], y[fp381::kWords], r[fp381::kWords];
  fp381::load(a + off, x);
  fp381::load(b + off, y);
  fp381::modmul(x, y, r);
  fp381::store(r, out + off);
}

}  // namespace

// Launches K3 on `stream` over n >= 1 elements. The caller has checked the
// device and type, and made a, b and out contiguous (n, 32) int32 arrays with
// 16-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int fp_modmul_launch(const void* a, const void* b, void* out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  fp_modmul_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fp_modmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
