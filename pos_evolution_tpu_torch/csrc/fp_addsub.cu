// K4: base-field add, subtract, negate and canonicalize, one kernel with an
// op code, each a lazy residue in [0, 2p) as digits.
//
// Replaces pos_evolution_tpu/ops/fp.py::modadd (:210), modsub (:215), modneg
// (:222) and canon (:226), XLA-jitted functions of the JAX package: the ~20
// adds and subtracts of each Miller doubling step and all of
// ops/tower.py::fq2_muli. The result equals the plain versions in
// pos_evolution_tpu_torch/ops/fp.py (_modadd, _modsub, _modneg, _canon)
// digit for digit, for canonical digits in:
//   add   (op 0): s = a + b mod 2^384, then s - 2p if s >= 2p;
//   sub   (op 1): a - b mod 2^384, plus 2p mod 2^384 on underflow;
//   neg   (op 2): sub with a = 0 (b is ignored, pass a);
//   canon (op 3): a - p if a >= p.
// The JAX functions resolve their carries and borrows by a lookahead scan
// over the digits; one thread per element with 12 words in registers and a
// sequential carry does the same exactly.
//
// Bound: bytes. 384 bytes per element for add and sub, 256 for neg and canon,
// against a few dozen integer instructions.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fp_addsub_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int op,
                 int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t off = static_cast<int64_t>(i) * fp381::kDigits;
  uint32_t x[fp381::kWords], y[fp381::kWords], r[fp381::kWords];
  fp381::load(a + off, x);
  if (op == 0 || op == 1) {
    fp381::load(b + off, y);
  }
  if (op == 0) {
    fp381::add(x, y, r);
    fp381::cond_sub(r, fp381::kTwoP);
  } else if (op == 3) {
#pragma unroll
    for (int k = 0; k < fp381::kWords; ++k) r[k] = x[k];
    fp381::cond_sub(r, fp381::kP);
  } else {
    uint32_t lhs[fp381::kWords];
#pragma unroll
    for (int k = 0; k < fp381::kWords; ++k) {
      lhs[k] = op == 1 ? x[k] : 0u;
      y[k] = op == 1 ? y[k] : x[k];
    }
    const uint32_t under = fp381::sub(lhs, y, r);
    if (under) {
      uint32_t twop[fp381::kWords];
#pragma unroll
      for (int k = 0; k < fp381::kWords; ++k) twop[k] = fp381::kTwoP[k];
      fp381::add(r, twop, r);
    }
  }
  fp381::store(r, out + off);
}

}  // namespace

// Launches K4 on `stream` over n >= 1 elements with op code `op`. The caller
// has checked the device and type, and made a, b and out contiguous (n, 32)
// int32 arrays with 16-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int fp_addsub_launch(const void* a, const void* b, int op, void* out, int n,
                                void* stream) {
  if (op < 0 || op > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  fp_addsub_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), op,
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fp_addsub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
