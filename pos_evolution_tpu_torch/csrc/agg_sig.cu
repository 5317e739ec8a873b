// K1: FakeBLS committee aggregates, fused into one kernel.
//
// Replaces pos_evolution_tpu/ops/pallas_aggregation.py::_agg_sig_kernel
// together with the XLA glue around it: the pk_states[committees] gather and
// (A, 8, C) transpose before it, and the masked XOR fold after it. The
// result equals pos_evolution_tpu_torch/ops/aggregation.py::
// _committee_aggregates, its plain PyTorch version: (A, 24) words, the XOR
// over each committee's set bits of the signer's FakeBLS signature
// h1 | h2 | h3, where h1 = compress(midstate, message block), h2 = H(h1),
// h3 = H(h2).
//
// Bound: integer ALU work. Each signer costs 3 compressions of 64 rounds,
// about 3,700 32-bit instructions at the fewest (LOP3 and IADD3 fuse three
// inputs), and one launch at mainnet width covers 2^20 signers, about
// 3.9e9 instructions: 0.12 ms at the H100's issue limit, 0.23 ms if they
// all go to the 64-lane INT32 pipe. Against that it reads only ~38 MB
// (the 32-byte midstate of each signer, gathered by index, plus committee
// indices and bits), 11 us at 3.35 TB/s. The design keeps every
// intermediate in registers: no gathered (A, 8, C) copy, no (A, 24, C)
// signature array, one atomicXor per warp per output word.
//
// Layout: one block per (committee, 128-signer chunk). Warp 0 builds the
// attestation's 64-word schedule once into shared memory (every thread reads
// the same word at the same time: a broadcast). Each thread gathers its
// signer's midstate, runs the three compressions, masks each digest by its
// bit, and the warp XOR-folds with shuffles. XOR is order-free, so the
// result does not depend on the order of the atomics.
//
// Not tuned: no persistent blocks, no interleaving of independent signers
// per thread to hide the round chain's latency.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void fold_store(const uint32_t h[8], bool keep, uint32_t* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t x = keep ? h[i] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0) atomicXor(dst + i, x);
  }
}

__global__ void __launch_bounds__(kThreads)
agg_sig_kernel(const uint32_t* __restrict__ pk_states,   // (N, 8)
               const int32_t* __restrict__ committees,   // (A, C)
               const uint8_t* __restrict__ bits,         // (A, C), 0 or 1
               const uint32_t* __restrict__ msg_words,   // (A, 8)
               uint32_t* __restrict__ out,               // (A, 24), zeroed
               int c) {
  __shared__ uint32_t w2[64];
  const int a = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;

  // Second signature block: message(32) | 0x80 | zeros | length 96 bytes.
  if (threadIdx.x < 16) {
    uint32_t word = 0u;
    if (threadIdx.x < 8) word = msg_words[a * 8 + threadIdx.x];
    if (threadIdx.x == 8) word = 0x80000000u;
    if (threadIdx.x == 15) word = 96u * 8u;
    w2[threadIdx.x] = word;
  }
  __syncwarp();
  if (threadIdx.x == 0) sha256::schedule(w2);
  __syncthreads();

  // Lanes past the committee's end still run (every lane of a warp takes
  // part in the shuffles) but contribute zero.
  const bool in_range = lane < c;
  bool keep = false;
  uint32_t h[8];
  if (in_range) {
    const size_t row = static_cast<size_t>(a) * c + lane;
    keep = bits[row] != 0;
    const int64_t v = committees[row];
    const uint4* src = reinterpret_cast<const uint4*>(pk_states + v * 8);
    const uint4 lo = src[0];
    const uint4 hi = src[1];
    h[0] = lo.x; h[1] = lo.y; h[2] = lo.z; h[3] = lo.w;
    h[4] = hi.x; h[5] = hi.y; h[6] = hi.z; h[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = 0u;
  }

  uint32_t* dst = out + static_cast<size_t>(a) * 24;
  sha256::compress_scheduled(h, w2);
  fold_store(h, keep, dst);
  sha256::chain_hash(h);
  fold_store(h, keep, dst + 8);
  sha256::chain_hash(h);
  fold_store(h, keep, dst + 16);
}

}  // namespace

// Launches K1 on `stream`. `out` must hold A * 24 zeroed words. The caller
// has checked devices, types, shapes (A and C at least 1), contiguity,
// 16-byte alignment of pk_states and that every committee index lies in
// [0, N). Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int agg_sig_launch(const void* pk_states, const void* committees,
                              const void* bits, const void* msg_words, void* out,
                              int a, int c, void* stream) {
  const dim3 grid((c + kThreads - 1) / kThreads, a);
  agg_sig_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pk_states), static_cast<const int32_t*>(committees),
      static_cast<const uint8_t*>(bits), static_cast<const uint32_t*>(msg_words),
      static_cast<uint32_t*>(out), c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* agg_sig_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
