// K6: SHA-256 of N equal-length, pre-padded messages,
// out[i] = SHA-256 of the 16 * n_blocks words of row i.
//
// Replaces no Pallas kernel: it is the hand-written form of the
// XLA-jitted multi-block hash of the JAX package,
// pos_evolution_tpu/ops/sha256.py::sha256_words (reached from
// ops/das_verify.py::verify_samples_device, :107, for the DAS cell leaves),
// and of its host hash of equal-length batches, ssz/hash.py::sha256_batch
// (the blob counter stream, the cell leaves of a commitment, the sampling
// clients' and light clients' digests). The result equals
// pos_evolution_tpu_torch/ops/sha256.py::sha256_words, its plain PyTorch
// version: (N, 8) big-endian digest words from (N, 16 * n_blocks) message
// words that already carry the padding (0x80, zeros, the bit length).
// With the padding left out, one block gives the block's midstate from H0.
//
// One thread hashes one message, block after block, its state and the
// 16-word schedule ring in registers (sha256.cuh); a block's four 16-byte
// vector loads come straight from the row. The blocks of one message are
// a chain, so a batch of few long messages (1,152 PeerDAS cells of 33
// blocks) fills a fraction of the card and its latency binds, not the
// issue rate.
//
// Bound: integer ALU work. A block costs 1,384 lane instructions at the
// fewest (64 rounds x 14, 8 feed-forward adds, 48 schedule words x 10);
// the H100 issues at most 33.5e12 lane instructions per second. It moves
// each message byte once and 32 bytes a digest, so at 64 bytes a block
// the bytes bound (3.35 TB/s) is ~20x lower than the work's.
//
// Not tuned: one message per thread, no interleaving of two messages to
// hide the round chain's latency, no coalescing of the row loads.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sha256_blocks_kernel(const uint32_t* __restrict__ words, int64_t row_words, int n_blocks,
                     uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4* msg = reinterpret_cast<const uint4*>(words + static_cast<int64_t>(i) * row_words);
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = sha256::kH0[k];
  for (int b = 0; b < n_blocks; ++b) {
    const uint4 q0 = msg[4 * b], q1 = msg[4 * b + 1], q2 = msg[4 * b + 2], q3 = msg[4 * b + 3];
    const uint32_t block[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                                q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
    sha256::compress(h, block);
  }
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(i) * 8);
  o[0] = make_uint4(h[0], h[1], h[2], h[3]);
  o[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace

// Launches K6 on `stream` over n >= 1 messages of n_blocks >= 1 blocks.
// `row_words` is the distance between rows in 32-bit words (16 * n_blocks
// for a contiguous array). The caller has checked devices, types and shapes,
// that every row is 16-byte aligned and that `out` is a contiguous (n, 8)
// array. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int sha256_blocks_launch(const void* words, long long row_words, int n_blocks,
                                    void* out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  sha256_blocks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int64_t>(row_words), n_blocks,
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sha256_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
