// K2: one merkle tree level, out[i] = SHA-256(left[i] || right[i]).
//
// Replaces pos_evolution_tpu/ops/pallas_sha256.py::_merkle_level_kernel
// (:88, launched by _pallas_level_call / merkle_level_pallas). The result
// equals pos_evolution_tpu_torch/ops/merkle_device.py::_merkle_level, its
// plain PyTorch version: (N, 8) big-endian digest words from (N, 8) left and
// right node words, for any N >= 1.
//
// The Pallas kernel laid pairs out word-major, (16, N), so that each round
// was one op over a 512-wide lane tile. Hopper needs no transpose: one
// thread hashes one pair, reading its two 32-byte nodes with 16-byte vector
// loads straight from the (N, 8) rows. Each pair is two compressions: the
// 64-byte message (schedule computed on the fly in a 16-word ring), then
// the fixed padding block (0x80000000, zeros, bit length 512), whose
// 64-word schedule is the same for every pair and sits in __constant__
// memory below (every thread of a warp reads the same word: a broadcast).
//
// Bound: integer ALU work. At the fewest sm_90 instructions (3-input LOP3
// and IADD3, one funnel shift per rotate) a pair costs 2,288 lane
// instructions: 1,384 for the message compression with its schedule
// (64 rounds x 14 + 8 feed-forward adds + 48 schedule words x 10), 904 for
// the padding compression with the schedule precomputed. The H100 issues
// at most 33.5e12 lane instructions per second, so a level of 2^22 pairs
// needs at least 0.29 ms. It moves 96 bytes per pair (two 32-byte nodes
// in, one out): 0.12 ms for the same level at 3.35 TB/s. So operations
// bound it; the design keeps everything in registers and reads each node
// once.
//
// Rows may be strided (a level's even and odd rows are the left and right
// views of one (2N, 8) array, a row stride of 16 words), so the caller
// never copies them apart; every row must be 16-byte aligned.
//
// Not tuned: no interleaving of two pairs per thread to hide the round
// chain's latency, no IMAD for adds, no persistent blocks.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

// Schedule of the padding block of a 64-byte message: w[0] = 0x80000000,
// w[15] = 512, the rest of the block zero, w[16..63] expanded from those.
// Checked against the plain schedule in tests/test_torch_merkle.py.
__constant__ uint32_t kPadSchedule[64] = {
    0x80000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000200u, 0x80000000u, 0x01400000u,
    0x00205000u, 0x00005088u, 0x22000800u, 0x22550014u, 0x05089742u, 0xA0000020u,
    0x5A880000u, 0x005C9400u, 0x0016D49Du, 0xFA801F00u, 0xD33225D0u, 0x11675959u,
    0xF6E6BFDAu, 0xB30C1549u, 0x08B2B050u, 0x9D7C4C27u, 0x0CE2A393u, 0x88E6E1EAu,
    0xA52B4335u, 0x67A16F49u, 0xD732016Fu, 0x4EEB2E91u, 0x5DBF55E5u, 0x8EEE2335u,
    0xE2BC5EC2u, 0xA83F4394u, 0x45AD78F7u, 0x36F3D0CDu, 0xD99C05E8u, 0xB0511DC7u,
    0x69BC7AC4u, 0xBD11375Bu, 0xE3BA71E5u, 0x3B209FF2u, 0x18FEEE17u, 0xE25AD9E7u,
    0x13375046u, 0x0515089Du, 0x4F0D0F04u, 0x2627484Eu, 0x310128D2u, 0xC668B434u,
    0x420841CCu, 0x62D311B8u, 0xE59BA771u, 0x85A7A484u,
};

__global__ void __launch_bounds__(kThreads)
merkle_level_kernel(const uint32_t* __restrict__ left, int64_t left_stride,
                    const uint32_t* __restrict__ right, int64_t right_stride,
                    uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4* l = reinterpret_cast<const uint4*>(left + i * left_stride);
  const uint4* r = reinterpret_cast<const uint4*>(right + i * right_stride);
  const uint4 l0 = l[0], l1 = l[1], r0 = r[0], r1 = r[1];
  const uint32_t block[16] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w,
                              r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = sha256::kH0[k];
  sha256::compress(h, block);
  sha256::compress_scheduled(h, kPadSchedule);
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(i) * 8);
  o[0] = make_uint4(h[0], h[1], h[2], h[3]);
  o[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace

// Launches K2 on `stream` over n >= 1 pairs. Strides are in 32-bit words
// between consecutive rows. The caller has checked devices, types, shapes,
// that each row's 8 words are contiguous and every row 16-byte aligned, and
// that `out` is a contiguous (n, 8) array. Returns the cudaError_t of the
// launch (0 when it was accepted).
extern "C" int merkle_level_launch(const void* left, long long left_stride,
                                   const void* right, long long right_stride,
                                   void* out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  merkle_level_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(left), static_cast<int64_t>(left_stride),
      static_cast<const uint32_t*>(right), static_cast<int64_t>(right_stride),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* merkle_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
