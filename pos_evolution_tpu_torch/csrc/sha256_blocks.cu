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
// Two designs behind one entry point, chosen by the shape (kChainsBelow
// messages, kChainsMinBlocks blocks; measured on the H100 by
// bench_k67.py --designs and chip_smoke.py):
//
// * Few long chains (sha256_blocks_kernel_chains). The blocks of a message
//   are a chain, so 1,152 PeerDAS cells of 33 blocks fill 36 warps of a
//   132-SM card: one thread a message leaves each warp alone on its
//   scheduler with the schedule and the rounds in one instruction stream.
//   Here a block of two warps takes 32 messages. The producer warp copies
//   each message's next kRawDepth blocks into shared memory by cp.async
//   (LDGSTS, no registers held while in flight), expands each block's
//   64-word schedule with K[t] folded in (W[t] + K[t]) and hands it over
//   through a ring of kSchedDepth slots guarded by mbarriers (full: the
//   producer's 32 lanes arrived; empty: the consumer's). The consumer warp
//   loads a block's 64 words (16 vector loads), releases the slot and runs
//   only the 64 rounds (round_kw): 6 funnel shifts, 4 LOP3 and
//   one IADD3 a round on the integer pipe, the other six adds as IMADs on
//   the FMA pipe, and the schedule's work on another scheduler.
// * Many messages (sha256_blocks_kernel). The card is full, so one thread
//   hashes one message, block after block, its state and the 16-word
//   schedule ring in registers (sha256.cuh::compress); the next block's
//   four 16-byte loads are issued before the current compression (a
//   software prefetch). Blocks of 128 threads: a warp's time is set by the
//   warps sharing its scheduler, so blocks of 32 measured no better (0.92-
//   1.09x, no consistent winner, 256 to 1,048,576 messages of 1-33
//   blocks). Messages of one block take this design at any count: with no
//   chain to hide the chains lose (0.0039-0.0044 against 0.0037-0.0038 ms
//   below 8,448 messages); from two blocks they win (by 5-11% at two).
//
// Bound: integer ALU work. A block costs 1,384 lane instructions at the
// fewest (64 rounds x 14, 8 feed-forward adds, 48 schedule words x 10);
// the H100 issues at most 33.5e12 lane instructions per second, and its
// integer pipe (LOP3, SHF: 16 lanes a scheduler) 16.7e12. A chain is bound
// by its one scheduler's integer pipe: 11 instructions a round at 2 cycles
// each, 64 x 33 rounds, 23.5 us at 1.98 GHz for a cell of 33 blocks. The
// bytes (each message byte once, 32 a digest) bound it ~20x lower.
//
// Not tuned: one consumer warp a block and the ring depths (a deeper
// schedule ring with the consumer's loads double-buffered and 4-warp blocks
// measured no faster); the chains win again at 18,432 messages, not used;
// the many-message design keeps compress (the kernels K1 and K2 share it)
// and at 36,864 x 33 reaches ~55% of the integer-pipe bound with 2.2 warps
// a scheduler, bound by the rounds' latency, not the pipe.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

// Messages below which a launch of messages of at least kChainsMinBlocks
// blocks takes the warp-specialized design: two chain blocks an SM of 132
// (H100, at 2, 3, 4, 8 and 33 blocks: the chains win at 8,448 messages, one
// thread a message at 9,216).
constexpr int kChainsBelow = 8448;
constexpr int kChainsMinBlocks = 2;
constexpr int kThreads = 128;      // one thread a message: threads a block

constexpr int kLanes = 32;
constexpr int kRawDepth = 4;       // raw blocks in flight per message (cp.async groups)
constexpr int kSchedDepth = 2;     // expanded schedules between producer and consumer
constexpr int kRawStride = 20;     // words a lane in a raw slot: 16 and 4 of padding, so
                                   // that a quarter warp's 16-byte reads hit 32 banks

struct ChainsShared {
  uint4 sched[kSchedDepth][16][kLanes];          // W[t] + K[t], four rounds a vector
  uint32_t raw[kRawDepth][kLanes][kRawStride];   // the message blocks as copied
  unsigned long long full[kSchedDepth];
  unsigned long long empty[kSchedDepth];
};

static __constant__ uint32_t kOne = 1u;     // mad1's multiplier

// a * one + b as an IMAD, which issues to the FMA pipe and leaves the
// integer pipe (LOP3, SHF, IADD3) to the rotates: `one` is 1 from a register
// whose value the compiler cannot see, so it keeps the multiply-add.
__device__ __forceinline__ uint32_t mad1(uint32_t a, uint32_t one, uint32_t b) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// One round from kw = W[t] + K[t] (the round constant folded into the
// schedule). h + kw and d + h + kw do not depend on this round's e, so the
// chain from e to the next e is Sigma1 (funnel shifts, one LOP3) and two
// adds; six of the round's seven adds are IMADs (mad1).
__device__ __forceinline__ void round_kw(uint32_t v[8], uint32_t kw, uint32_t one) {
  const uint32_t e = v[4];
  const uint32_t a = v[0];
  const uint32_t hk = mad1(v[7], one, kw);
  const uint32_t dhk = mad1(v[3], one, hk);
  const uint32_t s1 = sha256::rotr(e, 6) ^ sha256::rotr(e, 11) ^ sha256::rotr(e, 25);
  const uint32_t ch = (e & v[5]) ^ (~e & v[6]);
  const uint32_t s0 = sha256::rotr(a, 2) ^ sha256::rotr(a, 13) ^ sha256::rotr(a, 22);
  const uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
  const uint32_t x = mad1(s1, one, ch);
  v[7] = v[6];
  v[6] = v[5];
  v[5] = v[4];
  v[4] = mad1(dhk, one, x);
  v[3] = v[2];
  v[2] = v[1];
  v[1] = a;
  v[0] = mad1(hk, one, x) + s0 + maj;
}

// One compression from kw[t] = W[t] + K[t], feed-forward included; `one`
// as round_kw takes it.
__device__ __forceinline__ void compress_kw(uint32_t state[8], const uint32_t kw[64],
                                            uint32_t one) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = state[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) round_kw(v, kw[t], one);
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] += v[i];
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy block b of a message row into a lane's raw slot: four 16-byte copies.
__device__ __forceinline__ void fetch_block(const uint32_t* row, int b, uint32_t* slot) {
#pragma unroll
  for (int q = 0; q < 4; ++q) cp_async16(slot + 4 * q, row + 16 * b + 4 * q);
}

// The consumer's wait for block b's schedule and its 16 vector loads of it.
__device__ __forceinline__ void take_schedule(ChainsShared& s, int b, int lane, uint32_t kw[64]) {
  const int ss = b % kSchedDepth;
  mbar_wait(&s.full[ss], (b / kSchedDepth) & 1);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(smem(&s.sched[ss][q][lane])));
    kw[4 * q] = v.x;
    kw[4 * q + 1] = v.y;
    kw[4 * q + 2] = v.z;
    kw[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(2 * kLanes)
sha256_blocks_kernel_chains(const uint32_t* __restrict__ words, int64_t row_words,
                            int n_blocks, uint32_t* __restrict__ out, int n) {
  __shared__ __align__(16) ChainsShared s;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kLanes + lane;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kSchedDepth; ++j) {
      mbar_init(&s.full[j], kLanes);
      mbar_init(&s.empty[j], kLanes);
    }
  }
  __syncthreads();

  if (threadIdx.x < kLanes) {
    // producer: a lane past the batch hashes the last row again (its
    // consumer lane stores nothing), so every lane arrives on every barrier
    const uint32_t* row = words + static_cast<int64_t>(min(i, n - 1)) * row_words;
#pragma unroll
    for (int b = 0; b < kRawDepth; ++b) {
      if (b < n_blocks) fetch_block(row, b, s.raw[b][lane]);
      cp_async_commit();
    }
    for (int b = 0; b < n_blocks; ++b) {
      const int rs = b % kRawDepth;
      cp_async_wait<kRawDepth - 1>();    // block b's copies (this lane's) have landed
      uint32_t w[64];
      const uint4* raw = reinterpret_cast<const uint4*>(s.raw[rs][lane]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = raw[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      sha256::schedule(w);
      const int ss = b % kSchedDepth;
      if (b >= kSchedDepth) mbar_wait(&s.empty[ss], (b / kSchedDepth - 1) & 1);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        s.sched[ss][q][lane] =
            make_uint4(w[4 * q] + sha256::kK[4 * q], w[4 * q + 1] + sha256::kK[4 * q + 1],
                       w[4 * q + 2] + sha256::kK[4 * q + 2], w[4 * q + 3] + sha256::kK[4 * q + 3]);
      }
      mbar_arrive(&s.full[ss]);
      // the raw slot's words went into the stores above, so it is free
      if (b + kRawDepth < n_blocks) fetch_block(row, b + kRawDepth, s.raw[rs][lane]);
      cp_async_commit();
    }
    return;
  }

  // consumer: the 64 rounds of each block from the ring; the block's words
  // are all loaded before its rounds, and its slot released once they landed
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = sha256::kH0[k];
  const uint32_t one = kOne;
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t kw[64];
    take_schedule(s, b, lane, kw);
    mbar_arrive(&s.empty[b % kSchedDepth]);
    compress_kw(h, kw, one);
  }
  if (i < n) {
    uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(i) * 8);
    o[0] = make_uint4(h[0], h[1], h[2], h[3]);
    o[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

__global__ void __launch_bounds__(128)
sha256_blocks_kernel(const uint32_t* __restrict__ words, int64_t row_words, int n_blocks,
                     uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* msg = reinterpret_cast<const uint4*>(words + static_cast<int64_t>(i) * row_words);
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = sha256::kH0[k];
  uint4 q0 = msg[0], q1 = msg[1], q2 = msg[2], q3 = msg[3];
  for (int b = 0; b < n_blocks; ++b) {
    const uint32_t block[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                                q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
    if (b + 1 < n_blocks) {      // the next block's loads, in flight during this compression
      q0 = msg[4 * b + 4];
      q1 = msg[4 * b + 5];
      q2 = msg[4 * b + 6];
      q3 = msg[4 * b + 7];
    }
    sha256::compress(h, block);
  }
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(i) * 8);
  o[0] = make_uint4(h[0], h[1], h[2], h[3]);
  o[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// The design a launch of n messages of n_blocks blocks takes, as launch's
// `threads`.
int threads_for(int n, int n_blocks) {
  return n < kChainsBelow && n_blocks >= kChainsMinBlocks ? 0 : kThreads;
}

// `threads` 0: the warp-specialized chains; else one thread a message in
// blocks of `threads` (a multiple of 32, at most 128).
int launch(const void* words, long long row_words, int n_blocks, void* out, int n, int threads,
           void* stream) {
  if (n_blocks < 1 || threads < 0 || threads > 128 || threads % kLanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (threads == 0) {
    sha256_blocks_kernel_chains<<<(n + kLanes - 1) / kLanes, 2 * kLanes, 0, st>>>(
        w, static_cast<int64_t>(row_words), n_blocks, o, n);
  } else {
    sha256_blocks_kernel<<<static_cast<int>((static_cast<long long>(n) + threads - 1) / threads),
                           threads, 0, st>>>(w, static_cast<int64_t>(row_words), n_blocks, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6 on `stream` over n >= 1 messages of n_blocks >= 1 blocks,
// in the design the shape picks (threads_for). `row_words` is the distance
// between rows in 32-bit words (16 * n_blocks for a contiguous array). The
// caller has checked devices, types and shapes, that every row is 16-byte
// aligned and that `out` is a contiguous (n, 8) array. Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" int sha256_blocks_launch(const void* words, long long row_words, int n_blocks,
                                    void* out, int n, void* stream) {
  return launch(words, row_words, n_blocks, out, n, threads_for(n, n_blocks), stream);
}

// The same with the design named by `threads` (0: the chains; 32-128: one
// thread a message in blocks of that many). The measuring hook for
// threads_for's constants (bench_k67.py --designs); no wrapper calls it.
extern "C" int sha256_blocks_design_launch(const void* words, long long row_words,
                                           int n_blocks, void* out, int n, int threads,
                                           void* stream) {
  return launch(words, row_words, n_blocks, out, n, threads, stream);
}

// The message count from which sha256_blocks_launch takes one thread a
// message, and the blocks a message needs below it for the chains.
extern "C" int sha256_blocks_chains_below() { return kChainsBelow; }
extern "C" int sha256_blocks_chains_min_blocks() { return kChainsMinBlocks; }

extern "C" const char* sha256_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* sha256_blocks_design_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
