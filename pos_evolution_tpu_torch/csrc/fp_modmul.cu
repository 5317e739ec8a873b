// K3: base-field multiply, out[e] = a[e] * b[e] mod p, and the static-exponent
// ladder, out[e] = x[e]^k over an MSB-first bit schedule; lazy residues in [0, 2p).
//
// Replaces pos_evolution_tpu/ops/fp.py::modmul (:204, through conv_digits :94,
// carry_norm :130 and barrett_reduce :179), an XLA-jitted function of the JAX
// package, and the jitted lax.scan ladders built on it: fp.py::modinv (:244)
// and g2prep.py::fp_pow_static (:66). The results equal
// pos_evolution_tpu_torch/ops/fp.py::_modmul and ::_pow_static, their plain
// PyTorch versions, digit for digit: (n, 32) int32 canonical digits in, the
// same out.
//
// Why any exact scheme keeps the digits: the inputs are canonical digits,
// fixed by their values, and the output is barrett's formula (fp381.cuh) of
// the exact product x = a * b alone. A chain of products inside one launch
// gives the digits of the same chain of separate launches.
//
// Layout. An operand is read in place: element e = (e_outer, e_inner), with
// e_inner < n_inner, lies at ptr + e_outer * s_outer + e_inner * s_inner
// digits (a stride 0 broadcasts), so strided component views and broadcast
// scalars need no copy. A block takes a run of consecutive elements; their
// rows are staged through shared memory with 16-byte loads, eight
// neighbouring threads on one 128-byte row, and the output run, contiguous,
// is written back the same way.
//
// Work split. With group G = 1 one thread takes one element and runs
// fp381::modmul (K4 and K5 use the same code). With G = 4 the lanes of a
// group take one element together (fp381::modmul_coop): each multiplies
// its share of rows, the partials meet in shared memory. The wrapper picks G
// by the element count (ops/fp.py::k3_group): the group fills the card
// where one thread per element would leave most SMs idle, and costs more
// instructions per element where the card is full (SASS: the product
// kernel is 1,616 instructions at G = 1, 1,280 a lane at G = 4). Device ms
// per launch on one H100 80GB HBM3 at 700 W (chip_smoke.py phase 18, a CUDA
// graph's replay), at G = 1 / 4:
//   [2048]                          0.0079 / 0.0044
//   [4096, 2] (a broadcast scalar)  0.0071 / 0.0053
//   [4096, 2, 2] (16,384 elements)  0.0082 / 0.0072
//   [2048, 16] (32,768)             0.0100 / 0.0116
//   [2048, 32] (65,536)             0.0136 / 0.0203
//   [2048, 64] (131,072)            0.0368 / 0.0439
//   the 610-step ladder at [2048]   1.3441 / 0.7870
// so G = 4 below 32,768 elements and G = 1 from there. The block size
// follows n, so that the blocks spread over the 132 SMs.
//
// The ladder (fp_pow_kernel) keeps each element in registers through every
// square and multiply: acc = 1, then for each bit acc = acc^2, and acc =
// acc * x on a one bit (the port's and the JAX scan's order, the first
// squaring of one included). The bit schedule is a kernel argument
// (__grid_constant__, read from the parameter bank), the same for every
// element, so the branch on a bit is uniform across the grid.
//
// Bounds (H100 SXM at 700 W). A product: 391 32x32->64-bit partial products
// (144 for a * b, 169 for the quotient estimate, 78 for its low product with
// p) on the 64-lane integer-multiply path, 1.673e13/s; and 128 bytes for each
// distinct row read (a broadcast row once) and each row written at 3.35
// TB/s: 384 bytes an element, 256 where one operand is a row the other
// holds; bytes bind at every shape of the path. A ladder: a squaring for
// every bit, 325 partial products (78 for an exact a * a), and a product
// for every one bit, over 256 bytes an element; operations bind: 0.0261 ms
// for the 381 squarings and 229 products of an inversion at 2048 elements.
// A ladder is bound by its chain of dependent products, not by the card's
// throughput: each step waits for the last, ~1.3 us a step at G = 4 (3.3%
// of the work bound).
//
// Not here: tensor cores. Each lane multiplies its own a and b; only the
// products by MU and p share an operand, and at 2048 lanes a ladder is bound
// by its dependency chain. The Fq2 ladder (g2prep.fq2_pow_static) runs on K4
// and K5.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPitch = 9;            // uint4 per staged row: 8 and one of padding
constexpr int kMaxBits = 384;
constexpr int kSharedLimit = 48 * 1024;

struct Rows {
  const int32_t* p;
  long long s_outer, s_inner;         // digits
};

struct PowBits {
  uint32_t w[kMaxBits / 32];         // bit s of the schedule at w[s / 32] >> (s % 32)
  int n;
};

__device__ __forceinline__ const uint4* row_of(const Rows& r, int e, int n_inner) {
  const int eo = e / n_inner;
  const int ei = e - eo * n_inner;
  return reinterpret_cast<const uint4*>(r.p + eo * r.s_outer + ei * r.s_inner);
}

template <int G>
__host__ __device__ constexpr int ws_words() {
  if constexpr (G == 1) return 0;
  else return fp381::Coop<G>::kWsWords;
}

// Shared memory of a block of `elems` elements with `rows` staged rows each.
template <int G>
__host__ __device__ inline size_t shared_bytes(int elems, int rows) {
  return static_cast<size_t>(elems) * (rows * kPitch * 16 + ws_words<G>() * 4);
}

// Stages the rows of the block's `count` elements of `a`, then of `b` where
// there are two operands: operand k's row of element e at
// stage[(k * count + e) * kPitch].
template <int NOPS>
__device__ __forceinline__ void stage_in(const Rows& a, const Rows& b, uint4* stage, int first,
                                         int count, int n_inner) {
  for (int u = threadIdx.x; u < NOPS * count * 8; u += blockDim.x) {
    const int r = u >> 3, part = u & 7;
    const bool second = r >= count;
    const int e = second ? r - count : r;
    stage[r * kPitch + part] = __ldg(row_of(second ? b : a, first + e, n_inner) + part);
  }
}

// Writes the block's output run (count rows staged at stage[e * kPitch]).
__device__ __forceinline__ void stage_out(const uint4* stage, int32_t* out, int first,
                                          int count) {
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<long long>(first) * fp381::kDigits);
  for (int u = threadIdx.x; u < count * 8; u += blockDim.x)
    o[u] = stage[(u >> 3) * kPitch + (u & 7)];
}

template <int G>
__device__ __forceinline__ void product(const uint32_t* a, const uint32_t* b, uint32_t* r,
                                        uint32_t* ws, int g) {
  if constexpr (G == 1) fp381::modmul(a, b, r);
  else fp381::modmul_coop<G>(a, b, r, ws, g);
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
fp_modmul_kernel(Rows a, Rows b, int32_t* __restrict__ out, int n, int n_inner) {
  extern __shared__ uint4 smem[];
  const int elems = blockDim.x / G;
  const int first = blockIdx.x * elems;
  const int count = min(elems, n - first);
  uint4* stage = smem;
  uint32_t* ws = reinterpret_cast<uint32_t*>(stage + 2 * elems * kPitch);
  stage_in<2>(a, b, stage, first, count, n_inner);
  __syncthreads();
  // a group past the run computes on row 0 and stores nothing: every lane
  // of a warp takes part in the group's __syncwarp
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  const int live = e < count ? e : 0;
  uint32_t x[fp381::kWords], y[fp381::kWords], r[fp381::kWords];
  fp381::unstage(stage + live * kPitch, x);
  fp381::unstage(stage + (count + live) * kPitch, y);
  product<G>(x, y, r, ws + e * ws_words<G>(), g);
  __syncthreads();
  if (e < count && g == 0) fp381::stage(r, stage + e * kPitch);
  __syncthreads();
  stage_out(stage, out, first, count);
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
fp_pow_kernel(Rows x, int32_t* __restrict__ out, int n, int n_inner,
              const __grid_constant__ PowBits bits) {
  extern __shared__ uint4 smem[];
  const int elems = blockDim.x / G;
  const int first = blockIdx.x * elems;
  const int count = min(elems, n - first);
  uint4* stage = smem;
  uint32_t* ws = reinterpret_cast<uint32_t*>(stage + elems * kPitch) +
                 (threadIdx.x / G) * ws_words<G>();
  stage_in<1>(x, x, stage, first, count, n_inner);
  __syncthreads();
  const int e = threadIdx.x / G, g = threadIdx.x % G;
  uint32_t base[fp381::kWords], acc[fp381::kWords], t[fp381::kWords];
  fp381::unstage(stage + (e < count ? e : 0) * kPitch, base);
#pragma unroll
  for (int k = 0; k < fp381::kWords; ++k) acc[k] = k == 0;
  for (int s = 0; s < bits.n; ++s) {
    product<G>(acc, acc, t, ws, g);
    if ((bits.w[s >> 5] >> (s & 31)) & 1u) product<G>(t, base, acc, ws, g);
    else {
#pragma unroll
      for (int k = 0; k < fp381::kWords; ++k) acc[k] = t[k];
    }
  }
  __syncthreads();
  if (e < count && g == 0) fp381::stage(acc, stage + e * kPitch);
  __syncthreads();
  stage_out(stage, out, first, count);
}

// Threads per block: the fewest (a multiple of 32, at most 256) that spread
// n elements of G lanes over the 132 SMs, fewer where the staged rows and
// workspaces outgrow 48 KB of shared memory.
template <int G>
int block_threads(int n, int rows) {
  int threads = 32;
  while (threads < kMaxThreads && (static_cast<long long>(n) * G + threads - 1) / threads > 132)
    threads *= 2;
  while (threads > 32 && shared_bytes<G>(threads / G, rows) > kSharedLimit) threads /= 2;
  return threads;
}

template <int G>
int launch_modmul(const Rows& a, const Rows& b, int32_t* out, int n, int n_inner,
                  cudaStream_t stream) {
  const int threads = block_threads<G>(n, 2);
  const int elems = threads / G;
  fp_modmul_kernel<G><<<(n + elems - 1) / elems, threads, shared_bytes<G>(elems, 2), stream>>>(
      a, b, out, n, n_inner);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_pow(const Rows& x, int32_t* out, int n, int n_inner, const PowBits& bits,
               cudaStream_t stream) {
  const int threads = block_threads<G>(n, 1);
  const int elems = threads / G;
  fp_pow_kernel<G><<<(n + elems - 1) / elems, threads, shared_bytes<G>(elems, 1), stream>>>(
      x, out, n, n_inner, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K3's product on `stream` over n >= 1 elements: operand rows at
// a + eo * sa_outer + ei * sa_inner digits (and b likewise) for element
// e = eo * n_inner + ei, out (n, 32) contiguous, each element's G = group
// lanes (1 or 4). Rows and strides are 16-byte aligned int32 canonical
// digits; the caller has checked devices, types and shapes. Returns the
// cudaError_t of the launch.
extern "C" int fp_modmul_launch(const void* a, long long sa_outer, long long sa_inner,
                                const void* b, long long sb_outer, long long sb_inner, void* out,
                                int n, int n_inner, int group, void* stream) {
  if (n < 1 || n_inner < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Rows ra{static_cast<const int32_t*>(a), sa_outer, sa_inner};
  const Rows rb{static_cast<const int32_t*>(b), sb_outer, sb_inner};
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch_modmul<1>(ra, rb, o, n, n_inner, s);
    case 4: return launch_modmul<4>(ra, rb, o, n, n_inner, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K3's ladder on `stream`: out[e] = x[e]^k for the nbits-bit
// MSB-first schedule `bits` (uint32 words, bit s at bits[s / 32] >> (s % 32);
// 1 <= nbits <= 384), x laid out as fp_modmul_launch's operands.
extern "C" int fp_pow_launch(const void* x, long long sx_outer, long long sx_inner, void* out,
                             int n, int n_inner, const void* bits, int nbits, int group,
                             void* stream) {
  if (n < 1 || n_inner < 1 || nbits < 1 || nbits > kMaxBits)
    return static_cast<int>(cudaErrorInvalidValue);
  PowBits pb{};
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  for (int k = 0; k < (nbits + 31) / 32; ++k) pb.w[k] = w[k];
  pb.n = nbits;
  const Rows rx{static_cast<const int32_t*>(x), sx_outer, sx_inner};
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch_pow<1>(rx, o, n, n_inner, pb, s);
    case 4: return launch_pow<4>(rx, o, n, n_inner, pb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fp_modmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* fp_pow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
