// K7: batched GF(2^8) matrix product, out[g] = A[g] (r x k) * B[g] (k x W),
// bytes as field elements, sums as XOR.
//
// Replaces no Pallas kernel: it is the hand-written form of the XLA-jitted
// pos_evolution_tpu/ops/das_verify.py::_reconstruct_kernel (:147, the
// erasure interpolation and re-extension of a DAS blob) and of the host
// product das/erasure.py::gf_matmul (the extension of a blob's data cells).
// The result equals pos_evolution_tpu_torch/ops/das_verify.py::_gf_matmul,
// its plain PyTorch version. The field is the repo's: AES polynomial 0x11B,
// generator 0x03, products as exp[log a + log b].
//
// The tables come in as one 1,536-byte array: exp[0..1023] (exp[i] = 3^i
// for i < 510, wrapped at 255, then zeros) and log[0..255] as 16-bit
// values with log[0] = 510. A zero factor then indexes the zero tail
// (510 + log b <= 1020), so no product needs a branch. Both tables and the
// block's rows of A (as logs) sit in shared memory.
//
// A block takes one group g, 32 rows of A and 256 output columns: 256
// threads, each one 4-byte column word of B and 8 rows. Per inner index t
// a thread reads one word of B (coalesced across the warp), looks up its 4
// logs, then for each of its 8 rows reads the row's log of A[g, row, t] (the
// same address across the warp: a broadcast) and ORs 4 exp lookups into
// one word, XOR-accumulated in a register. Integer tables have no rounding,
// so every order of the XOR gives the same bytes.
//
// Bound: shared-memory lookups. An output byte needs k exp lookups (plus
// k / 8 log lookups of B); the H100 serves at most 32 four-byte shared
// loads per SM per clock, 8.4e12 a second over 132 SMs at 1.98 GHz. The
// bytes (A, B once, the output once) bound it ~50x lower at the DAS
// shapes (k = 64).
//
// Not tuned: exp lookups from 32 threads land on random banks (conflicts);
// B is read again by each of the ceil(r / 32) row tiles (from L2).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kColWords = 64;                          // 4-byte words of a block's columns
constexpr int kRowsPerThread = 8;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kColWords;       // 4
constexpr int kRowsPerBlock = kRowGroups * kRowsPerThread;  // 32
constexpr int kMaxK = 256;
constexpr int kExpEntries = 1024;
constexpr uint16_t kLogZero = 510;

__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* __restrict__ tables, const uint8_t* __restrict__ a,
                    long long a_gstride, const uint8_t* __restrict__ b, long long b_gstride,
                    uint8_t* __restrict__ out, int r, int k, int w) {
  __shared__ uint8_t s_exp[kExpEntries];
  __shared__ uint16_t s_log[256];
  __shared__ uint16_t s_a[kRowsPerBlock][kMaxK];

  const int g = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const uint16_t* log_in = reinterpret_cast<const uint16_t*>(tables + kExpEntries);
  for (int i = threadIdx.x; i < kExpEntries; i += kThreads) s_exp[i] = tables[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_log[i] = log_in[i];
  __syncthreads();
  const uint8_t* ag = a + g * a_gstride;
  for (int idx = threadIdx.x; idx < kRowsPerBlock * k; idx += kThreads) {
    const int i = idx / k, t = idx - i * k;
    const int row = row0 + i;
    s_a[i][t] = row < r ? s_log[ag[static_cast<int64_t>(row) * k + t]] : kLogZero;
  }
  __syncthreads();

  const int wwords = w >> 2;
  const int cw = blockIdx.x * kColWords + (threadIdx.x % kColWords);
  const int rg = threadIdx.x / kColWords;
  if (cw >= wwords) return;
  const uint32_t* bg = reinterpret_cast<const uint32_t*>(b + g * b_gstride);
  uint32_t acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0u;
  for (int t = 0; t < k; ++t) {
    const uint32_t bw = bg[static_cast<int64_t>(t) * wwords + cw];
    const int l0 = s_log[bw & 0xFFu], l1 = s_log[(bw >> 8) & 0xFFu];
    const int l2 = s_log[(bw >> 16) & 0xFFu], l3 = s_log[bw >> 24];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int la = s_a[rg * kRowsPerThread + j][t];
      acc[j] ^= static_cast<uint32_t>(s_exp[la + l0]) |
                (static_cast<uint32_t>(s_exp[la + l1]) << 8) |
                (static_cast<uint32_t>(s_exp[la + l2]) << 16) |
                (static_cast<uint32_t>(s_exp[la + l3]) << 24);
    }
  }
  uint32_t* og = reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(g) * r * w);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = row0 + rg * kRowsPerThread + j;
    if (row < r) og[static_cast<int64_t>(row) * wwords + cw] = acc[j];
  }
}

}  // namespace

// Launches K7 on `stream`: g_count groups of an (r, k) by (k, w) product,
// 1 <= k <= 256, w a multiple of 4. A and B are contiguous within a group;
// `a_gstride` and `b_gstride` are the bytes between groups (0 broadcasts
// one matrix to every group); every group's B is 4-byte aligned; `out` is a
// contiguous (g_count, r, w) array. Returns the cudaError_t of the launch
// (0 when it was accepted).
extern "C" int gf256_matmul_launch(const void* tables, const void* a, long long a_gstride,
                                   const void* b, long long b_gstride, void* out, int g_count,
                                   int r, int k, int w, void* stream) {
  if (k < 1 || k > kMaxK || (w & 3)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w / 4 + kColWords - 1) / kColWords, g_count,
                  (r + kRowsPerBlock - 1) / kRowsPerBlock);
  gf256_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(a), a_gstride,
      static_cast<const uint8_t*>(b), b_gstride, static_cast<uint8_t*>(out), r, k, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf256_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
