// K7: batched GF(2^8) matrix product, out[g] = A[g] (r x k) * B[g] (k x W),
// bytes as field elements, sums as XOR.
//
// Replaces no Pallas kernel: it is the hand-written form of the XLA-jitted
// pos_evolution_tpu/ops/das_verify.py::_reconstruct_kernel (:147, the
// erasure interpolation and re-extension of a DAS blob) and of the host
// product das/erasure.py::gf_matmul (the extension of a blob's data cells).
// The result equals pos_evolution_tpu_torch/ops/das_verify.py::_gf_matmul,
// its plain PyTorch version. The field is the repo's: AES polynomial 0x11B.
//
// The product as a GF(2) bit-matrix product on the int8 tensor cores.
// Multiplying by a fixed byte a is GF(2)-linear: a * b = XOR over q of
// bit q of b times a * x^q. So with M_a[p][q] = bit p of a * x^q (x^q by
// xtime under 0x11B), bit p of out[i][c] is the parity of
//   sum over t, q of M_{a[i][t]}[p][q] * bit q of b[t][c],
// an integer product of 0/1 matrices of 8r x 8k and 8k x W. The sum is at
// most 8k <= 2,048, exact in int32; its low bit is the GF(2) bit.
//
// One wgmma (m64n128k32, s8 x s8 -> s32, A from registers, B from shared
// memory) takes 64 output columns (its M: a warpgroup, 16 a warp), 16 byte
// rows' 128 bit rows (its N) and 32 bits of the inner dimension (its K):
// four inner indices t0..t0+3, k-slot 4u + j <-> (t0 + j, bit q = u) and
// 16 + 4u + j <-> (t0 + j, q = 4 + u). So a lane's A register (lane
// u = lane % 4, column c) is (Wc >> u) & 0x01010101 with Wc the four bytes
// b[t0..t0+3][c], and B's bit row p of byte row i holds (V_q >> p) &
// 0x01010101 for q = 0..7, with V_q the four bytes a[i][t0..t0+3] * x^q:
// two instructions a word, no table and no lookup.
//
// A block of two warpgroups takes 128 columns x 16 byte rows of one group
// and walks the inner index in stages of 32. Per stage, B's 32 x 128 bytes
// come in by cp.async (issued during the previous stage's MMAs) and are
// transposed into column words (four PRMT pairs); A's 16 x 32 bytes become
// the wgmma B operand in shared memory (V_q by SWAR xtime of four bytes at
// once; 8 x 16-byte core matrices, K-major, no swizzle: 128 bytes between
// the two K halves, 272 between byte rows, so the build's 16-byte stores
// hit distinct banks). Each warp builds its A registers for 4 k-steps, the
// warpgroup issues their 4 wgmmas and waits for them, twice a stage (16 A
// registers in flight: the kernel fits 128 registers without a spill). The
// epilogue takes each accumulator's low bit, ORs the 8 bit rows of a byte
// across the 4 lanes that hold them (two shuffles, two byte rows a word)
// and stores two bytes a lane.
//
// Bound: the tensor cores, 2 * (8r)(8k)W int8 operations a group at 1,979
// TOP/s (0.0098 ms at the regrid (9, 128, 64) x (9, 64, 2,048)); the bytes
// (A, B and the output once) bound it ~9x lower. The former log/exp lookup
// design was bound at 0.0182 ms by the shared-memory lookups.
//
// Not tuned: one stage of shared memory, so a block's wgmmas wait for its
// own stage builds (the bit tables, built again by every column tile and by
// every group of a broadcast A, the transposes, the copies and barriers)
// and the build of the next stage does not run under them; no warp
// specialization; N = 128, not 256.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 256;
constexpr int kThreads = 256;             // 2 warpgroups, 64 columns each
constexpr int kBlockCols = 128;
constexpr int kBlockRows = 16;            // byte rows: wgmma N = 128 bit rows
constexpr int kTileT = 32;                // inner indices a stage
constexpr int kChunks = kTileT / 4;       // wgmma k-steps a stage (32 bits each)
constexpr int kCoreK = 128;               // bytes between a byte row's two K-half core matrices
constexpr int kCoreStride = 272;          // bytes between byte rows' core-matrix pairs
constexpr uint32_t kBits = 0x01010101u;

struct Shared {
  uint32_t raw[kTileT][kBlockCols / 4];              // B's tile as copied: [t][4 columns]
  uint32_t cols[kChunks][kBlockCols];                // [chunk][column]: 4 t-bytes each
  alignas(128) unsigned char bits[kChunks][kBlockRows * kCoreStride];  // wgmma B: core matrices
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t xtime4(uint32_t v) {
  return ((v & 0x7F7F7F7Fu) << 1) ^ (((v >> 7) & kBits) * 0x1Bu);
}

// d += A (this warp's 16 x 32 slab in registers) x B (descriptor), async:
// the warpgroup waits for it with wgmma.wait_group
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The wgmma descriptor of a K-major, no-swizzle B tile at p: its start, the
// leading byte offset (between core matrices along K) and the stride byte
// offset (between core matrices along N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem(p);
  return ((addr & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(kCoreK >> 4) << 16) |
         (static_cast<uint64_t>(kCoreStride >> 4) << 32);
}

__device__ __forceinline__ void load_b_tile(Shared& s, const uint8_t* bg, int t0, int col0,
                                            int k, int w, bool vec16) {
  if (vec16) {
    const int t = t0 + threadIdx.x / 8, c = col0 + 16 * (threadIdx.x % 8);
    const int bytes = t < k ? max(0, min(16, w - c)) : 0;
    const uint8_t* src = bytes ? bg + static_cast<int64_t>(t) * w + c : bg;
    cp_async16(&s.raw[threadIdx.x / 8][4 * (threadIdx.x % 8)], src, bytes);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int t = t0 + idx / 32, c = col0 + 4 * (idx % 32);
      const int bytes = t < k && c < w ? 4 : 0;
      const uint8_t* src = bytes ? bg + static_cast<int64_t>(t) * w + c : bg;
      cp_async4(&s.raw[idx / 32][idx % 32], src, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
gf256_matmul_kernel(const uint8_t* __restrict__ a, long long a_gstride,
                    const uint8_t* __restrict__ b, long long b_gstride,
                    uint8_t* __restrict__ out, int r, int k, int w, bool vec16) {
  __shared__ __align__(128) Shared s;
  const int g = blockIdx.y;
  const int col0 = blockIdx.x * kBlockCols;
  const int row0 = blockIdx.z * kBlockRows;
  const uint8_t* ag = a + g * a_gstride;
  const uint8_t* bg = b + g * b_gstride;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, u = lane % 4;
  // this warp's 16 columns: warpgroup warp / 4 has 64, warp % 4 the 16th of them;
  // slab row grp is column 2 grp, row grp + 8 the column after it
  const int wcol = (warp / 4) * 64 + (warp % 4) * 16 + 2 * grp;

  int32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  load_b_tile(s, bg, 0, col0, k, w, vec16);
  for (int t0 = 0; t0 < k; t0 += kTileT) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    {
      const int c = tid / 32, m = tid % 32;
      const uint32_t r0 = s.raw[4 * c][m], r1 = s.raw[4 * c + 1][m];
      const uint32_t r2 = s.raw[4 * c + 2][m], r3 = s.raw[4 * c + 3][m];
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
      *reinterpret_cast<uint4*>(&s.cols[c][4 * m]) =
          make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
    {  // the core matrices of (byte row rho, chunk c): bit rows 4h..4h+3, both K halves
      const int h = tid % 2, rho = (tid / 2) % kBlockRows, c = tid / (2 * kBlockRows);
      const int row = row0 + rho;
      uint32_t v = 0;
      if (row < r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + 4 * c + j;
          if (t < k) v |= static_cast<uint32_t>(ag[static_cast<int64_t>(row) * k + t]) << (8 * j);
        }
      }
      uint32_t vq[8];
      vq[0] = v;
#pragma unroll
      for (int q = 1; q < 8; ++q) vq[q] = xtime4(vq[q - 1]);
      unsigned char* core = s.bits[c] + rho * kCoreStride;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const int p = 4 * h + gg;
        *reinterpret_cast<uint4*>(core + 16 * p) =
            make_uint4((vq[0] >> p) & kBits, (vq[1] >> p) & kBits, (vq[2] >> p) & kBits,
                       (vq[3] >> p) & kBits);
        *reinterpret_cast<uint4*>(core + kCoreK + 16 * p) =
            make_uint4((vq[4] >> p) & kBits, (vq[5] >> p) & kBits, (vq[6] >> p) & kBits,
                       (vq[7] >> p) & kBits);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t0 + kTileT < k) load_b_tile(s, bg, t0 + kTileT, col0, k, w, vec16);

    const int chunks = min(kChunks, (k - t0 + 3) / 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // 4 k-steps at a time: 16 A registers in flight
      uint32_t af[kChunks / 2][4];
#pragma unroll
      for (int c = 0; c < kChunks / 2; ++c) {
        const uint2 cw = *reinterpret_cast<const uint2*>(&s.cols[half * kChunks / 2 + c][wcol]);
        af[c][0] = (cw.x >> u) & kBits;
        af[c][1] = (cw.y >> u) & kBits;
        af[c][2] = (cw.x >> (u + 4)) & kBits;
        af[c][3] = (cw.y >> (u + 4)) & kBits;
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < kChunks / 2; ++c)
        if (half * kChunks / 2 + c < chunks)
          wgmma_s8(d, af[c], make_desc(s.bits[half * kChunks / 2 + c]));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < kChunks / 2; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(af[c][j])::"memory");
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
  }

  // epilogue: d[4 nt + j] is bit row 2u + (j & 1) of byte row nt, column
  // wcol + (j >> 1); the 8 bit rows of a byte are ORed across the 4 lanes u
  uint8_t* og = out + static_cast<int64_t>(g) * r * w;
  const int col = col0 + wcol;
#pragma unroll
  for (int np = 0; np < kBlockRows / 2; ++np) {     // byte rows 2 np, 2 np + 1 in one word
    uint32_t word = 0;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (static_cast<uint32_t>(d[4 * (2 * np + x) + j]) & 1u)
                << (16 * x + 8 * (j >> 1) + 2 * u + (j & 1));
    word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
    word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
    const int row = row0 + 2 * np + (u & 1);
    if (u < 2 && row < r && col < w)
      *reinterpret_cast<uint16_t*>(og + static_cast<int64_t>(row) * w + col) =
          static_cast<uint16_t>(word >> (16 * u));
  }
}

}  // namespace
// Launches K7 on `stream`: g_count groups of an (r, k) by (k, w) product,
// 1 <= k <= 256, w a multiple of 4. A and B are contiguous within a group;
// `a_gstride` and `b_gstride` are the bytes between groups (0 broadcasts
// one matrix to every group); every group's B is 4-byte aligned; `out` is a
// contiguous (g_count, r, w) array. Returns the cudaError_t of the launch
// (0 when it was accepted).
extern "C" int gf256_matmul_launch(const void* a, long long a_gstride, const void* b,
                                   long long b_gstride, void* out, int g_count, int r, int k,
                                   int w, void* stream) {
  if (k < 1 || k > kMaxK || (w & 3)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = (w % 16 == 0) && (b_gstride % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const dim3 grid((w + kBlockCols - 1) / kBlockCols, g_count,
                  (r + kBlockRows - 1) / kBlockRows);
  gf256_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), a_gstride, static_cast<const uint8_t*>(b), b_gstride,
      static_cast<uint8_t*>(out), r, k, w, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf256_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
