// K11: the G1 multi-scalar multiply of the KZG commit path, as per-lane
// double-and-add ladders and a tree fold of unified Jacobian adds.
//
// Replaces pos_evolution_tpu/ops/pairing.py::_g1_msm_kernel (:386), the
// JAX package's jitted MSM: every (blob, power) lane runs a 255-step
// MSB-first ladder (acc = 2 acc, then acc + P_j where bit i of s_j is set;
// lanes :409-415), then the lanes fold into one point (:417-420, there a
// sequential scan kept for XLA's compile time; here a tree, which the
// group law makes give the same affine sum). The results equal
// pos_evolution_tpu_torch/ops/pairing.py::_msm_lanes_plain and
// ::_fold_plain digit for digit: the same base-field operations on the same
// operands as the port's G1 tapes (_G1_DOUBLE and _G1_ADD, ops/pairing.py),
// each exact (fp381.cuh), so the same lazy residues in [0, 2p).
//
// g1_msm_kernel (mode LADDER): lane j of blob g takes the affine point
// points[g, j] (infinity lanes Z = 0) and the canonical Fr digits of s_j,
// which K10's canonical pass leaves on the card (no host bit matrix). The
// ladder starts at s_j's top bit with acc = P_j: before it acc is the zero
// point, which doubles to itself, and the zero point plus P_j is P_j
// exactly, so the skipped steps are the plain version's own values. A lane
// adds P_j only where its bit is set (the plain version computes the sum
// and selects; the same values). With fold set, each block of kT lanes
// then reduces in shared memory by a halving tree (lane t += lane t + k, k
// = kT/2 ... 1), lanes past n being the zero point, the identity of the
// unified add exactly; block b's sum goes to partial b. Mode FOLD runs the
// same tree over Jacobian inputs, so launches of it reduce a blob's
// partials kT to one until one is left.
//
// The unified add handles either operand at infinity (Z = 0), P = Q (it
// doubles) and P = -Q (the zero point), every case of ops/pairing.py::_add,
// taken by a branch rather than computed and selected.
//
// Design for this card: registers. A Jacobian accumulator is 36 words and a
// point 24, and the add's temporaries come on top; held in registers that
// is far past 255. So every value lives in shared memory, in 13 slots of
// 12 words per lane laid out [slot][word][lane] (a warp's access to one
// word of a slot is conflict-free), and the double and the add are short
// static programs of (op, dst, a, b) steps in constant memory run by one
// loop: MUL loads two slots, runs fp381::modmul in registers and stores
// the product; ADD, SUB, COPY and ZERO likewise. One copy of each op's code
// serves every step, so the kernel stays small (the ladder inlined would be
// ~40 products of ~1,600 instructions each) and the register count is the
// product's. A block is kT = 64 lanes (39,936 bytes of shared memory).
//
// Bound on the commit path (9 blobs x 16,384 powers, 255-bit scalars): the
// products. Per lane ~254 doublings of 7 products (5 of them squares) and
// ~127 adds of 16 (4 squares), ~3,810 products; at 391 32x32-bit partial
// products a product and 325 a square (the least a squaring needs), 2.0e11
// partial products for a commit: ~12 ms on the 64-lane multiplier of 132 SMs
// at 1.98 GHz (1.673e13/s), against ~20 MB of bytes. The ladder is a chain of
// dependent products per lane and ~10 warps fit an SM, so latency, not the
// multiplier, is expected to bind first.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kT = 64;                       // lanes (threads) per block
constexpr int kSlots = 13;
constexpr int kW = fp381::kWords;            // 12 words a base-field element
constexpr int kSlotStride = kW * kT;         // words between two slots of a lane
constexpr int kBits = 255;                   // r < 2^255
enum : int { kMul = 0, kAdd = 1, kSub = 2, kCopy = 3, kZero = 4 };
enum : int { kLadder = 0, kFold = 1 };

// Slots: the accumulator P (X1 Y1 Z1), the addend Q (X2 Y2 Z2), temporaries.
enum : int { X1 = 0, Y1 = 1, Z1 = 2, X2 = 3, Y2 = 4, Z2 = 5, T0 = 6, T1, T2, T3, T4, T5, T6 };

struct Step {
  uint8_t op, d, a, b;
};

// Every program, one table (offsets below). The a = 0 Jacobian doubling of P
// in place: the G1 doubling tapes of ops/pairing.py (_double_tapes("g1_double",
// ...)) op for op.
__constant__ Step kProg[] = {
    {kMul, T0, X1, X1},   // A = X^2
    {kMul, T1, Y1, Y1},   // B = Y^2
    {kAdd, T2, X1, T1},   // X + B
    {kMul, T3, T1, T1},   // C = B^2
    {kMul, T2, T2, T2},   // (X + B)^2
    {kAdd, T1, T0, T0},   // E = (A + A) + A
    {kAdd, T1, T1, T0},
    {kMul, T4, T1, T1},   // E^2
    {kMul, T5, Y1, Z1},   // YZ
    {kSub, T0, T2, T0},   // D = 2 (((X + B)^2 - A) - C)
    {kSub, T0, T0, T3},
    {kAdd, T0, T0, T0},
    {kAdd, T2, T0, T0},   // X3 = E^2 - 2D
    {kSub, T2, T4, T2},
    {kSub, T0, T0, T2},   // D - X3
    {kMul, T0, T1, T0},   // E (D - X3)
    {kAdd, T3, T3, T3},   // 8C
    {kAdd, T3, T3, T3},
    {kAdd, T3, T3, T3},
    {kSub, Y1, T0, T3},   // Y3 = E (D - X3) - 8C
    {kAdd, Z1, T5, T5},   // Z3 = 2 YZ
    {kCopy, X1, T2, 0},
    // The unified add P + Q up to the case analysis: the products before the
    // "hr" tape and that tape's H = U2 - U1 (T3) and r = S2 - S1 (T5).
    {kMul, T0, Z1, Z1},   // Z1Z1
    {kMul, T1, Z2, Z2},   // Z2Z2
    {kMul, T2, X1, T1},   // U1 = X1 Z2Z2
    {kMul, T3, X2, T0},   // U2 = X2 Z1Z1
    {kMul, T1, Z2, T1},   // Z2 Z2Z2
    {kMul, T4, Y1, T1},   // S1
    {kMul, T0, Z1, T0},   // Z1 Z1Z1
    {kMul, T5, Y2, T0},   // S2
    {kSub, T3, T3, T2},   // H
    {kSub, T5, T5, T4},   // r
    // The general case: X3 = r^2 - H^3 - 2V, Y3 = r (V - X3) - S1 H^3,
    // Z3 = H (Z1 Z2), V = U1 H^2 (the "x3" and "gen" tapes).
    {kMul, T0, T3, T3},   // H2
    {kMul, T1, T3, T0},   // H3
    {kMul, T2, T2, T0},   // V = U1 H2
    {kMul, T0, T5, T5},   // rr
    {kSub, T0, T0, T1},   // rr - H3
    {kAdd, T6, T2, T2},   // 2V
    {kSub, T0, T0, T6},   // X3
    {kSub, T6, T2, T0},   // V - X3
    {kMul, T6, T5, T6},   // r (V - X3)
    {kMul, T1, T4, T1},   // S1 H3
    {kSub, T1, T6, T1},   // Y3
    {kMul, T6, Z1, Z2},   // Z1 Z2
    {kMul, Z1, T3, T6},   // Z3
    {kCopy, X1, T0, 0},
    {kCopy, Y1, T1, 0},
    // P = Q; P = the zero point
    {kCopy, X1, X2, 0}, {kCopy, Y1, Y2, 0}, {kCopy, Z1, Z2, 0},
    {kZero, X1, 0, 0}, {kZero, Y1, 0, 0}, {kZero, Z1, 0, 0},
};

// (offset, steps) of each program in kProg
constexpr int kDouble = 0, kDoubleN = 22;
constexpr int kAddPre = kDouble + kDoubleN, kAddPreN = 10;
constexpr int kAddGen = kAddPre + kAddPreN, kAddGenN = 15;
constexpr int kTakeQ = kAddGen + kAddGenN, kTakeQN = 3;
constexpr int kZeroP = kTakeQ + kTakeQN, kZeroPN = 3;
static_assert(sizeof(kProg) / sizeof(Step) == kZeroP + kZeroPN, "program table");

__device__ __forceinline__ void ld(const uint32_t* s, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < kW; ++k) w[k] = s[k * kT];
}

__device__ __forceinline__ void st(uint32_t* s, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < kW; ++k) s[k * kT] = w[k];
}

// Run the program at kProg[off, off + n_steps) over one lane's slots (lane:
// its word 0 of slot 0).
__device__ void run(int off, int n_steps, uint32_t* lane) {
#pragma unroll 1
  for (int i = off; i < off + n_steps; ++i) {
    const Step s = kProg[i];
    uint32_t* d = lane + s.d * kSlotStride;
    const uint32_t* a = lane + s.a * kSlotStride;
    const uint32_t* b = lane + s.b * kSlotStride;
    uint32_t x[kW], y[kW], r[kW];
    if (s.op == kZero) {
#pragma unroll
      for (int k = 0; k < kW; ++k) r[k] = 0u;
    } else {
      ld(a, x);
      if (s.op == kCopy) {
#pragma unroll
        for (int k = 0; k < kW; ++k) r[k] = x[k];
      } else {
        ld(b, y);
        if (s.op == kMul) {
          fp381::modmul(x, y, r);
        } else if (s.op == kAdd) {                     // K4's ADD
          fp381::add(x, y, r);
          fp381::cond_sub(r, fp381::kTwoP);
        } else {                                       // K4's SUB
          const uint32_t mask = 0u - fp381::sub(x, y, r);
          uint32_t twop[kW];
#pragma unroll
          for (int k = 0; k < kW; ++k) twop[k] = fp381::kTwoP[k] & mask;
          fp381::add(r, twop, r);
        }
      }
    }
    st(d, r);
  }
}

// The value of a slot is 0 mod p (its canonical form, K4's CANON, is zero).
__device__ __forceinline__ bool is_zero_mod_p(const uint32_t* s) {
  uint32_t x[kW];
  ld(s, x);
  fp381::cond_sub(x, fp381::kP);
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < kW; ++k) any |= x[k];
  return any == 0;
}

// P += Q (unified), every case of ops/pairing.py::_add.
__device__ void g1_add(uint32_t* lane) {
  run(kAddPre, kAddPreN, lane);
  const bool p_inf = is_zero_mod_p(lane + Z1 * kSlotStride);
  const bool q_inf = is_zero_mod_p(lane + Z2 * kSlotStride);
  if (p_inf) {
    run(kTakeQ, kTakeQN, lane);
  } else if (q_inf) {
    // P + infinity = P
  } else if (is_zero_mod_p(lane + T3 * kSlotStride)) {          // same x
    if (is_zero_mod_p(lane + T5 * kSlotStride)) run(kDouble, kDoubleN, lane);   // P = Q
    else run(kZeroP, kZeroPN, lane);                                          // P = -Q
  } else {
    run(kAddGen, kAddGenN, lane);
  }
}

// 32 canonical digits of one base-field element from device memory to a slot.
__device__ __forceinline__ void load_slot(const int32_t* src, uint32_t* slot) {
  uint32_t w[kW];
  fp381::load(src, w);
  st(slot, w);
}

__device__ __forceinline__ void store_slot(const uint32_t* slot, int32_t* dst) {
  uint32_t w[kW];
  ld(slot, w);
  fp381::store(w, dst);
}

struct MsmParams {
  const int32_t* points;        // affine [.., 2, 32] digits
  long long p_lane, p_blob;     // element strides of points, in digits (0 broadcasts)
  const uint8_t* inf;           // infinity flag per point
  long long i_lane, i_blob;
  const int32_t* scalars;       // canonical Fr digits [.., 22]
  long long s_lane, s_blob;
  const int32_t* in;            // FOLD: Jacobian [g, n, 3, 32], contiguous
  int32_t* out;                 // [g, n or ceil(n / kT), 3, 32], contiguous
  int n, blocks_per_blob, mode, fold;
};

__global__ void __launch_bounds__(kT) g1_msm_kernel(const __grid_constant__ MsmParams p) {
  __shared__ uint32_t sm[kSlots * kSlotStride];
  const int t = threadIdx.x;
  const int g = blockIdx.x / p.blocks_per_blob;
  const int blk = blockIdx.x - g * p.blocks_per_blob;
  const int j = blk * kT + t;
  uint32_t* lane = sm + t;
  if (j >= p.n) {
    run(kZeroP, kZeroPN, lane);
  } else if (p.mode == kFold) {
    const int32_t* src = p.in + (static_cast<long long>(g) * p.n + j) * 3 * 32;
    load_slot(src, lane + X1 * kSlotStride);
    load_slot(src + 32, lane + Y1 * kSlotStride);
    load_slot(src + 64, lane + Z1 * kSlotStride);
  } else {
    const int32_t* pt = p.points + g * p.p_blob + j * p.p_lane;
    load_slot(pt, lane + X2 * kSlotStride);
    load_slot(pt + 32, lane + Y2 * kSlotStride);
    uint32_t z[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) z[k] = 0u;
    z[0] = p.inf[g * p.i_blob + j * p.i_lane] ? 0u : 1u;
    st(lane + Z2 * kSlotStride, z);
    // the scalar's 22 digits -> 8 words (s < r < 2^255)
    const int32_t* sd = p.scalars + g * p.s_blob + j * p.s_lane;
    uint32_t d[fp381::kDigits], s[kW];
#pragma unroll
    for (int k = 0; k < fp381::kDigits; ++k) d[k] = k < 22 ? static_cast<uint32_t>(sd[k]) : 0u;
    fp381::digits_to_words(d, s);
    int top = -1;
#pragma unroll 1
    for (int bit = kBits - 1; bit >= 0; --bit) {
      if ((s[bit >> 5] >> (bit & 31)) & 1u) {
        top = bit;
        break;
      }
    }
    if (top < 0) {
      run(kZeroP, kZeroPN, lane);
    } else {
      run(kTakeQ, kTakeQN, lane);                           // 0 + P_j at the top bit
#pragma unroll 1
      for (int bit = top - 1; bit >= 0; --bit) {
        run(kDouble, kDoubleN, lane);
        if ((s[bit >> 5] >> (bit & 31)) & 1u) g1_add(lane);
      }
    }
  }
  if (!p.fold) {
    int32_t* dst = p.out + (static_cast<long long>(g) * p.n + j) * 3 * 32;
    if (j < p.n) {
      store_slot(lane + X1 * kSlotStride, dst);
      store_slot(lane + Y1 * kSlotStride, dst + 32);
      store_slot(lane + Z1 * kSlotStride, dst + 64);
    }
    return;
  }
#pragma unroll 1
  for (int k = kT / 2; k >= 1; k >>= 1) {
    __syncthreads();
    if (t < k) {
      const uint32_t* other = sm + t + k;              // lane t + k's accumulator
      uint32_t w[kW];
#pragma unroll 1
      for (int c = 0; c < 3; ++c) {
        ld(other + (X1 + c) * kSlotStride, w);
        st(lane + (X2 + c) * kSlotStride, w);
      }
      g1_add(lane);
    }
  }
  if (t == 0) {
    int32_t* dst = p.out + (static_cast<long long>(g) * p.blocks_per_blob + blk) * 3 * 32;
    store_slot(lane + X1 * kSlotStride, dst);
    store_slot(lane + Y1 * kSlotStride, dst + 32);
    store_slot(lane + Z1 * kSlotStride, dst + 64);
  }
}

int launch(const MsmParams& p, int g_rows, void* stream) {
  const long long blocks = static_cast<long long>(g_rows) * p.blocks_per_blob;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  g1_msm_kernel<<<static_cast<unsigned>(blocks), kT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ladders of g_rows x n lanes: lane (g, j) multiplies the affine point at
// points + g p_blob + j p_lane (x then y, 32 digits each, 16-byte aligned;
// infinity where inf[g i_blob + j i_lane] is nonzero) by the canonical Fr
// digits at scalars + g s_blob + j s_lane. With fold = 0, out receives every
// lane's Jacobian point [g_rows, n, 3, 32]; with fold = 1, each block's tree
// sum [g_rows, ceil(n / 64), 3, 32]. Returns cudaErrorInvalidValue for a bad
// size, else the launch's cudaError_t.
extern "C" int g1_msm_launch(const int32_t* points, long long p_lane, long long p_blob,
                             const uint8_t* inf, long long i_lane, long long i_blob,
                             const int32_t* scalars, long long s_lane, long long s_blob,
                             int32_t* out, int g_rows, int n, int fold, void* stream) {
  if (g_rows < 1 || n < 1 || p_lane % 4 || p_blob % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  MsmParams p{points, p_lane, p_blob, inf, i_lane, i_blob, scalars, s_lane, s_blob,
              nullptr, out, n, (n + kT - 1) / kT, kLadder, fold ? 1 : 0};
  return launch(p, g_rows, stream);
}

// One fold round: in [g_rows, n, 3, 32] Jacobian points (contiguous) -> out
// [g_rows, ceil(n / 64), 3, 32], each block of 64 reduced by the tree.
extern "C" int g1_fold_launch(const int32_t* in, int32_t* out, int g_rows, int n,
                              void* stream) {
  if (g_rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  MsmParams p{nullptr, 0, 0, nullptr, 0, 0, nullptr, 0, 0,
              in, out, n, (n + kT - 1) / kT, kFold, 1};
  return launch(p, g_rows, stream);
}

extern "C" const char* g1_msm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* g1_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
