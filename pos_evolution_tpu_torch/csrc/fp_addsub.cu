// K4: a tape of base-field adds, subtracts, negations and canonicalizations,
// run over every lane in one launch, each value a lazy residue in [0, 2p) as
// digits.
//
// Replaces pos_evolution_tpu/ops/fp.py::modadd (:210), modsub (:215), modneg
// (:222) and canon (:226), XLA-jitted functions of the JAX package, and the
// chains of them that its tower, pairing and G2 code call one after the
// other: the shift-adds of ops/tower.py::fq2_muli, the tail of a cyclotomic
// squaring, the add/sub chains of a Miller doubling step and of the Jacobian
// doubling and addition. The JAX package runs each op as its own XLA op; on
// the H100 each was its own launch, tens of thousands per verify.
//
// A tape (pos_evolution_tpu_torch/ops/fp.py::Tape) is a static program:
//   LOAD   slot dst <- input row a        (a pointer and an element stride)
//   ADD    dst <- a + b mod 2^384, less 2p if >= 2p
//   SUB    dst <- a - b mod 2^384, plus 2p on underflow
//   NEG    dst <- 0 - a, as SUB
//   CANON  dst <- a - p if a >= p
//   STORE  output row dst <- slot a
// each op exactly the plain version's (_modadd, _modsub, _modneg, _canon in
// ops/fp.py), so the result equals ops/fp.py::_run_tape digit for digit for
// canonical digits in. The tape travels in the kernel's parameter block
// (__grid_constant__, about 1.3 KB); a call uploads no tensor.
//
// Design for this card. One warp per block takes 32 consecutive lanes, one
// lane per thread. The tape's slots live in shared memory, 12 words a slot,
// laid out [slot][word quad][lane] so each 16-byte access of a warp is
// conflict-free (a register array indexed by a runtime slot number would go to
// local memory). A LOAD stages the warp's 32 rows through shared memory with
// coalesced 16-byte loads: consecutive threads take consecutive uint4s, so a
// warp instruction reads 512 contiguous bytes of a packed row, and rows padded
// to 36 words keep the per-lane 16-byte reads conflict-free. A STORE writes
// back the same way. An element stride of 0 broadcasts a constant.
//
// Bound: bytes. Each input row is read once and each output row written
// once, 128 bytes an element, against a few dozen integer instructions per op.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "fp381.cuh"

namespace {

constexpr int kMaxRows = 32, kMaxOutRows = 24, kMaxSlots = 8, kMaxSteps = 128;
enum : int { kLoad = 0, kAdd = 1, kSub = 2, kNeg = 3, kCanon = 4, kStore = 5 };
constexpr int kLanes = 32;        // one warp per block, one lane per thread
constexpr int kPitch = 9;         // uint4 per staged row: 8 and one of padding

struct TapeParams {
  const int32_t* in[kMaxRows];
  long long in_stride[kMaxRows];      // digits between consecutive lanes (0 broadcasts)
  int32_t* out[kMaxOutRows];
  long long out_stride[kMaxOutRows];
  uint8_t step[kMaxSteps][4];         // op, dst, a, b
  int n_steps;
  long long n;
};

struct Shared {
  uint4 stage[kLanes * kPitch];
  uint4 slot[kMaxSlots][3][kLanes];
};

__device__ __forceinline__ void get(const Shared& sh, int s, int lane, uint32_t* w) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = sh.slot[s][q][lane];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void put(Shared& sh, int s, int lane, const uint32_t* w) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    sh.slot[s][q][lane] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

__global__ void __launch_bounds__(kLanes)
fp_addsub_kernel(const __grid_constant__ TapeParams p) {
  __shared__ Shared sh;
  const int lane = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kLanes;
  const int count = static_cast<int>(p.n - first < kLanes ? p.n - first : kLanes);
  for (int s = 0; s < p.n_steps; ++s) {
    const int op = p.step[s][0], dst = p.step[s][1], a = p.step[s][2], b = p.step[s][3];
    if (op == kLoad) {
      const int32_t* src = p.in[a];
      const long long stride = p.in_stride[a];
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int q = it * kLanes + lane, e = q >> 3, part = q & 7;
        if (e < count)
          sh.stage[e * kPitch + part] =
              __ldg(reinterpret_cast<const uint4*>(src + (first + e) * stride) + part);
      }
      __syncwarp();
      if (lane < count) {
        uint32_t w[fp381::kWords];
        fp381::unstage(sh.stage + lane * kPitch, w);
        put(sh, dst, lane, w);
      }
      __syncwarp();
    } else if (op == kStore) {
      if (lane < count) {
        uint32_t w[fp381::kWords];
        get(sh, a, lane, w);
        fp381::stage(w, sh.stage + lane * kPitch);
      }
      __syncwarp();
      int32_t* out = p.out[dst];
      const long long stride = p.out_stride[dst];
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int q = it * kLanes + lane, e = q >> 3, part = q & 7;
        if (e < count)
          reinterpret_cast<uint4*>(out + (first + e) * stride)[part] = sh.stage[e * kPitch + part];
      }
      __syncwarp();
    } else if (lane < count) {
      uint32_t x[fp381::kWords], r[fp381::kWords];
      get(sh, a, lane, x);
      if (op == kAdd) {
        uint32_t y[fp381::kWords];
        get(sh, b, lane, y);
        fp381::add(x, y, r);
        fp381::cond_sub(r, fp381::kTwoP);
      } else if (op == kCanon) {
#pragma unroll
        for (int k = 0; k < fp381::kWords; ++k) r[k] = x[k];
        fp381::cond_sub(r, fp381::kP);
      } else {
        uint32_t lhs[fp381::kWords], rhs[fp381::kWords];
        if (op == kSub) {
          get(sh, b, lane, rhs);
#pragma unroll
          for (int k = 0; k < fp381::kWords; ++k) lhs[k] = x[k];
        } else {
#pragma unroll
          for (int k = 0; k < fp381::kWords; ++k) {
            lhs[k] = 0u;
            rhs[k] = x[k];
          }
        }
        // plus 2p on underflow, as a mask: lanes of a warp take either side
        const uint32_t mask = 0u - fp381::sub(lhs, rhs, r);
        uint32_t twop[fp381::kWords];
#pragma unroll
        for (int k = 0; k < fp381::kWords; ++k) twop[k] = fp381::kTwoP[k] & mask;
        fp381::add(r, twop, r);
      }
      put(sh, dst, lane, r);
    }
  }
}

}  // namespace

// Runs a tape on `stream` over n >= 1 lanes. tensors holds (pointer, element
// stride in digits) for each of the n_tensors operand and output tensors;
// prog holds the tape: n_in input rows and n_out output rows as (tensor,
// component) byte pairs, a component's row 32 digits past the one before,
// then n_steps (op, dst, a, b) quadruples. The caller has checked devices,
// types and shapes and made every pointer and stride 16-byte aligned.
// Returns cudaErrorInvalidValue for a malformed tape, else the cudaError_t
// of the launch.
extern "C" int fp_addsub_launch(const long long* tensors, int n_tensors, const uint8_t* prog,
                                int n_in, int n_out, int n_steps, long long n, void* stream) {
  if (n_in < 0 || n_in > kMaxRows || n_out < 1 || n_out > kMaxOutRows || n_steps < 1 ||
      n_steps > kMaxSteps || n < 1 || (n + kLanes - 1) / kLanes > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  TapeParams p;
  std::memset(&p, 0, sizeof(p));
  for (int r = 0; r < n_in + n_out; ++r) {
    const int t = prog[2 * r], c = prog[2 * r + 1];
    if (t >= n_tensors) return static_cast<int>(cudaErrorInvalidValue);
    int32_t* row = reinterpret_cast<int32_t*>(tensors[2 * t]) + 32 * c;
    if (r < n_in) {
      p.in[r] = row;
      p.in_stride[r] = tensors[2 * t + 1];
    } else {
      p.out[r - n_in] = row;
      p.out_stride[r - n_in] = tensors[2 * t + 1];
    }
  }
  const uint8_t* steps = prog + 2 * (n_in + n_out);
  for (int s = 0; s < n_steps; ++s) {
    const int op = steps[4 * s], dst = steps[4 * s + 1], a = steps[4 * s + 2],
              b = steps[4 * s + 3];
    const bool ok = op == kLoad    ? dst < kMaxSlots && a < n_in
                    : op == kStore ? dst < n_out && a < kMaxSlots
                    : op <= kCanon ? dst < kMaxSlots && a < kMaxSlots && b < kMaxSlots
                                   : false;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(p.step[s], steps + 4 * s, 4);
  }
  p.n_steps = n_steps;
  p.n = n;
  const unsigned blocks = static_cast<unsigned>((n + kLanes - 1) / kLanes);
  fp_addsub_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fp_addsub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
