// K11's fixed-base route: the G1 multi-scalar multiply of the KZG commit path
// over the trusted setup's powers, as a signed-window bucket sum over window
// tables: the tables' doublings once a setup, then six launches an MSM (the
// last three in csrc/g1_fill.cu, g1_totals.cu and g1_reduce.cu, built apart so
// that the sources compile in parallel; the group ops in csrc/g1_bucket.cuh).
//
// Replaces pos_evolution_tpu/ops/pairing.py::_g1_msm_kernel (:386), the JAX
// package's jitted MSM (a 255-step double-and-add ladder a lane, then a fold),
// where its points are the setup's powers [tau^j]G: the commit
// (kzg/scheme.py) and the prover (kzg/aggregate.py). The JAX package ran a
// ladder a lane because a bucket method would cost XLA minutes of compile; by
// hand the bucket method needs ~7x fewer group operations, and the fixed bases
// remove the per-window reductions and the doublings between windows.
//
// With window tables T[w, j] = 2^(c w) P_j (affine, built once with the setup
// by g1_tables_kernel and the affine pass), each scalar s_j = sum_w d_w 2^(c w)
// with signed digits d_w in [-2^(c-1), 2^(c-1)] (W = floor(256 / c) + 1
// windows, c W > 256: no carry leaves the top one for any 256-bit scalar, a
// lazy residue in [r, 2r) included), and
//   sum_j s_j P_j = sum_(w, j) d_wj T[w, j] = sum_(b = 1..B) b B_b,
// where bucket B_b sums sign(d) T[w, j] over the (w, j) with |d_wj| = b and
// B = 2^(c-1): one set of buckets a blob, not one a window. The launches:
//   recode   one thread a (blob, lane): W signed digits, and each window's
//            bucket counts (atomics on counts only);
//   scan     one block a blob: bucket starts, and each window's first position
//            in each bucket (the counts, overwritten);
//   scatter  one warp a (blob, window): a stable counting sort, lanes taken in
//            order 32 at a time, ranked inside the warp by __match_any_sync,
//            so each bucket holds its entries in (window, lane) order and runs
//            repeat bit for bit;
//   fill     (g1_fill.cu) a fixed share of kChunk (32) sorted entries a
//            thread, whatever the buckets' sizes: each run of one bucket
//            inside the chunk is summed
//            by mixed adds (Jacobian + affine, 11 products) from the zero point;
//            the chunk's first run goes to its part, a run that starts a bucket
//            inside the chunk to the bucket's bsum;
//   totals   (g1_totals.cu) one thread a bucket: its first run plus the
//            parts of the chunks that continue it, by unified adds (16 products); then, a block
//            of 64 buckets, the bottom six levels of the reduce's tree in
//            shared memory;
//   reduce   (g1_reduce.cu) one block a blob: sum_b b B_b = S + sum_k 2^k Q_k
//            (S the sum of every bucket, Q_k of those whose index b - 1 has
//            bit k set) by a binary tree over the buckets (a node of height h
//            holds S, Q_0 .. Q_(h-1); a parent adds its children's and takes
//            the upper child's S as Q_h: ~2B adds a blob, depth log2 B; its
//            bottom levels in totals), then 2^k Q_k in parallel and a halving
//            tree over S and them.
// The results equal pos_evolution_tpu_torch/ops/pairing.py's plain versions
// (_recode_plain, _sort_plain, _fill_plain, _totals_plain, _reduce_plain)
// digit for digit: the same base-field ops on the same operands in the same
// order, each exact (fp381.cuh), so the same lazy residues in [0, 2p). The
// doubling is ops/pairing.py::g1_double_jac op for op (as g1_msm.cu's
// programs), the unified add _g1_add_bucket_plain's (g1_msm.cu's but for the
// representation it doubles where P = Q), the mixed add _g1_madd_plain's.
// Every case is taken by a branch where the plain versions select: either
// operand at infinity, P = Q (a doubling) and P = -Q (the zero point, X = Y =
// Z = 0).
//
// Design for this card: registers. The working values of an add stay in
// registers (a Jacobian point is 36 words, an affine addend 24, the add's
// temporaries ~72): no shared-memory slots, no program loop; where doublings
// are a loop (the tables', the reduce's Horner) they are one called function
// (dbl_pt), and the launches' sources compile in parallel, which keeps nvcc's
// time down. Work is given
// out by sorted position, not by bucket, so a bucket of any size costs its
// entries / kChunk further adds in totals and the longest bucket does not set
// the fill's time. Scratch between launches (parts, bucket runs, tree nodes)
// is 32-bit words (144 bytes a point), outputs canonical digits.
//
// Bound on the commit path (9 blobs x 16,384 powers, c = 13: W = 20, B =
// 4,096): the products. ~2.95 M mixed adds (11 products, 3 of them squares),
// ~0.17 M unified adds (16, 4 squares) in totals and the tree, 12 doublings and
// 13 adds a blob in Horner; at 391 32x32-bit partial products a product and
// 325 a square, ~1.3e10 partial products: ~0.8 ms on the 64-lane multiplier of
// 132 SMs at 1.98 GHz (chip_smoke.py counts them from this run's entries),
// against ~0.8 GB of table reads (0.23 ms at 3.35 TB/s).

#include <cstdint>

#include <cuda_runtime.h>

#include "fr381.cuh"
#include "g1_bucket.cuh"

namespace {

using namespace g1b;

constexpr int kThreads = 128;              // tables, recode
constexpr int kScanThreads = 1024;

// --- the tables' doublings ---------------------------------------------------------

// Lane j: the Jacobian point jac[j] doubled c times a window, window w's
// point (2^(c (w + 1)) P_j) to out[w, j], digits.
__global__ void __launch_bounds__(kThreads)
g1_tables_kernel(const int32_t* __restrict__ jac, int32_t* __restrict__ out, int n, int windows,
                 int c) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  uint32_t P[kPt];
  load_digits(jac + static_cast<long long>(j) * kPtDigits, P, P + kW, P + 2 * kW);
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < c; ++i) dbl_pt(P);
    store_digits(out + (static_cast<long long>(w) * n + j) * kPtDigits, P, P + kW, P + 2 * kW);
  }
}

// --- recode, scan, scatter -----------------------------------------------------

// Lane (g, j): the canonical Fr digits of s_gj (22 12-bit digits) -> W signed
// digits dig[g, w, j], each nonzero one counted in cnt[g, w, |d| - 1].
__global__ void __launch_bounds__(kThreads)
g1_recode_kernel(const int32_t* __restrict__ scalars, int32_t* __restrict__ dig,
                 int* __restrict__ cnt, int g_rows, int k, int c) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(g_rows) * k) return;
  const int g = static_cast<int>(idx / k);
  const int j = static_cast<int>(idx - static_cast<long long>(g) * k);
  uint32_t s[fr381::kWords];
  fr381::load(scalars + idx * fr381::kDigits, s);
  const int windows = 256 / c + 1;
  const int nb = 1 << (c - 1);
  const uint32_t full = 1u << c;
  uint32_t carry = 0;
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
    const int bit = c * w, q = bit >> 5, off = bit & 31;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int t = 0; t < fr381::kWords; ++t) {      // s[q], s[q + 1] without local memory
      lo = t == q ? s[t] : lo;
      hi = t == q + 1 ? s[t] : hi;
    }
    const uint64_t two = static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
    const uint32_t v = (static_cast<uint32_t>(two >> off) & (full - 1u)) + carry;
    carry = v > static_cast<uint32_t>(nb) ? 1u : 0u;
    const int d = carry ? static_cast<int>(v) - static_cast<int>(full) : static_cast<int>(v);
    const long long gw = static_cast<long long>(g) * windows + w;
    dig[gw * k + j] = d;
    if (d != 0) atomicAdd(cnt + gw * nb + (d < 0 ? -d : d) - 1, 1);
  }
}

// One block a blob: start[g, i] = the first sorted position of bucket i
// (start[g, B] the blob's entries), and cnt[g, w, i] <- start[g, i] plus the
// counts of bucket i in windows before w (window w's first position there).
__global__ void __launch_bounds__(kScanThreads)
g1_scan_kernel(int* __restrict__ cnt, int* __restrict__ start, int windows, int nb) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int g = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* c = cnt + static_cast<long long>(g) * windows * nb;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int i0 = min(t * per, nb), i1 = min(i0 + per, nb);
  int local = 0;
  for (int i = i0; i < i1; ++i)
    for (int w = 0; w < windows; ++w) local += c[w * nb + i];
  int incl = local;                                // inclusive scan over the block
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      if (lane >= d) ws += v;
    }
    warp_sums[lane] = ws;
  }
  __syncthreads();
  int run = incl - local + (warp ? warp_sums[warp - 1] : 0);
  int* st = start + static_cast<long long>(g) * (nb + 1);
  for (int i = i0; i < i1; ++i) {
    st[i] = run;
    for (int w = 0; w < windows; ++w) {
      const int n_w = c[w * nb + i];
      c[w * nb + i] = run;
      run += n_w;
    }
  }
  if (t == kScanThreads - 1) st[nb] = warp_sums[31];
}

// One warp a (blob, window): lanes in order, 32 at a time, each nonzero digit
// to ent[g, pos] = (w n_tab + j) | sign << 31 at its bucket's cursor plus its
// rank among the warp's lanes of that bucket (a stable counting sort).
__global__ void __launch_bounds__(32)
g1_scatter_kernel(const int32_t* __restrict__ dig, const int* __restrict__ off,
                  int32_t* __restrict__ ent, int k, int n_tab, int windows, int nb) {
  extern __shared__ int cursor[];
  const int gw = blockIdx.x, lane = threadIdx.x;
  const int g = gw / windows, w = gw - g * windows;
  const int* o = off + static_cast<long long>(gw) * nb;
  for (int i = lane; i < nb; i += 32) cursor[i] = o[i];
  __syncwarp();
  const int32_t* d_row = dig + static_cast<long long>(gw) * k;
  int32_t* e = ent + static_cast<long long>(g) * windows * k;
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const int d = j < k ? d_row[j] : 0;
    const int b = d == 0 ? -1 : (d < 0 ? -d : d) - 1;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
    const int rank = __popc(peers & below);
    if (d != 0) {
      const unsigned key = static_cast<unsigned>(w) * static_cast<unsigned>(n_tab) + j;
      e[cursor[b] + rank] = static_cast<int32_t>(key | (d < 0 ? 0x80000000u : 0u));
    }
    __syncwarp();
    if (d != 0 && rank == 0) cursor[b] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

// The tables' doublings: jac [n, 3, 32] Jacobian digits (16-byte aligned) ->
// out [windows, n, 3, 32], window w the points doubled c (w + 1) times.
extern "C" int g1_bucket_tables_launch(const int32_t* jac, int32_t* out, int n, int windows,
                                       int c, void* stream) {
  unsigned blocks;
  if (n < 1 || windows < 1 || c < 2 || c > 16 || !blocks_ok(n, kThreads, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  g1_tables_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(jac, out, n,
                                                                             windows, c);
  return static_cast<int>(cudaGetLastError());
}

// scalars [g_rows, k, 22] canonical Fr digits (contiguous) -> dig [g_rows, W,
// k] signed digits; cnt [g_rows, W, 2^(c-1)] (zeroed by the caller) += counts.
extern "C" int g1_bucket_recode_launch(const int32_t* scalars, int32_t* dig, int* cnt,
                                       int g_rows, int k, int c, void* stream) {
  unsigned blocks;
  if (g_rows < 1 || k < 1 || c < 2 || c > 16
      || !blocks_ok(static_cast<long long>(g_rows) * k, kThreads, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  g1_recode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(scalars, dig,
                                                                              cnt, g_rows, k, c);
  return static_cast<int>(cudaGetLastError());
}

// cnt [g_rows, windows, nb] counts -> each window's first positions (in
// place); start [g_rows, nb + 1].
extern "C" int g1_bucket_scan_launch(int* cnt, int* start, int g_rows, int windows, int nb,
                                     void* stream) {
  if (g_rows < 1 || windows < 1 || !bucket_count_ok(nb))
    return static_cast<int>(cudaErrorInvalidValue);
  g1_scan_kernel<<<g_rows, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(cnt, start,
                                                                                windows, nb);
  return static_cast<int>(cudaGetLastError());
}

// dig [g_rows, W, k] and the window positions off [g_rows, W, 2^(c-1)] -> ent
// [g_rows, W k] sorted entries (w n_tab + j, bit 31 the sign).
extern "C" int g1_bucket_scatter_launch(const int32_t* dig, const int* off, int32_t* ent,
                                        int g_rows, int k, int n_tab, int c, void* stream) {
  const int windows = c >= 2 && c <= 16 ? 256 / c + 1 : 0;
  const int nb = 1 << (c >= 2 && c <= 16 ? c - 1 : 0);
  if (g_rows < 1 || k < 1 || n_tab < k || !windows
      || static_cast<long long>(windows) * n_tab > 0x7FFFFFFFLL
      || static_cast<long long>(g_rows) * windows > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(nb) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        g1_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  g1_scatter_kernel<<<static_cast<unsigned>(g_rows * windows), 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(dig, off, ent, k, n_tab, windows, nb);
  return static_cast<int>(cudaGetLastError());
}

#define G1_BUCKET_ERROR_STRING(name)                                 \
  extern "C" const char* name##_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }
G1_BUCKET_ERROR_STRING(g1_bucket_tables)
G1_BUCKET_ERROR_STRING(g1_bucket_recode)
G1_BUCKET_ERROR_STRING(g1_bucket_scan)
G1_BUCKET_ERROR_STRING(g1_bucket_scatter)
