// Fused GP scoring and acquisition kernels, for Hopper (sm_90a).
//
// Four launchers.  They replace the eight Pallas TPU kernels of the
// surrogate and acquisition path:
//   A  ut_gp_mean        uptune_tpu/surrogate/pallas_score.py:66
//                        _score_kernel, :77 _score_kernel_mixed, :89
//                        _score_kernel_expham              -> mu_n [B]
//   B  ut_gp_mean_var    pallas_score.py:107 _var_kernel, :112
//                        _var_kernel_mixed, :119 _var_kernel_expham
//                                                          -> mu_n, q [B]
//   C  ut_acquire_scores uptune_tpu/ops/acquire.py:151 _scores_kernel
//                                             -> EI / -LCB / -mean [B]
//   D  ut_acquire_topk   acquire.py:157 _topk_kernel -> top-k candidates
// The TPU's `_expham`/`_mixed` variants exist only because a zero-width
// block does not lower through Mosaic; here the compile-time flags kCont
// and kCat cover them.
//
// The function (the JAX `_utility_tile`): for query row r and training
// row n,
//   k[r, n] = matern52(|qc_r - xc_n|^2) * exp(-|qk_r - xk_n|^2)
// (the continuous block pre-scaled by 1/ls, the one-hot block by
// sqrt(1/(n_cat ls_cat)), alpha and K^-1 premasked by the caller), then
//   mu_n[r] = sum_n k[r, n] alpha[n]
//   q[r]    = sum_n k[r, n] (sum_m k[r, m] Kinv[m, n])
// and one epilogue.
//
// A: one kernel, gp_mean_kernel, with the distances through |q|^2 + |x|^2
// - 2 q.x and the cross term q.x on the tensor cores, in 3xTF32 as wq
// below.  Both blocks are centred on training row 0 first: distances do
// not change, and the |q|^2 + |x|^2 that the subtraction cancels near the
// training rows shrinks.  Each block of features is padded to a multiple
// of 8 deep and packed (24 + 8 = one 32-deep chunk at the flagship's 23 +
// 8), and the continuous and categorical cross terms go into two
// accumulators.  A block is one warpgroup and 64 query rows, centred,
// split into TF32 hi and lo and swizzled into shared memory once: the
// wgmma's B operand.  The kSplit blocks of a cluster take every kSplit-th
// 64-row tile of the training rows, which stream through shared memory by
// 32-deep chunks with cp.async, two chunks ahead; each thread loads its A
// fragments of a chunk from there, centres them, adds their squares to
// the rows' norms and splits them in registers, so a training tile is
// never written back.  wgmma m64n64k8 forms the cross terms, the epilogue
// forms k in registers (sqrtf and expf, at f32's accuracy) and adds k
// alpha to each query row's partial in float64, and the partials of a
// query row are summed over the warps and the cluster in one fixed order
// through (distributed) shared memory, then rounded to f32 once.  The
// products and sums are float64 because alpha cancels: where training
// rows repeat (the all-categorical case), sum |k alpha| is thousands of
// times |mu|, and f32 rounding of k alpha alone moves mu by several times
// its tolerance; in float64 mu stays as close as k's own f32 rounding.  One launch, nothing of size N in
// shared memory, no scratch, no atomics.  Past 376 features the query
// planes of every chunk do not fit a block; then (kStream) the planes hold
// one chunk, split and swizzled again for each unit from the query rows in
// L2, so any F is taken.  Bound (B = 6040, N = 1024, F =
// 31): the cross term, 3 x 2BNF = 1.2 GFLOP of TF32 at 495 TFLOP/s, plus
// the mean at the f32 rate: about 2.5 us (2BNF at the f32 rate, 67
// TFLOP/s: about 6 us).  The per-pair epilogue (a sqrtf and an expf,
// each a special-function operation and a few FP instructions around it,
// and about 15 FP instructions more) sets a floor of about 3.5 us on top
// of that.
//
// B, C and D: the same function in passes through a scratch buffer the
// wrapper allocates (the kernels allocate nothing).
//   1. kinv_prep: K^-1 [N, N] -> its transpose, zero-padded to [Np, Np]
//      (Np = N rounded up to kTileN) and split into TF32 hi and lo planes:
//      wgmma takes TF32 operands K-major only, and K^-1 from cho_solve is
//      symmetric only to rounding, so it is transposed, not read as K^-T.
//   2. krows: the kernel rows k [Bp, Np] (zero outside B x N) and the
//      mean's partial sums, one per kTileN-column tile, each reduced in
//      one fixed order (a warp shuffle tree, then the warps in turn).  Up
//      to 361 features (all of them in one block's shared memory) the
//      distances are summed as (a - b)^2 directly on the CUDA cores, over
//      the features in order.  Past that, where the CUDA cores' 2BNF FMAs
//      dominate every pass after them, krows_mma takes them as A does:
//      |q|^2 + |x|^2 - 2 q.x, both blocks centred on training row 0, the
//      cross term on wgmma in 3xTF32 into a continuous and a categorical
//      accumulator, 32 features at a time, so any F is taken.  The route
//      is a function of F alone (gp_plan.h, ut_krows_route).
//   3. wq: W = k K^-1 on the tensor cores in 3xTF32, wgmma m64n128k8:
//      k (in registers) and K^-T (in shared memory) each stand as a TF32
//      high part plus a TF32 residual, and every 8-deep step adds lo*hi
//      and hi*lo before hi*hi; each 32-deep stage's products go into a
//      fresh f32 accumulator that is then added to the total, since the
//      tensor cores' sums truncate.  Single TF32 misses the sd tolerance
//      near the training rows; this scheme lands nearer the float64
//      result than the f32 plain version.  A block holds a kTileM x
//      kTileN tile of W; k and K^-T tiles stream through shared memory
//      with cp.async, kStages deep, 128-byte swizzled; mbarriers, not
//      block barriers, pace the stages, so the two warpgroups drift
//      apart and the tensor cores take one's products while the other
//      adds.  The epilogue folds W * k over the block's columns into one
//      partial q per row ([Np / kTileN, Bp]); W never leaves registers.
//   4. B, moments: each row's partials summed in tile order into mu_n and
//      q.  C and D, final: the same sums, then the utility (EI / -LCB /
//      -mean), so B's moments are C's bit for bit.  For D the same pass
//      sorts each kSel-row chunk by (value desc, index asc) in shared
//      memory and keeps its best min(k, kSel); then topk_merge ranks every
//      kept entry within its group of lists (binary searches in the other
//      lists) and writes the group's best min(k, ...) in order.  At B =
//      6040, k = 128 that is one group: D's output is the top k, and the
//      wrapper sorts nothing.  Over an instance axis D ranks segs lists of
//      b rows in one launch: kinv_prep runs once, krows and wq over the
//      segs * b rows as one batch, and final and topk_merge take the
//      segment as their grid's second dimension, so each segment's top k
//      is the one a launch of that segment alone gives.
// Every row's k, partial sums and utility follow one order whatever its
// place in a tile, with no atomics, so duplicated query rows tie bitwise.
// Bound of B, C and D (B = 6040, N = 1024, F = 31): 3 x 2BN^2 = 38 GFLOP
// of TF32 at 495 TFLOP/s dense, plus the distances, mean and q at the f32
// rate: about 0.083 ms (2BN^2 = 12.7 GFLOP at the f32 rate would take
// 0.195 ms).  K^-1 is read from L2 once per kTileM query rows (48 times at
// B = 6040), and nothing of size N sits in shared memory, so N is not
// limited.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>

// the tile sizes, the scratch plan, the krows route by width and the
// host-only queries
#include "gp_plan.h"

namespace {

constexpr int kMaxDevices = 64;

// B, C and D
constexpr int kStages = 4;
constexpr int kLdA = kTileK + 4;   // k rows' shared stride: conflict-free
                                   // A fragment loads
// one stage: the k tile, then the K^-T hi and lo tiles
constexpr int kStageWords = kTileM * kLdA + 2 * kTileN * kTileK;
// the stages, then a "full" and an "empty" mbarrier per stage
constexpr int kWqShared = kStages * kStageWords * 4 + 2 * kStages * 8;
constexpr int kMergeShared = kMergeSlots * 8;

// A
constexpr int kMeanCols = 64;      // training rows of a tile: wgmma's M
constexpr int kGroup = 128;        // threads of a block: one warpgroup
constexpr int kSplit = 4;          // blocks of a cluster, splitting N
constexpr int kLdX = kTileK + 4;   // a staged training chunk's row stride:
                                   // conflict-free A fragment loads
constexpr int kRawWords = kMeanCols * kLdX + kMeanCols;  // + the alpha
constexpr int kRawStages = 3;      // two copies ahead of the one in use

enum Kind { kKindMean = 0, kKindEI = 1, kKindLCB = 2 };

__device__ __forceinline__ float matern52(float d2) {
  const float d = sqrtf(d2 + 1e-12f);
  const float s5d = 2.2360679774997896f * d;
  return (1.0f + s5d + (5.0f / 3.0f) * d2) * expf(-s5d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// -- B, C and D ------------------------------------------------------------------

// The utility of one row from its moments; params: noise, y_mean, y_std,
// best_y, beta (the JAX (1, 8) scalar pack)
__device__ __forceinline__ float utility(float mu_n, float q,
                                         const float* __restrict__ params,
                                         int kind) {
  const float noise = params[0], y_mean = params[1], y_std = params[2];
  const float best_y = params[3], beta = params[4];
  const float mu = mu_n * y_std + y_mean;
  if (kind == kKindMean) return -mu;
  const float sd = sqrtf(fmaxf(1.0f + noise - q, 1e-9f)) * y_std;
  if (kind == kKindEI) {
    const float s = fmaxf(sd, 1e-9f);
    const float z = (best_y - mu) / s;
    const float pdf = expf(-0.5f * z * z) / 2.5066282746310002f;
    const float cdf = 0.5f * (1.0f + erff(z / 1.4142135623730951f));
    return (best_y - mu) * cdf + s * pdf;
  }
  return -(mu - beta * sd);
}

// x rounded to TF32 (10 fraction bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// operations where the conversion unit runs at a fraction of the rate
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; hi carries x's first 11 significant bits, lo
// the next 11
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// K^-1 [n, n] -> the zero-padded transpose [np, np] split in two TF32
// planes: hi[c][r] + lo[c][r] = K^-1[r][c] to 22 significant bits.  A
// 32 x 32 tile goes through shared memory, so reads and writes coalesce.
__global__ void __launch_bounds__(kThreads) kinv_prep_kernel(
    const float* __restrict__ kinv, int n, int np, float* __restrict__ hi,
    float* __restrict__ lo) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int y = ty; y < 32; y += kThreads / 32) {
    const int r = r0 + y, c = c0 + tx;
    t[y][tx] = (r < n && c < n) ? kinv[static_cast<size_t>(r) * n + c] : 0.f;
  }
  __syncthreads();
  for (int y = ty; y < 32; y += kThreads / 32) {
    uint32_t h, l;
    split_tf32(t[tx][y], h, l);
    const size_t o = static_cast<size_t>(c0 + y) * np + r0 + tx;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

// 4 bytes, or a zero when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// rows x w floats of a row-major block of row stride ld (ld = w: read in
// flat order, coalesced), four loads in flight a thread, into dst[r * rs +
// j * cs]; rows from `have` on as zeros.  The row of flat index i is (i +
// 1/2) / w rounded down in float, exact for the blocks here (i < 2^20).
__device__ __forceinline__ void stage_rows(float* dst, int rs, int cs,
                                           const float* __restrict__ src,
                                           int w, int ld, int have,
                                           int rows) {
  const float inv = 1.0f / static_cast<float>(w);
  const int total = rows * w, avail = have * w;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = __float2int_rz((static_cast<float>(i) + 0.5f) * inv);
    const int j = i - r * w;
    dst[r * rs + j * cs] = i < avail ? src[r * ld + j] : 0.f;
  }
}

// Block (tile t, row block y): kKRows query rows against the kTileN
// training rows of tile t, on the CUDA cores, all f features (up to 361,
// krows_on_tensor_cores) in shared memory at once.  Thread tid takes
// column tid % kTileN and the kPer rows (tid / kTileN) kPer + i; the query
// rows sit transposed in shared memory, so one float4 broadcast brings
// four rows' feature j.  Each distance is summed in feature order, the
// continuous block, then the categorical one.
// Writes k (kStoreK) and the tile's partial mean of each row,
// mupart[t * bp + row].  The mixed kernel takes one exp:
// matern52(dc) exp(-dk) = (1 + s5d + 5/3 dc) exp(-(s5d + dk)).
template <bool kCont, bool kCat, bool kStoreK>
__global__ void __launch_bounds__(kThreads) krows_kernel(
    const float* __restrict__ qc, const float* __restrict__ qk,
    const float* __restrict__ xc, const float* __restrict__ xk,
    const float* __restrict__ alpha, int b, int n, int fc, int fk, int np,
    int bp, float* __restrict__ kscr, float* __restrict__ mupart) {
  constexpr int kPer = kKRows * kTileN / kThreads;  // rows per thread: 16
  constexpr int kHalves = kThreads / kTileN;
  extern __shared__ __align__(16) float smem[];
  const int f = fc + fk, fs = f | 1;        // odd stride: no bank conflicts
  float* s_q = smem;                        // [f][kKRows]
  float* s_x = s_q + f * kKRows;            // [kTileN][fs]
  float* s_red = s_x + kTileN * fs;         // [kWarps][kPer]
  const int col0 = blockIdx.x * kTileN, row0 = blockIdx.y * kKRows;
  const int xrows = max(0, min(kTileN, n - col0));
  const int qrows = max(0, min(kKRows, b - row0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x % kTileN, half = threadIdx.x / kTileN;
  const int col = col0 + c;
  float dc[kPer], dk[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dc[i] = dk[i] = 0.f;
  if (kCont) {
    stage_rows(s_x, fs, 1, xc + static_cast<size_t>(col0) * fc, fc, fc, xrows,
               kTileN);
    stage_rows(s_q, 1, kKRows, qc + static_cast<size_t>(row0) * fc, fc, fc,
               qrows, kKRows);
  }
  if (kCat) {
    const int wc = kCont ? fc : 0;
    stage_rows(s_x + wc, fs, 1, xk + static_cast<size_t>(col0) * fk, fk, fk,
               xrows, kTileN);
    stage_rows(s_q + wc * kKRows, 1, kKRows,
               qk + static_cast<size_t>(row0) * fk, fk, fk, qrows, kKRows);
  }
  __syncthreads();
  for (int j = 0; j < f; ++j) {
    const float xv = s_x[c * fs + j];
    const float4* qj = reinterpret_cast<const float4*>(s_q + j * kKRows +
                                                       half * kPer);
    float qv[kPer];
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const float4 v = qj[i];
      qv[4 * i] = v.x;
      qv[4 * i + 1] = v.y;
      qv[4 * i + 2] = v.z;
      qv[4 * i + 3] = v.w;
    }
    if (kCont && (!kCat || j < fc)) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float d = qv[i] - xv;
        dc[i] = fmaf(d, d, dc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float d = qv[i] - xv;
        dk[i] = fmaf(d, d, dk[i]);
      }
    }
  }
  const float a = col < n ? alpha[col] : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + half * kPer + i;
    float k = 0.f;
    if (col < n && r < b) {
      if (kCont && kCat) {
        const float s5d = 2.2360679774997896f * sqrtf(dc[i] + 1e-12f);
        k = (1.0f + s5d + (5.0f / 3.0f) * dc[i]) * expf(-(s5d + dk[i]));
      } else if (kCont) {
        k = matern52(dc[i]);
      } else {
        k = expf(-dk[i]);
      }
    }
    if (kStoreK) kscr[static_cast<size_t>(r) * np + col] = k;
    const float v = warp_sum(k * a);
    if (lane == 0) s_red[warp * kPer + i] = v;
  }
  __syncthreads();
  // row t sums the warps of its half in column order
  if (threadIdx.x < kKRows) {
    const int t = threadIdx.x, h = t / kPer, i = t % kPer;
    constexpr int kWarpsPerHalf = kWarps / kHalves;
    float tot = 0.f;
    for (int w = 0; w < kWarpsPerHalf; ++w) {
      tot += s_red[(h * kWarpsPerHalf + w) * kPer + i];
    }
    mupart[static_cast<size_t>(blockIdx.x) * bp + row0 + t] = tot;
  }
}

// The K^-T tiles sit in shared memory in wgmma's 128-byte swizzle: 8
// rows of kTileK = 32 floats (128 bytes) make a 1024-byte atom, and the
// 16-byte chunk c of row r within its atom is stored at chunk c ^ (r % 8),
// so neither the copies in nor the tensor cores' reads collide on a bank.
constexpr int kAtomWords = 8 * kTileK;        // 256 floats, 1024 bytes
static_assert(kTileK * 4 == 128, "one 128-byte swizzle row per K tile");
__device__ __forceinline__ int swizzled(int r, int c4) {
  return (r >> 3) * kAtomWords + (r & 7) * kTileK + ((c4 ^ (r & 7)) << 2);
}
// The wgmma descriptor of such a tile: start address, stride between
// atoms along N (1024 bytes), 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAtomWords * 4 >> 4) << 32) | (1ull << 62);
}

// Keep a register that an asynchronous wgmma reads or writes live, and
// in place, up to this point: the compiler does not know the wgmma runs
// on after its instruction.
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (+)= a b over one 64 x 128 x 8 step of the warpgroup: a, TF32, from
// registers (the m16n8k8 A fragment of this warp's 16 rows), b, TF32,
// K-major from shared memory; scale_d 0 starts d afresh.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// One stage: k rows [row0, +kTileM) x depth [kk, +kTileK) into sa (row
// stride kLdA), K^-T hi / lo rows [col0, +kTileN) x depth [kk, +kTileK)
// into sh / sl, swizzled; 16 bytes a copy.
__device__ __forceinline__ void wq_load(float* sa, float* sh, float* sl,
                                        const float* __restrict__ kscr,
                                        const float* __restrict__ khi,
                                        const float* __restrict__ klo, int np,
                                        int row0, int col0, int kk) {
  constexpr int kChunks = kTileM * kTileK / 4, kPerRow = kTileK / 4;
  static_assert(kTileM == kTileN && kChunks % kThreads == 0,
                "whole copies per thread");
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kPerRow, c4 = i % kPerRow;
    cp_async16(sa + r * kLdA + c4 * 4,
               kscr + static_cast<size_t>(row0 + r) * np + kk + c4 * 4);
    const size_t src = static_cast<size_t>(col0 + r) * np + kk + c4 * 4;
    cp_async16(sh + swizzled(r, c4), khi + src);
    cp_async16(sl + swizzled(r, c4), klo + src);
  }
}

// This warp's A fragments of one stage (rows rbase + g, + 8; depth ks * 8
// + tq, + 4), split into TF32 hi and lo.
__device__ __forceinline__ void wq_split(const float* sa, int rbase,
                                         uint32_t (&hi)[kTileK / 8][4],
                                         uint32_t (&lo)[kTileK / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kTileK / 8; ++ks) {
    const float* p = sa + (rbase + g) * kLdA + ks * 8 + tq;
    split_tf32(p[0], hi[ks][0], lo[ks][0]);
    split_tf32(p[8 * kLdA], hi[ks][1], lo[ks][1]);
    split_tf32(p[4], hi[ks][2], lo[ks][2]);
    split_tf32(p[8 * kLdA + 4], hi[ks][3], lo[ks][3]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* m, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(m)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* m) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_u32(m))
      : "memory");
}
// the barrier counts one arrival when this thread's earlier cp.async
// copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* m) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(m))
               : "memory");
}
// Wait for the phase of the given parity to complete; a wait that never
// ends is a fault, so it traps (the launch then fails) rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* m, int parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(m)), "r"(parity)
        : "memory");
    if (spin > (1ll << 26)) __trap();
  }
}

// Block (column tile t, row tile y): W = k K^-1 over a kTileM x kTileN
// tile in 3xTF32, then qpart[t * bp + row] = sum over the tile's columns
// of W * k.  Warpgroup w takes rows 64w + [0, 64) and all kTileN columns
// in wgmma m64n128k8 steps, A from registers and K^-T from shared memory.
// Each stage's products start a fresh f32 accumulator that is then added
// to the total: the tensor cores' sums truncate, and one chain over all
// of N would miss the sd tolerance near the training rows.  A warpgroup
// waits for its own products before that add, so the two warpgroups are
// not tied by a block barrier: a stage's copies complete a "full"
// mbarrier, and its reuse waits for an "empty" one that every thread
// arrives on when done with it; the tensor cores then take one
// warpgroup's products while the other adds and splits.
__global__ void __launch_bounds__(kThreads, 1) wq_kernel(
    const float* __restrict__ kscr, const float* __restrict__ khi,
    const float* __restrict__ klo, int np, int bp,
    float* __restrict__ qpart) {
  extern __shared__ __align__(1024) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageWords);
  uint64_t* empty = full + kStages;
  const int col0 = blockIdx.x * kTileN, row0 = blockIdx.y * kTileM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rbase = warp * 16;          // (64 * warpgroup + 16 * warp in it)
  const int kt_n = np / kTileK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kThreads);
      mbar_init(empty + s, kThreads);
    }
  }
  __syncthreads();
  auto stage = [&](int t) { return smem + (t % kStages) * kStageWords; };
  // every thread copies its share of tile t and arrives on its "full"
  // barrier when the copies land
  auto load = [&](int t) {
    float* st = stage(t);
    wq_load(st, st + kTileM * kLdA, st + kTileM * kLdA + kTileN * kTileK,
            kscr, khi, klo, np, row0, col0, t * kTileK);
    mbar_arrive_copies(full + t % kStages);
  };

  float tot[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = acc[i] = 0.f;
  for (int t = 0; t < kStages - 1 && t < kt_n; ++t) load(t);
  uint32_t ahi[kTileK / 8][4], alo[kTileK / 8][4];
  for (int kt = 0; kt < kt_n; ++kt) {
    // the (kt / kStages)-th use of this stage has landed
    mbar_wait(full + kt % kStages, (kt / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wq_split(stage(kt), rbase, ahi, alo);
    const float* sh = stage(kt) + kTileM * kLdA;
    const uint64_t dh = smem_desc(sh), dl = smem_desc(sh + kTileN * kTileK);
#pragma unroll
    for (int i = 0; i < 64; ++i) hold(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      // 8 deep = 32 bytes into the swizzled rows: 2 descriptor units
      const uint64_t step = static_cast<uint64_t>(ks * 2);
      wgmma_tf32(acc, alo[ks], dh + step, ks > 0);
      wgmma_tf32(acc, ahi[ks], dl + step, 1);
      wgmma_tf32(acc, ahi[ks], dh + step, 1);
    }
    wgmma_commit();
    // the next tile goes into the stage of tile kt - 1, once every thread
    // is done with that tile
    const int t = kt + kStages - 1;
    if (t < kt_n) {
      if (kt >= 1) mbar_wait(empty + t % kStages, ((kt - 1) / kStages) & 1);
      load(t);
    }
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hold(ahi[ks][e]);
        hold(alo[ks][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      hold(acc[i]);
      tot[i] += acc[i];
    }
    mbar_arrive(empty + kt % kStages);
  }

  // epilogue: element i of this thread is row g + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 tq + i % 2; each row's sum of W * k over its 32 columns
  // in this thread, then over the 4 threads of its quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rbase + g + 8 * h;
    const float* kr = kscr + static_cast<size_t>(r) * np + col0 + 2 * tq;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * j);
      s = fmaf(tot[4 * j + 2 * h], kv.x, s);
      s = fmaf(tot[4 * j + 2 * h + 1], kv.y, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tq == 0) qpart[static_cast<size_t>(blockIdx.x) * bp + r] = s;
  }
}

// -- A ----------------------------------------------------------------------------

// d (+)= a b over one 64 x 64 x 8 step of the warpgroup: wgmma_tf32 at half
// the width (the m16n8k8 A fragment from registers, b K-major and swizzled
// in shared memory; scale_d 0 starts d afresh).
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// How A and krows_mma pack a row's features for the tensor cores: the
// continuous block padded with zeros to a multiple of 8 (fcp), then the
// categorical block padded the same way (d in all), cut into nch chunks of
// kTileK (dp words).
struct Packing {
  int fcp, d, steps, sc, nch, dp;
  __host__ __device__ Packing(int fc, int fk) {
    fcp = (fc + 7) / 8 * 8;
    d = fcp + (fk + 7) / 8 * 8;
    steps = d / 8;                           // 8-deep wgmma steps
    sc = fcp / 8;                            // of them the continuous block's
    nch = (d + kTileK - 1) / kTileK;
    dp = nch * kTileK;
  }
};

// Where A's block keeps its data, in 4-byte words of dynamic shared memory.
// The query planes hold every chunk, or with `stream` (features too many
// for that) one chunk, rebuilt for each unit.
struct MeanLayout : Packing {
  size_t qh, ql, raw, x0, nq, part, words;
  __host__ __device__ MeanLayout(int fc, int fk, bool stream)
      : Packing(fc, fk) {
    const size_t planes = stream ? 1 : nch;
    qh = 0;                                  // the query rows by chunk, TF32
    ql = qh + planes * kMeanChunk;           // hi and lo,
    raw = ql + planes * kMeanChunk;          // swizzled; the
    x0 = raw + kRawStages * kRawWords;       // training chunks' stages; the
    nq = x0 + dp;                            // centre; the query rows' norms
    part = nq + 2 * kMeanRows;               // {c, k}; every warp's sums of
    words = part + 2 * (kGroup / 32) * kMeanRows;  // the rows this block
  }                                          // owns, float64 (part is even)
};

// Where the packed feature p of row r lies: src + r * stride, in the
// continuous block c ([., fc]) or the categorical one k ([., fk]); src is
// null for the padding.
template <bool kCont, bool kCat>
__device__ __forceinline__ void feature_at(const float* c, const float* k,
                                           int fc, int fk, int fcp, int p,
                                           const float*& src, int& stride) {
  src = nullptr;
  stride = 0;
  if (kCont && p < fc) {
    src = c + p;
    stride = fc;
  } else if (kCat && p >= fcp && p < fcp + fk) {
    src = k + (p - fcp);
    stride = fk;
  }
}

// Add the squares of four packed features from p0 on to the continuous or
// the categorical norm (the padding is 0 and adds nothing).
template <bool kCont, bool kCat>
__device__ __forceinline__ void quad_norms(const float4& v, int p0, int fcp,
                                           float& nc, float& nk) {
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kCont && (!kCat || p0 + e < fcp)) {
      nc = fmaf(a[e], a[e], nc);
    } else {
      nk = fmaf(a[e], a[e], nk);
    }
  }
}

// The sum over the 8 lanes of an aligned group, the same in each of them.
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ void split4(const float4& v, uint4& h, uint4& l) {
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
}

// k of one (query, training) pair from its cross terms and norms: the
// distances |q|^2 + |x|^2 - 2 q.x, clamped at 0, then Matérn over the
// continuous block times exp(-d2) over the categorical one, in one exp:
// (1 + s5d + 5/3 dc) exp(-(s5d + dk)), s5d = sqrt(5 (dc + 1e-12)).
// sqrtf and expf keep f32's accuracy (the build uses no fast-math).
template <bool kCont, bool kCat>
__device__ __forceinline__ float pair_kernel(float dot_c, float dot_k,
                                             float nqc, float nqk, float nxc,
                                             float nxk) {
  const float dk = kCat ? fmaxf(fmaf(-2.0f, dot_k, nqk + nxk), 0.f) : 0.f;
  if (!kCont) return expf(-dk);
  const float dc = fmaxf(fmaf(-2.0f, dot_c, nqc + nxc), 0.f);
  const float s5d = sqrtf(fmaf(5.0f, dc, 5e-12f));
  return fmaf(5.0f / 3.0f, dc, 1.0f + s5d) * expf(-(s5d + dk));
}

// A's block: the query rows [row0, +kMeanRows) against the training tiles
// rank, rank + kSplit, ... (kMeanCols rows each) -> their partial means,
// summed over the cluster's kSplit blocks.  Both blocks of
// features are centred on training row 0.  The query rows are the wgmma's
// B operand: centred, split into TF32 hi and lo and swizzled into shared
// memory once, with their norms.  The training rows are its A operand,
// from registers: a unit is one 32-deep chunk of one tile (the last one
// with the tile's alpha), copied (cp.async, kRawStages - 1 ahead) into a
// row-major stage, from which each thread loads its A fragments two 8-deep
// steps at a time (rows 16 warp + g, + 8; depth 8 ks + tq, + 4), centres
// them, adds their squares to the two rows' norms (summed over the quad
// by shuffles), splits them and runs the chunk's cross terms
// (lo * hi, hi * lo, hi * hi each 8-deep step, into the continuous or the
// categorical accumulator).  Element i of a thread's accumulator is
// training row 16 warp + g + 8 ((i / 2) % 2) and query row 8 (i / 4) +
// 2 tq + i % 2: after a tile's last chunk the epilogue adds k alpha into
// the thread's 16 query rows' float64 partials, which end summed over g,
// then over the warps, then over the cluster.  With kStream the planes hold
// one chunk: the prologue forms the query rows' norms alone, and each unit
// first splits and swizzles its chunk of the query rows into the planes
// (read from L2: every chunk of the 64 rows once a tile).
template <bool kCont, bool kCat, bool kStream>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kGroup, 4)
    gp_mean_kernel(const float* __restrict__ qc, const float* __restrict__ qk,
                   const float* __restrict__ xc, const float* __restrict__ xk,
                   const float* __restrict__ alpha, float* __restrict__ mu,
                   int b, int n, int fc, int fk) {
  extern __shared__ __align__(1024) float smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / kSplit) * kMeanRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const MeanLayout L(fc, fk, kStream);
  float* s_x0 = smem + L.x0;
  float* s_nq = smem + L.nq;       // [kMeanRows] {continuous, categorical}
  const int ntiles = (n + kMeanCols - 1) / kMeanCols;
  const int units =
      (rank < ntiles ? (ntiles - 1 - rank) / kSplit + 1 : 0) * L.nch;
  // this block has started: its peers may write into its shared memory
  // once they have waited for this arrival (before the partials, below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the next unit's copies (rows past n and features past the blocks as
  // zeros), one commit group whether or not there is such a unit; units go
  // in order, chunk by chunk of each tile
  int next = 0, next_i = 0, next_c = 0;
  auto stage = [&]() {
    if (next < units) {
      const int col0 = (rank + next_i * kSplit) * kMeanCols;
      const int have = min(kMeanCols, n - col0);
      float* dst = smem + L.raw + (next % kRawStages) * kRawWords;
      const float* src;
      int stride;
      feature_at<kCont, kCat>(xc, xk, fc, fk, L.fcp, next_c * kTileK + lane,
                              src, stride);
      const float* base =
          src != nullptr ? src + static_cast<size_t>(col0) * stride : alpha;
#pragma unroll
      for (int j = 0; j < kMeanCols / (kGroup / 32); ++j) {
        const int r = warp + j * (kGroup / 32);
        const bool ok = src != nullptr && r < have;
        cp_async4(dst + r * kLdX + lane,
                  ok ? base + static_cast<size_t>(r) * stride : alpha, ok);
      }
      if (next_c == L.nch - 1 && tid < kMeanCols) {
        const bool ok = tid < have;
        cp_async4(dst + kMeanCols * kLdX + tid, alpha + (ok ? col0 + tid : 0),
                  ok);
      }
    }
    cp_async_commit();
    ++next;
    if (++next_c == L.nch) {
      next_c = 0;
      ++next_i;
    }
  };

  // the query rows by chunk: thread (r, c4) takes 4 features of rows r =
  // tid / 8 + 16 j; chunk 0's values are loaded first, then the centre
  // (training row 0) and the first copies go out
  const int c4 = tid & 7;
  constexpr int kQRows = kMeanRows / (kGroup / 8);     // rows a thread takes
  float v[kQRows][4];
  auto load_queries = [&](int c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* src;
      int stride;
      feature_at<kCont, kCat>(qc, qk, fc, fk, L.fcp, c * kTileK + 4 * c4 + e,
                              src, stride);
#pragma unroll
      for (int j = 0; j < kQRows; ++j) {
        const int row = row0 + (tid >> 3) + j * (kGroup / 8);
        v[j][e] = src != nullptr && row < b
                      ? src[static_cast<size_t>(row) * stride] : 0.f;
      }
    }
  };
  load_queries(0);
  for (int p = tid; p < L.dp; p += kGroup) {
    const float* src;
    int stride;
    feature_at<kCont, kCat>(xc, xk, fc, fk, L.fcp, p, src, stride);
    s_x0[p] = src != nullptr ? *src : 0.f;
  }
  for (int i = tid; i < 2 * kMeanRows; i += kGroup) s_nq[i] = 0.f;
  for (int u = 0; u < kRawStages - 1; ++u) stage();
  __syncthreads();
  for (int c = 0; c < L.nch; ++c) {
    if (c > 0) load_queries(c);
    const int p0 = c * kTileK + 4 * c4;
    const float4 o = *reinterpret_cast<const float4*>(s_x0 + p0);
#pragma unroll
    for (int j = 0; j < kQRows; ++j) {
      const int r = (tid >> 3) + j * (kGroup / 8);
      const bool in = row0 + r < b;
      const float4 q = make_float4(in ? v[j][0] - o.x : 0.f,
                                   in ? v[j][1] - o.y : 0.f,
                                   in ? v[j][2] - o.z : 0.f,
                                   in ? v[j][3] - o.w : 0.f);
      float nc = 0.f, nk = 0.f;
      quad_norms<kCont, kCat>(q, p0, L.fcp, nc, nk);
      nc = sum8(nc);
      nk = sum8(nk);
      if (c4 == 0) {
        s_nq[2 * r] += nc;
        s_nq[2 * r + 1] += nk;
      }
      if (kStream) continue;
      uint4 h, l;
      split4(q, h, l);
      const size_t at =
          static_cast<size_t>(c) * kMeanChunk + swizzled(r, c4);
      *reinterpret_cast<uint4*>(smem + L.qh + at) = h;
      *reinterpret_cast<uint4*>(smem + L.ql + at) = l;
    }
  }
  // the planes are read by the tensor cores, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  // kStream: chunk c of the query rows, centred, split and swizzled into
  // the one plane (row by row, four features a thread); then the block
  // waits for it
  auto plane_chunk = [&](int c) {
    const int p0 = c * kTileK + 4 * c4;
    const float4 o = *reinterpret_cast<const float4*>(s_x0 + p0);
    const float* src[4];
    int stride[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      feature_at<kCont, kCat>(qc, qk, fc, fk, L.fcp, p0 + e, src[e],
                              stride[e]);
    }
#pragma unroll
    for (int j = 0; j < kQRows; ++j) {
      const int r = (tid >> 3) + j * (kGroup / 8);
      const bool in = row0 + r < b;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = src[e] != nullptr && in
                   ? src[e][static_cast<size_t>(row0 + r) * stride[e]] - (&o.x)[e]
                   : 0.f;
      }
      uint4 h, l;
      split4(make_float4(w[0], w[1], w[2], w[3]), h, l);
      *reinterpret_cast<uint4*>(smem + L.qh + swizzled(r, c4)) = h;
      *reinterpret_cast<uint4*>(smem + L.ql + swizzled(r, c4)) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  };

  float accc[32], acck[32], xn[2][2];
  double part[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) accc[i] = acck[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) part[i] = 0.0;
  const float4* nq4 = reinterpret_cast<const float4*>(s_nq);
  for (int u = 0, c = 0; u < units; ++u, c = c + 1 == L.nch ? 0 : c + 1) {
    cp_async_wait<kRawStages - 2>();
    __syncthreads();               // unit u has landed; unit u - 1's stage
    stage();                       // is free for unit u + kRawStages - 1
    if (kStream) plane_chunk(c);   // unit u - 1's products are done
    const float* raw = smem + L.raw + (u % kRawStages) * kRawWords;
    const float* xr = raw + (16 * warp + g) * kLdX + tq;
    if (c == 0) xn[0][0] = xn[0][1] = xn[1][0] = xn[1][1] = 0.f;
    // the cross terms, two 8-deep steps at a time (the fragments of two
    // steps in flight keep the registers within 4 blocks an SM)
    const size_t plane = kStream ? 0 : static_cast<size_t>(c) * kMeanChunk;
    const uint64_t dh = smem_desc(smem + L.qh + plane);
    const uint64_t dl = smem_desc(smem + L.ql + plane);
    float nc[2] = {0.f, 0.f}, nk[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // this thread's A fragments of the two steps, centred, squared into
      // the norms and split: [kk][e] is row g + 8 (e % 2), depth 8 ks + tq
      // + 4 (e / 2), ks = 2 half + kk
      uint32_t fh[2][4], fl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dp = 8 * (2 * half + kk) + 4 * (e >> 1);
          const int p = c * kTileK + dp + tq;
          const float a = xr[(e & 1) * 8 * kLdX + dp] - s_x0[p];
          if (kCont && (!kCat || p < L.fcp)) {
            nc[e & 1] += a * a;
          } else {
            nk[e & 1] += a * a;
          }
          split_tf32(a, fh[kk][e], fl[kk][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (kCont) hold(accc[i]);
        if (kCat) hold(acck[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * half + kk, s = c * (kTileK / 8) + ks;
        // 8 deep = 32 bytes into the swizzled rows: 2 descriptor units
        const uint64_t step = static_cast<uint64_t>(ks * 2);
        if (s < L.steps) {
          if (kCont && (!kCat || s < L.sc)) {
            wgmma_tf32_n64(accc, fl[kk], dh + step, s > 0);
            wgmma_tf32_n64(accc, fh[kk], dl + step, 1);
            wgmma_tf32_n64(accc, fh[kk], dh + step, 1);
          } else {
            wgmma_tf32_n64(acck, fl[kk], dh + step, s > L.sc);
            wgmma_tf32_n64(acck, fh[kk], dl + step, 1);
            wgmma_tf32_n64(acck, fh[kk], dh + step, 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hold(fh[kk][e]);
          hold(fl[kk][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (kCont) hold(accc[i]);
        if (kCat) hold(acck[i]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nc[h] += __shfl_xor_sync(0xffffffffu, nc[h], 1);
      nc[h] += __shfl_xor_sync(0xffffffffu, nc[h], 2);
      nk[h] += __shfl_xor_sync(0xffffffffu, nk[h], 1);
      nk[h] += __shfl_xor_sync(0xffffffffu, nk[h], 2);
      xn[h][0] += nc[h];
      xn[h][1] += nk[h];
    }
    if (c != L.nch - 1) continue;

    // the epilogue: k of each element, k alpha (exact in float64) into its
    // query row's partial, training row g before g + 8
    const double al[2] = {raw[kMeanCols * kLdX + 16 * warp + g],
                          raw[kMeanCols * kLdX + 16 * warp + g + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q = nq4[4 * j + tq];    // query rows 8 j + 2 tq, + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float k = pair_kernel<kCont, kCat>(
              accc[i], acck[i], e ? q.z : q.x, e ? q.w : q.y, xn[h][0],
              xn[h][1]);
          part[2 * j + e] = fma(static_cast<double>(k), al[h],
                                part[2 * j + e]);
        }
      }
    }
  }

  // each query row's partial over the 8 g of its lanes; then each warp's
  // sums go to the block of the cluster that owns the row, which adds them
  // in (rank, warp) order after the one cluster barrier and rounds the
  // float64 total to f32 once
  constexpr int kOwn = kMeanRows / kSplit;   // rows a block writes
  double* s_in = reinterpret_cast<double*>(smem + L.part);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    double t = part[m];
    t += __shfl_xor_sync(0xffffffffu, t, 4);
    t += __shfl_xor_sync(0xffffffffu, t, 8);
    t += __shfl_xor_sync(0xffffffffu, t, 16);
    if (g == 0) {
      const int r = 8 * (m / 2) + 2 * tq + m % 2;
      double* dst = cluster.map_shared_rank(s_in, r / kOwn);
      dst[(rank * (kGroup / 32) + warp) * kOwn + r % kOwn] = t;
    }
  }
  cluster.sync();
  if (tid < kOwn) {
    double tot = 0.0;
    for (int q = 0; q < kSplit * (kGroup / 32); ++q) {
      tot += s_in[q * kOwn + tid];
    }
    const int row = row0 + rank * kOwn + tid;
    if (row < b) mu[row] = static_cast<float>(tot);
  }
}

// d (+)= a b over one 64 x 64 x 8 step of the warpgroup, both operands
// TF32, K-major and swizzled in shared memory (scale_d 0 starts d afresh).
__device__ __forceinline__ void wgmma_tf32_n64_ss(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// krows past 361 features (krows_on_tensor_cores): block (tile t, row
// block y) takes the kTileN training rows of tile t, one warpgroup per 64
// of them, against kMeanRows query rows, with A's distances: both blocks
// centred on training row 0, |q|^2 + |x|^2 - 2 q.x clamped at 0, the cross
// term on wgmma m64n64k8 in 3xTF32 into a continuous and a categorical
// accumulator, k by pair_kernel.  The features go 32 at a time (A's
// Packing): each thread loads its four features of its rows of chunk c + 1
// into registers while chunk c's products run, then writes them centred,
// split into TF32 hi and lo and swizzled (A's planes) into the chunk's
// buffer (two, in turns), adding their squares to the rows' norms on the
// way (each row's by the same 8 threads, in chunk order).  Both operands
// come from shared memory; one barrier a chunk, and each warpgroup waits
// for a chunk's products before it writes the next.  Two blocks share an
// SM, so one's products run while the other loads and writes (on an H100
// keeping one chunk's products in flight within a block measured no
// faster, and three buffers, which leave one block an SM, slower).
// Then, as krows: k into kscr (kStoreK, zeros
// outside B x N) and each query row's partial mean over the tile, summed
// in one order whatever the row's place: its two training rows in this
// thread, the 8 g of a warp by shuffles, then the warps in turn.
template <bool kCont, bool kCat, bool kStoreK>
__global__ void __launch_bounds__(kThreads, KRowsMmaLayout::kBlocksPerSM)
    krows_mma_kernel(
    const float* __restrict__ qc, const float* __restrict__ qk,
    const float* __restrict__ xc, const float* __restrict__ xk,
    const float* __restrict__ alpha, int b, int n, int fc, int fk, int np,
    int bp, float* __restrict__ kscr, float* __restrict__ mupart) {
  using KL = KRowsMmaLayout;
  static_assert(kTileN == 2 * kMeanCols && kThreads == 2 * kGroup,
                "one warpgroup per 64 training rows");
  extern __shared__ __align__(1024) float smem[];
  const Packing P(fc, fk);
  const int col0 = blockIdx.x * kTileN, row0 = blockIdx.y * kMeanRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, c4 = tid & 7, r8 = tid >> 3;
  float* s_nq = smem + KL::nq;       // [kMeanRows] {continuous, categorical}
  float* s_nx = smem + KL::nx;       // [kTileN] {continuous, categorical}
  float* s_red = smem + KL::red;     // [kWarps][kMeanRows]
  constexpr int kQR = kMeanRows / (kThreads / 8);   // query rows a thread
  constexpr int kXR = kTileN / (kThreads / 8);      // training rows a thread

  // chunk c's features p0 .. p0 + 3 (p0 = 32 c + 4 c4) of this thread's
  // rows r8 + 32 j, and the centre's (training row 0), into registers:
  // one 16-byte load a row where the quad lies whole in one block and
  // aligned, else one load a feature (w of them; zeros past the block)
  float vq[kQR][4], vx[kXR][4], o[4];
  auto load = [&](int c) {
    const int p0 = c * kTileK + 4 * c4;
    const float *qs = nullptr, *xs = nullptr;
    int stride = 0, w = 0;
    if (kCont && p0 < fc) {
      qs = qc + p0;
      xs = xc + p0;
      stride = fc;
      w = min(4, fc - p0);
    } else if (kCat && p0 >= P.fcp && p0 < P.fcp + fk) {
      qs = qk + (p0 - P.fcp);
      xs = xk + (p0 - P.fcp);
      stride = fk;
      w = min(4, P.fcp + fk - p0);
    }
    const bool vec = w == 4 && stride % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(qs) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
    auto quad = [&](float (&dst)[4], const float* src, int row, bool in) {
      if (vec && in) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(row) * stride));
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
        return;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[e] = in && e < w ? src[static_cast<size_t>(row) * stride + e]
                             : 0.f;
      }
    };
    quad(o, xs, 0, w > 0);
#pragma unroll
    for (int j = 0; j < kQR; ++j) {
      const int row = row0 + r8 + j * (kThreads / 8);
      quad(vq[j], qs, row, w > 0 && row < b);
    }
#pragma unroll
    for (int j = 0; j < kXR; ++j) {
      const int col = col0 + r8 + j * (kThreads / 8);
      quad(vx[j], xs, col, w > 0 && col < n);
    }
  };
  // one row's quad, centred (zero for a row outside the operands), its
  // squares summed over the row's 8 threads into the norms, split and
  // swizzled into the hi / lo planes
  auto put = [&](const float (&v)[4], bool in, int r, int p0, float* hi,
                 float* lo, float* norm, bool first) {
    const float4 q = make_float4(in ? v[0] - o[0] : 0.f,
                                 in ? v[1] - o[1] : 0.f,
                                 in ? v[2] - o[2] : 0.f,
                                 in ? v[3] - o[3] : 0.f);
    float nc = 0.f, nk = 0.f;
    quad_norms<kCont, kCat>(q, p0, P.fcp, nc, nk);
    nc = sum8(nc);
    nk = sum8(nk);
    if (c4 == 0) {
      norm[2 * r] = first ? nc : norm[2 * r] + nc;
      norm[2 * r + 1] = first ? nk : norm[2 * r + 1] + nk;
    }
    uint4 h, l;
    split4(q, h, l);
    *reinterpret_cast<uint4*>(hi + swizzled(r, c4)) = h;
    *reinterpret_cast<uint4*>(lo + swizzled(r, c4)) = l;
  };

  float accc[32], acck[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accc[i] = acck[i] = 0.f;
  const int wg = warp / 4;           // this warpgroup's 64 training rows
  load(0);
  for (int c = 0; c < P.nch; ++c) {
    // buffer c % 2 was last read by chunk c - 2's products, which every
    // warpgroup waited for before chunk c - 1's barrier
    float* buf = smem + static_cast<size_t>(c % KL::kMmaBuffers) *
                            KL::kBufWords;
    const int p0 = c * kTileK + 4 * c4;
#pragma unroll
    for (int j = 0; j < kQR; ++j) {
      const int r = r8 + j * (kThreads / 8);
      put(vq[j], row0 + r < b, r, p0, buf + KL::qh, buf + KL::ql, s_nq,
          c == 0);
    }
#pragma unroll
    for (int j = 0; j < kXR; ++j) {
      const int r = r8 + j * (kThreads / 8);
      put(vx[j], col0 + r < n, r, p0, buf + KL::xh, buf + KL::xl, s_nx,
          c == 0);
    }
    // the planes are read by the tensor cores, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (c + 1 < P.nch) load(c + 1);
    const uint64_t qh = smem_desc(buf + KL::qh), ql = smem_desc(buf + KL::ql);
    const size_t xoff = static_cast<size_t>(wg) * kMeanCols * kTileK;
    const uint64_t xh = smem_desc(buf + KL::xh + xoff);
    const uint64_t xl = smem_desc(buf + KL::xl + xoff);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (kCont) hold(accc[i]);
      if (kCat) hold(acck[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const int s = c * (kTileK / 8) + ks;
      // 8 deep = 32 bytes into the swizzled rows: 2 descriptor units
      const uint64_t step = static_cast<uint64_t>(ks * 2);
      if (s < P.steps) {
        if (kCont && (!kCat || s < P.sc)) {
          wgmma_tf32_n64_ss(accc, xl + step, qh + step, s > 0);
          wgmma_tf32_n64_ss(accc, xh + step, ql + step, 1);
          wgmma_tf32_n64_ss(accc, xh + step, qh + step, 1);
        } else {
          wgmma_tf32_n64_ss(acck, xl + step, qh + step, s > P.sc);
          wgmma_tf32_n64_ss(acck, xh + step, ql + step, 1);
          wgmma_tf32_n64_ss(acck, xh + step, qh + step, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (kCont) hold(accc[i]);
    if (kCat) hold(acck[i]);
  }
  __syncthreads();                   // every row's norms are in

  // the epilogue: element i is training row 16 warp + g + 8 ((i / 2) % 2)
  // and query row 8 (i / 4) + 2 tq + i % 2
  float al[2], xn[2][2];
  bool xin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    xin[h] = col0 + r < n;
    al[h] = xin[h] ? alpha[col0 + r] : 0.f;
    xn[h][0] = s_nx[2 * r];
    xn[h][1] = s_nx[2 * r + 1];
  }
  const float4* nq4 = reinterpret_cast<const float4*>(s_nq);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = nq4[4 * j + tq];      // query rows 8 j + 2 tq, + 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * tq + e;
      const bool in = row0 + r < b;
      float k[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        k[h] = in && xin[h] ? pair_kernel<kCont, kCat>(
                                  accc[i], acck[i], e ? q.z : q.x,
                                  e ? q.w : q.y, xn[h][0], xn[h][1])
                            : 0.f;
        if (kStoreK) {
          kscr[static_cast<size_t>(row0 + r) * np + col0 + 16 * warp + g +
               8 * h] = k[h];
        }
      }
      float t = fmaf(k[1], al[1], k[0] * al[0]);
      t += __shfl_xor_sync(0xffffffffu, t, 4);
      t += __shfl_xor_sync(0xffffffffu, t, 8);
      t += __shfl_xor_sync(0xffffffffu, t, 16);
      if (g == 0) s_red[warp * kMeanRows + r] = t;
    }
  }
  __syncthreads();
  if (tid < kMeanRows) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += s_red[w * kMeanRows + tid];
    mupart[static_cast<size_t>(blockIdx.x) * bp + row0 + tid] = tot;
  }
}

// -- the selection --------------------------------------------------------------

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One row's tn partial sums, added in tile order: the one summation order
// of the mean and of q, for B, C and D alike.
__device__ __forceinline__ float tile_sum(const float* __restrict__ part,
                                          int bp, int tn, int r) {
  float s = 0.f;
  for (int t = 0; t < tn; ++t) s += part[static_cast<size_t>(t) * bp + r];
  return s;
}

// B's last pass, one thread per row: the moments themselves.
__global__ void __launch_bounds__(kSel) moments_kernel(
    const float* __restrict__ mupart, const float* __restrict__ qpart, int b,
    int bp, int tn, float* __restrict__ mu, float* __restrict__ q) {
  const int r = blockIdx.x * kSel + threadIdx.x;
  if (r >= b) return;
  mu[r] = tile_sum(mupart, bp, tn, r);
  q[r] = tile_sum(qpart, bp, tn, r);
}

// One thread per row: the moments from the tn partials (in tile order),
// the utility into u; with kSelect, block x then sorts its kSel rows by
// (value desc, index asc) with a bitonic network (rows past b enter as
// (-inf, index)) and keeps the first k1 in cand_v / cand_i.  Block row y
// is segment y, the rows [y b, (y + 1) b) of the batch: its lists hold
// indices within the segment, and its n1 = gridDim.x lists follow the
// earlier segments' (one segment, y = 0, is the whole batch).
template <bool kSelect>
__global__ void __launch_bounds__(kSel) final_kernel(
    const float* __restrict__ mupart, const float* __restrict__ qpart,
    const float* __restrict__ params, int b, int bp, int tn, int kind,
    float* __restrict__ u, int k1, float* __restrict__ cand_v,
    int32_t* __restrict__ cand_i) {
  const int r = blockIdx.x * kSel + threadIdx.x;
  const int row = blockIdx.y * b + r;
  float val = __int_as_float(0xff800000);
  if (r < b) {
    const float mu_n = tile_sum(mupart, bp, tn, row);
    const float q = kind != kKindMean ? tile_sum(qpart, bp, tn, row) : 0.f;
    val = utility(mu_n, q, params, kind);
    u[row] = val;
  }
  if (!kSelect) return;
  __shared__ float sv[kSel];
  __shared__ int si[kSel];
  const int i = threadIdx.x;
  sv[i] = val;
  si[i] = r;
  __syncthreads();
  for (int len = 2; len <= kSel; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      const int j = i ^ stride;
      if (j > i) {
        const float vi = sv[i], vj = sv[j];
        const int ii = si[i], ij = si[j];
        if (((i & len) == 0) ? before(vj, ij, vi, ii)
                             : before(vi, ii, vj, ij)) {
          sv[i] = vj;
          sv[j] = vi;
          si[i] = ij;
          si[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  if (i < k1) {
    const size_t list =
        static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    cand_v[list * k1 + i] = sv[i];
    cand_i[list * k1 + i] = si[i];
  }
}

// The second level: first-level list l (n1 lists of k1, each sorted,
// every index distinct) is block l; its group is the lists [l / group *
// group, +group), and the group writes its k2 best, in order, to vals /
// idx [(l / group) k2, +k2).  An entry's rank in its group is its place
// in its own list plus, for every other list of the group, how many
// entries come before it there (a binary search in shared memory), so no
// entry waits on another.  The group's slots past its entries get
// (-inf, INT_MAX).  Block row y merges segment y's n1 lists into its own
// n2 = ceil(n1 / group) lists, after the earlier segments'.
__global__ void __launch_bounds__(kSel) topk_merge_kernel(
    const float* __restrict__ cand_v, const int32_t* __restrict__ cand_i,
    int n1, int k1, int group, int k2, float* __restrict__ vals,
    int32_t* __restrict__ idx) {
  constexpr int kBatch = 8;               // searches in flight per thread
  extern __shared__ __align__(16) float smem[];
  float* sv = smem;                                   // [kMergeSlots]
  int* si = reinterpret_cast<int*>(smem + kMergeSlots);
  const int gid = blockIdx.x / group, own = blockIdx.x % group;
  const int first = gid * group;
  const int lists = min(group, n1 - first);
  const int m = lists * k1;
  const int n2 = (n1 + group - 1) / group;
  const size_t seg = blockIdx.y;
  const size_t base = (seg * n1 + first) * k1;
  for (int e = threadIdx.x; e < m; e += kSel) {
    cp_async4(sv + e, cand_v + base + e, true);
    cp_async4(reinterpret_cast<float*>(si + e),
              reinterpret_cast<const float*>(cand_i + base + e), true);
  }
  cp_async_commit();
  const size_t out = (seg * n2 + gid) * k2;
  if (own == 0) {
    for (int e = m + threadIdx.x; e < k2; e += kSel) {
      vals[out + e] = __int_as_float(0xff800000);
      idx[out + e] = INT_MAX;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  int top = 1;                            // the largest power of 2 <= k1
  while (top * 2 <= k1) top *= 2;
  for (int p = threadIdx.x; p < k1; p += kSel) {
    const float v = sv[own * k1 + p];
    const int id = si[own * k1 + p];
    int rank = p;
    for (int l0 = 0; l0 < lists; l0 += kBatch) {
      // pos[u]: how many entries of list l0 + u come before (v, id)
      int pos[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) pos[u] = 0;
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int l = l0 + u, q = pos[u] + step;
          if (l < lists && l != own && q <= k1) {
            const int at = l * k1 + q - 1;
            if (before(sv[at], si[at], v, id)) pos[u] = q;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) rank += pos[u];
    }
    if (rank < k2) {
      vals[out + rank] = v;
      idx[out + rank] = id;
    }
  }
}

// Raise the kernel's dynamic shared memory limit to kMaxShared on the
// current device, once per device; a failure is returned and tried again
// at the next launch.  `done` is the kernel's per-device flag array.
template <typename Kern>
cudaError_t allow_shared(Kern kern, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxShared);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

// The operands every launcher takes (kinv and scratch null for A and for
// the mean kind).
struct Operands {
  const float *qc, *qk, *xc, *xk, *alpha, *kinv;
  float* scratch;
  int b, n, fc, fk;
};

// Dynamic shared memory of one block of A, in bytes.
size_t mean_bytes(int fc, int fk, bool stream) {
  return MeanLayout(fc, fk, stream).words * sizeof(float);
}

template <bool kCont, bool kCat, bool kStream>
cudaError_t launch_mean(const Operands& a, float* mu, cudaStream_t stream) {
  auto kern = gp_mean_kernel<kCont, kCat, kStream>;
  static std::atomic<bool> shared_allowed[kMaxDevices];
  const size_t smem = mean_bytes(a.fc, a.fk, kStream);
  if (smem > static_cast<size_t>(kMaxShared)) return cudaErrorInvalidValue;
  const cudaError_t attr = allow_shared(kern, shared_allowed);
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      (static_cast<long long>(a.b) + kMeanRows - 1) / kMeanRows * kSplit;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kGroup, smem, stream>>>(
      a.qc, a.qk, a.xc, a.xk, a.alpha, mu, a.b, a.n, a.fc, a.fk);
  return cudaGetLastError();
}

// A's planes hold every chunk of the query rows where they fit one block's
// shared memory (up to 376 features), else one chunk at a time (kStream).
// Both stay: streamed at F 31, A takes about a fifth longer on an H100
// (a rebuild from L2 and a barrier at each unit).
template <bool kCont, bool kCat>
cudaError_t launch_mean(const Operands& a, float* mu, cudaStream_t stream) {
  if (mean_bytes(a.fc, a.fk, false) <= static_cast<size_t>(kMaxShared)) {
    return launch_mean<kCont, kCat, false>(a, mu, stream);
  }
  return launch_mean<kCont, kCat, true>(a, mu, stream);
}

cudaError_t mean(const Operands& a, float* mu, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0) return cudaErrorInvalidValue;
  if (a.fc > 0 && a.fk > 0) return launch_mean<true, true>(a, mu, stream);
  if (a.fc > 0) return launch_mean<true, false>(a, mu, stream);
  if (a.fk > 0) return launch_mean<false, true>(a, mu, stream);
  return cudaErrorInvalidValue;
}

// The passes that leave each row's partial means in mupart and, with var,
// its partial q in qpart: kinv_prep, krows and wq, or krows alone.
// krows on its route for f features: the CUDA cores (all f in one
// block) or, past 361 features, the tensor cores.
template <bool kCont, bool kCat, bool kStoreK>
cudaError_t launch_krows(const Operands& a, const Plan& p, float* kscr,
                         float* mupart, cudaStream_t s) {
  const int f = a.fc + a.fk;
  if (krows_on_tensor_cores(f)) {
    auto kern = krows_mma_kernel<kCont, kCat, kStoreK>;
    static std::atomic<bool> allowed[kMaxDevices];
    const cudaError_t e = allow_shared(kern, allowed);
    if (e != cudaSuccess) return e;
    kern<<<dim3(p.tn, p.bp / kMeanRows), kThreads,
           KRowsMmaLayout::words * sizeof(float), s>>>(
        a.qc, a.qk, a.xc, a.xk, a.alpha, a.b, a.n, a.fc, a.fk, p.np, p.bp,
        kscr, mupart);
    return cudaGetLastError();
  }
  auto kern = krows_kernel<kCont, kCat, kStoreK>;
  static std::atomic<bool> allowed[kMaxDevices];
  const cudaError_t e = allow_shared(kern, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.tn, p.bp / kKRows), kThreads, krows_words(f) * sizeof(float),
         s>>>(a.qc, a.qk, a.xc, a.xk, a.alpha, a.b, a.n, a.fc, a.fk, p.np,
              p.bp, kscr, mupart);
  return cudaGetLastError();
}

template <bool kCont, bool kCat>
cudaError_t launch_passes(const Operands& a, const Plan& p, bool var,
                          cudaStream_t s) {
  float* mupart = a.scratch + p.mupart;
  float* qpart = a.scratch + p.qpart;
  float* kscr = a.scratch + p.kscr;
  float* khi = a.scratch + p.khi;
  float* klo = a.scratch + p.klo;
  cudaError_t e;
  if (!var) {
    return launch_krows<kCont, kCat, false>(a, p, nullptr, mupart, s);
  }
  kinv_prep_kernel<<<dim3(p.np / 32, p.np / 32), kThreads, 0, s>>>(
      a.kinv, a.n, p.np, khi, klo);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = launch_krows<kCont, kCat, true>(a, p, kscr, mupart, s)) !=
      cudaSuccess) {
    return e;
  }

  static std::atomic<bool> wq_allowed[kMaxDevices];
  if ((e = allow_shared(wq_kernel, wq_allowed)) != cudaSuccess) return e;
  wq_kernel<<<dim3(p.tn, p.bp / kTileM), kThreads, kWqShared, s>>>(
      kscr, khi, klo, p.np, p.bp, qpart);
  return cudaGetLastError();
}

cudaError_t passes(const Operands& a, const Plan& p, bool var,
                   cudaStream_t s) {
  if (var != (a.kinv != nullptr) || a.scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (a.fc > 0 && a.fk > 0) return launch_passes<true, true>(a, p, var, s);
  if (a.fc > 0) return launch_passes<true, false>(a, p, var, s);
  if (a.fk > 0) return launch_passes<false, true>(a, p, var, s);
  return cudaErrorInvalidValue;
}

// B: the variance passes, then the moments
cudaError_t mean_var(const Operands& a, float* mu, float* q, cudaStream_t s) {
  Plan p;
  if (!make_plan(a.b, a.n, 1, 0, &p)) return cudaErrorInvalidValue;
  const cudaError_t e = passes(a, p, true, s);
  if (e != cudaSuccess) return e;
  moments_kernel<<<p.n1, kSel, 0, s>>>(a.scratch + p.mupart,
                                       a.scratch + p.qpart, a.b, p.bp, p.tn,
                                       mu, q);
  return cudaGetLastError();
}

// What C and D take beyond the operands (vals, idx null and k = 0 for C)
struct Acquire {
  const float* params;
  float *u, *vals;
  int32_t* idx;
  int kind, k;
};

// C and D: the passes, then the utility and, for D, the selection.  D
// ranks `segs` segments of a.b rows each (C takes one): the passes run
// over all segs * a.b rows as one batch, so a row's utility is the one a
// launch of its segment alone gives, and the selection is per segment.
cudaError_t acquire(const Operands& a, const Acquire& q, int segs,
                    cudaStream_t s) {
  if (q.kind < kKindMean || q.kind > kKindLCB) return cudaErrorInvalidValue;
  if (segs > 65535 || (segs > 1 && q.k == 0)) return cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(a.b, a.n, q.kind != kKindMean, q.k, &p, segs)) {
    return cudaErrorInvalidValue;
  }
  Operands all = a;
  all.b = a.b * segs;               // make_plan held it under INT_MAX
  cudaError_t e = passes(all, p, q.kind != kKindMean, s);
  if (e != cudaSuccess) return e;
  const float* mupart = a.scratch + p.mupart;
  const float* qpart = a.scratch + p.qpart;
  float* cand_v = a.scratch + p.cand;
  int32_t* cand_i = reinterpret_cast<int32_t*>(
      cand_v + static_cast<size_t>(segs) * p.n1 * p.k1);
  if (q.k == 0) {
    final_kernel<false><<<p.n1, kSel, 0, s>>>(mupart, qpart, q.params, a.b,
                                              p.bp, p.tn, q.kind, q.u, 0,
                                              nullptr, nullptr);
    return cudaGetLastError();
  }
  final_kernel<true><<<dim3(p.n1, segs), kSel, 0, s>>>(
      mupart, qpart, q.params, a.b, p.bp, p.tn, q.kind, q.u, p.k1, cand_v,
      cand_i);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  static std::atomic<bool> merge_allowed[kMaxDevices];
  if ((e = allow_shared(topk_merge_kernel, merge_allowed)) != cudaSuccess) {
    return e;
  }
  topk_merge_kernel<<<dim3(p.n1, segs), kSel, kMergeShared, s>>>(
      cand_v, cand_i, p.n1, p.k1, p.group, p.k2, q.vals, q.idx);
  return cudaGetLastError();
}

Operands operands(const void* qc, const void* qk, const void* xc,
                  const void* xk, const void* alpha, const void* kinv,
                  void* scratch, int b, int n, int fc, int fk) {
  return Operands{static_cast<const float*>(qc), static_cast<const float*>(qk),
                  static_cast<const float*>(xc), static_cast<const float*>(xk),
                  static_cast<const float*>(alpha),
                  static_cast<const float*>(kinv),
                  static_cast<float*>(scratch), b, n, fc, fk};
}

}  // namespace

// Plain C interface (loaded with ctypes): the four launchers (the
// host-only queries of their geometry are gp_plan.h's).  Every launcher
// enqueues on `stream`, allocates nothing, and returns the cudaError_t of
// its launches (0 = success).  qc/xc (or qk/xk) are null when fc (or fk)
// is 0.

// A: mu_n [b] = k . alpha
extern "C" int ut_gp_mean(const void* qc, const void* qk, const void* xc,
                          const void* xk, const void* alpha, void* mu, int b,
                          int n, int fc, int fk, void* stream) {
  return static_cast<int>(
      mean(operands(qc, qk, xc, xk, alpha, nullptr, nullptr, b, n, fc, fk),
           static_cast<float*>(mu), static_cast<cudaStream_t>(stream)));
}

// B: mu_n [b] and q [b] = rowsum((k K^-1) * k); scratch of
// ut_acquire_scratch_words(b, n, 1, 0, 1) words
extern "C" int ut_gp_mean_var(const void* qc, const void* qk, const void* xc,
                              const void* xk, const void* alpha,
                              const void* kinv, void* mu, void* q,
                              void* scratch, int b, int n, int fc, int fk,
                              void* stream) {
  return static_cast<int>(mean_var(
      operands(qc, qk, xc, xk, alpha, kinv, scratch, b, n, fc, fk),
      static_cast<float*>(mu), static_cast<float*>(q),
      static_cast<cudaStream_t>(stream)));
}

// C: utilities [b] (kind 0 -mean, 1 EI, 2 -LCB; kinv null for kind 0);
// params [5] on the device; scratch of ut_acquire_scratch_words(b, n,
// kind != 0, 0, 1) words
extern "C" int ut_acquire_scores(const void* qc, const void* qk,
                                 const void* xc, const void* xk,
                                 const void* alpha, const void* kinv,
                                 const void* params, void* u, void* scratch,
                                 int b, int n, int fc, int fk, int kind,
                                 void* stream) {
  const Acquire a{static_cast<const float*>(params), static_cast<float*>(u),
                  nullptr, nullptr, kind, 0};
  return static_cast<int>(
      acquire(operands(qc, qk, xc, xk, alpha, kinv, scratch, b, n, fc, fk), a,
              1, static_cast<cudaStream_t>(stream)));
}

// D over segs segments (an instance axis; segs = 1 is one list): the query
// blocks qc / qk hold segs * b rows, segment y its rows [y b, (y + 1) b),
// all scored against the one GP; the utilities into u [segs b], then each
// segment's top k (1 <= k <= b) as its ut_acquire_topk_slots(b, k)
// candidates, indices within the segment, at vals / idx [y slots, +slots);
// scratch of ut_acquire_scratch_words(b, n, kind != 0, k, segs) words
// (1 <= segs <= 65535)
extern "C" int ut_acquire_topk(const void* qc, const void* qk, const void* xc,
                               const void* xk, const void* alpha,
                               const void* kinv, const void* params, void* u,
                               void* vals, void* idx, void* scratch, int b,
                               int n, int fc, int fk, int kind, int k,
                               int segs, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Acquire a{static_cast<const float*>(params), static_cast<float*>(u),
                  static_cast<float*>(vals), static_cast<int32_t*>(idx), kind,
                  k};
  return static_cast<int>(
      acquire(operands(qc, qk, xc, xk, alpha, kinv, scratch, b, n, fc, fk), a,
              segs, static_cast<cudaStream_t>(stream)));
}
