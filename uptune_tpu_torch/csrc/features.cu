// The GP's query features in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds these features with XLA
// ops, and so did the port, as a chain of about a hundred small ATen
// kernels (`Space.surrogate_transform(Space.features(cands))`,
// `uptune_tpu_torch/space/spec.py`): decode, encode, a gather, a one-hot
// compare, a scale and a concatenation, each a pass over the batch.  This
// kernel computes the same float32 features in one pass, and bit for bit
// the same: every op of the chain is done here once, in the same order and
// with the same rounding.
//
// The function.  A batch of B rows over D unit lanes and perm blocks of
// sizes s_0, s_1, ... (P items in all) gives B rows of F features:
//   - each numeric lane's unit value snapped to its decoded grid: decode,
//     then encode (`decode_scalars`, `encode_scalars`);
//   - each perm block's item positions, the stable argsort of its item
//     indices, times 1 / max(1, s - 1) (PyTorch's CUDA division by a
//     host scalar is a multiply by its float reciprocal);
//   - each categorical lane's code, one-hot over the space's most codes,
//     times float32(1 / sqrt(2)).
// The rounding: the chain rounds every op, so products and sums here are
// `__fmul_rn` / `__fadd_rn` / `__fsub_rn` (no FMA contraction), division
// is IEEE (`__fdiv_rn`), `nearbyintf` is `torch.round`, the
// transcendentals are the CUDA library's float functions that PyTorch's
// kernels call (expm1f, exp2f, log1pf, log2f), clamps pass NaN through
// as `torch.clamp` does, and `clip` is spec.py's `_clip` with its
// signed-zero rule.  The constants are spec.py's Python floats as
// float32, as PyTorch rounds a scalar operand, written exactly in hex.
//
// Design.  A byte-bound map, so each byte moves once, each element costs
// few instructions, and every access of a warp is to consecutive
// addresses.  A grid of blocks walks over tiles of `rows` rows (about
// kTileOut features a tile); for each tile a block
//   1. reads the tile's perm items and then its unit lanes, coalesced,
//      kUnroll loads in flight a thread, decodes and encodes each lane
//      once into shared memory (a categorical lane keeps its code, which
//      its one-hot columns compare) and copies the items beside them;
//   2. counts each perm item's rank within its block, one item a thread
//      (a stable argsort: the items below it, and the equal ones before
//      it), and writes the item's position to the rank's slot;
//   3. writes the tile's output, which is contiguous, flat: consecutive
//      threads write consecutive features, so each warp's store is 128
//      contiguous bytes.  Each output column is one entry of a
//      per-column table, {source slot, code}, a code of -1 copying the
//      slot and any other code comparing it.
// A thread's row and column in a tile advance by a constant step, with no
// division an element.  Stores of four consecutive features a thread
// (16 bytes) were slower: a warp then reads the column table and the
// slots at a 16-byte stride, four times the L1 wavefronts and a 4-way
// bank conflict a read.  The tables (lanes, columns, perm items) are
// built once per Space and device (`Space.feature_tables`) and read
// through the L1 cache; a call allocates nothing but its output and
// copies nothing to the device.  The perm blocks come as one [B, P]
// tensor, side by side, so a perm item's column is its index in the P.
// A perm item's rank costs O(s) reads of shared memory, O(s^2) a block
// of s items: the perm blocks of the repo's spaces hold a few dozen at
// most.  A row takes 4 (D + P) + 8 P bytes of shared memory; a tile has
// fewer rows where they pass 48 KB, and a row past 227 KB is refused.
//
// Bound.  Memory: 4 D + 8 P bytes read and 4 F written a row.  At the
// gcc-options space's B 6352, D 328, F 1027 that is 34.4 MB, 10.3 us at
// 3.35 TB/s; at the flagship's B 6040, D 13, P 12, F 31 1.64 MB, 0.49 us,
// where one launch's own cost dominates.  Measured on an H100 SXM at
// 700 W: 0.0185-0.0190 ms at gcc-options' shape (54-55 % of the bound),
// 0.0077-0.0087 ms at the flagship's.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// space/params.py's kinds
constexpr int kInt = 1, kLogFloat = 2, kLogInt = 3, kPow2 = 4, kBool = 5;
constexpr int kThreads = 256;
constexpr int kTileOut = 8192;           // features a tile, about
constexpr int kMaxRows = 64;             // rows a tile, at most
constexpr int kUnroll = 4;               // loads in flight a thread
constexpr int kBlocksPerSM = 8;          // the grid, at most
constexpr long long kSmemDefault = 48 * 1024;
constexpr long long kSmemMax = 227 * 1024;

// spec.py's constants as float32
constexpr float kLn2 = 0x1.62e43p-1f;          // _LN2
constexpr float kInvLn2 = 0x1.715476p+0f;      // _INV_LN2
constexpr float kLogFloor = -0x1.ff7ceep-1f;   // _LOG_FLOOR, -0.999
constexpr float kMinRange = 0x1.4484cp-100f;   // _MIN_RANGE, 1e-30
constexpr float kOneHot = 0x1.6a09e6p-1f;      // _ONE_HOT, 1 / sqrt(2)

// spec.py's _clip: x clipped to [lo, hi], max(-0, +0) = +0 and
// min(-0, +0) = -0; NaN goes to lo
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = (x > lo || (x == lo && !signbit(x))) ? x : lo;
  return (x < hi || (x == hi && signbit(x))) ? x : hi;
}

// torch.clamp_min on the card: NaN passes, else max
__device__ __forceinline__ float clamp_min(float x, float m) {
  return isnan(x) ? x : fmaxf(x, m);
}

// One lane of one row: the code of a categorical lane, else the unit
// value snapped to the lane's grid (decode, then encode).  t = {slo, shi,
// vlo, vhi}.
__device__ __forceinline__ float lane_feature(float u, int kind, float4 t) {
  const float slo = t.x, shi = t.y, vlo = t.z, vhi = t.w;
  const float s = __fadd_rn(__fmul_rn(u, __fsub_rn(shi, slo)), slo);
  float v = s;                                            // FLOAT
  if (kind == kInt) {
    v = clip(nearbyintf(s), vlo, vhi);
  } else if (kind == kLogFloat || kind == kLogInt) {
    v = __fadd_rn(expm1f(__fmul_rn(s, kLn2)), vlo);
    if (kind == kLogInt) v = clip(nearbyintf(v), vlo, vhi);
  } else if (kind == kPow2) {
    v = exp2f(clip(nearbyintf(s), vlo, vhi));
  } else if (kind >= kBool) {
    return clip(nearbyintf(s), vlo, vhi);                 // a code
  }
  float x = v;
  if (kind == kLogFloat || kind == kLogInt) {
    x = __fmul_rn(log1pf(clamp_min(__fsub_rn(v, vlo), kLogFloor)),
                  kInvLn2);
  } else if (kind == kPow2) {
    x = log2f(clamp_min(v, 1.0f));
  }
  const float range = clamp_min(__fsub_rn(shi, slo), kMinRange);
  const float w = __fdiv_rn(__fsub_rn(x, slo), range);
  return isnan(w) ? w : fminf(fmaxf(w, 0.0f), 1.0f);      // torch.clamp
}

// A thread's walk over a tile's [n, w] elements, flat, kThreads at a
// step: its row and column without a division a step.
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int start, int w_)
      : r(start / w_), c(start % w_), dr(kThreads / w_), dc(kThreads % w_),
        w(w_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

__global__ void __launch_bounds__(kThreads) surrogate_feats_kernel(
    const float* __restrict__ u, long long ld_u,
    const long long* __restrict__ perm, long long ld_p,
    const int* __restrict__ kind, const float4* __restrict__ lanes,
    const int2* __restrict__ cols, const int2* __restrict__ items_of,
    float* __restrict__ out, int b,
    int d, int p, int f, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* items = reinterpret_cast<long long*>(smem);      // [rows, p]
  float* slots = reinterpret_cast<float*>(items + rows * p);  // [rows, d+p]
  const int width = d + p;
  const long long n_tiles = (static_cast<long long>(b) + rows - 1) / rows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    const int n = static_cast<int>(
        min(static_cast<long long>(rows), static_cast<long long>(b) - row0));
    if (tile != blockIdx.x) __syncthreads();  // the last tile's slots read
    // 1. the perm items, then the lanes, decoded and encoded once
    if (p > 0) {
      Walk w(threadIdx.x, p);
      for (int i0 = threadIdx.x; i0 < n * p; i0 += kUnroll * kThreads) {
        long long y[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k, w.next()) {
          if (i0 + k * kThreads < n * p) {
            y[k] = perm[(row0 + w.r) * ld_p + w.c];
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (i0 + k * kThreads < n * p) items[i0 + k * kThreads] = y[k];
        }
      }
    }
    if (d > 0) {
      Walk w(threadIdx.x, d);
      for (int i0 = threadIdx.x; i0 < n * d; i0 += kUnroll * kThreads) {
        float x[kUnroll];
        int at[kUnroll], lane[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k, w.next()) {
          at[k] = w.r * width + w.c;
          lane[k] = w.c;
          if (i0 + k * kThreads < n * d) x[k] = u[(row0 + w.r) * ld_u + w.c];
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (i0 + k * kThreads < n * d) {
            slots[at[k]] = lane_feature(x[k], __ldg(kind + lane[k]),
                                        __ldg(lanes + lane[k]));
          }
        }
      }
    }
    __syncthreads();
    // 2. each item's rank within its block: its position goes there
    if (p > 0) {
      Walk w(threadIdx.x, p);
      for (int i = threadIdx.x; i < n * p; i += kThreads, w.next()) {
        const int2 it = __ldg(items_of + w.c);   // {first item, size}
        const long long* blk = items + w.r * p + it.x;
        const int j = w.c - it.x;
        const long long y = blk[j];
        int rank = 0;
        for (int k = 0; k < it.y; ++k) {
          rank += blk[k] < y || (blk[k] == y && k < j);
        }
        const float inv =
            __fdiv_rn(1.0f, static_cast<float>(max(1, it.y - 1)));
        slots[w.r * width + d + it.x + rank] =
            __fmul_rn(static_cast<float>(j), inv);
      }
      __syncthreads();
    }
    // 3. the tile's output, flat (n f fits an int: the launcher checks)
    float* o = out + row0 * f;
    Walk w(threadIdx.x, f);
    for (int e = threadIdx.x; e < n * f; e += kThreads, w.next()) {
      const int2 col = __ldg(cols + w.c);
      const float v = slots[w.r * width + col.x];
      o[e] = col.y < 0 ? v
                       : (v == static_cast<float>(col.y) ? kOneHot : 0.0f);
    }
  }
}

// The card's SMs, asked once a device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = success).
//
// u: [b, d] float32, row stride ld_u, unit stride along a row.  perm:
// [b, p] int64, the perm blocks side by side, row stride ld_p, unit
// stride along a row (not read for p = 0).  kind: [d] int32.  lanes:
// [d, 4] float32, {slo, shi, vlo, vhi} a lane.  cols: [f, 2] int32,
// {slot, code} an output column.  items_of: [p, 2] int32, a perm item's
// block: its first item of the p and its size.  out: [b, f] float32,
// contiguous.  Nothing is launched for b = 0 or f = 0.
extern "C" int ut_surrogate_features(
    const void* u, long long ld_u, const void* perm, long long ld_p,
    const void* kind, const void* lanes, const void* cols,
    const void* items_of, void* out, int b, int d, int p, int f,
    void* stream) {
  if (b < 0 || d < 0 || p < 0 || f < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || f == 0) return static_cast<int>(cudaSuccess);
  // a row's items and slots
  const long long per_row = 8LL * p + 4LL * (d + p);
  // about kTileOut features a tile, fewer where shared memory is short
  int rows = static_cast<int>(
      min(static_cast<long long>(kMaxRows), (kTileOut + f - 1LL) / f));
  while (rows > 1 && rows * per_row > kSmemDefault) rows /= 2;
  const long long smem = rows * per_row;
  if (smem > kSmemMax || static_cast<long long>(rows) * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        surrogate_feats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (static_cast<long long>(b) + rows - 1) / rows;
  const long long grid = static_cast<long long>(sm_count()) * kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(tiles < grid ? tiles : grid);
  surrogate_feats_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), ld_u, static_cast<const long long*>(perm),
      ld_p, static_cast<const int*>(kind), static_cast<const float4*>(lanes),
      static_cast<const int2*>(cols), static_cast<const int2*>(items_of),
      static_cast<float*>(out), b, d, p, f, rows);
  return static_cast<int>(cudaGetLastError());
}
