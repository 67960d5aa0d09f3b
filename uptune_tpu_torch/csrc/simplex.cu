// NelderMead's proposal in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package proposes with XLA ops, and so
// did the port, as a chain of ATen kernels (`ops/simplex.py`,
// `propose_chain`): a stable argsort, two gathers, the centroid as S - 1
// adds of one row each (XLA's rounding of `jnp.mean`), the four trial
// points, the S - 1 shrink points, two concatenations and three selects on
// the phase.  At the gcc-options space's S 329, D 328 that is about 370
// launches a proposal, 328 of them the centroid's adds.  This kernel
// computes the same float32 outputs in one launch, and bit for bit the
// same.
//
// The function.  An instance's simplex pts [S, D], its values vals [S],
// the INIT phase's padding rows draws [3, D] and its phase give
//   - in INIT (phase 0): the batch u = [pts; draws], and pts and vals as
//     they are for the new state;
//   - in any other phase (LOOP): with `order` the stable argsort of vals
//     and p = pts[order], c = (p_0 + p_1 + ... + p_{S-1}) * (1 / S),
//       u_0     = refl  = clamp(c + alpha (c - p_{S-1}))
//       u_1     = expa  = clamp(c + gamma (refl - c))
//       u_2     = c_out = clamp(c + beta (refl - c))
//       u_3     = c_in  = clamp(c + beta (p_{S-1} - c))
//       u_{3+k} = p_0 + sigma (p_k - p_0),  k = 1 .. S - 1,
//     and p and vals[order] for the new state.
// The order is jnp.argsort's and the CPU's torch.argsort(stable=True):
// -0 equals +0, every NaN sorts after +inf as one value, and ties keep
// the index order.  The rounding is the chain's: every op of it rounds,
// so sums, differences and products here are `__fadd_rn` / `__fsub_rn`
// / `__fmul_rn` (no FMA contraction), in the chain's order; the centroid
// sums the sorted rows one at a time from row 0 and multiplies by 1 / S
// as a float32 (the launcher's `inv_s`, PyTorch's conversion of the
// Python scalar); the clamp passes NaN through as `torch.clamp` does.
//
// Design.  Launch cost, not bytes, bounds the chain: at gcc-options' shape
// a proposal moves about 1.3 MB (0.4 us at 3.35 TB/s) in ~370 launches.
// Here a grid of (column tiles of kLanes lanes) x (instances), one block
// each:
//   1. every block ranks its instance's S values in shared memory, one
//      value a thread: the count of the values before it in the stable
//      order, over 32-bit sort keys (each value's float order as an
//      unsigned integer), so S^2 compares a block; the rank's slot gets
//      the value's index, and the first column tile writes the sorted
//      values;
//   2. the sorted rows go through shared memory kChunk at a time: every
//      row group of the block reads kUnroll rows of its tile at once (a
//      warp reads 32 consecutive lanes of a row, 128 bytes), writes them
//      to the new state and their shrink points to the batch, and stages
//      them; then the first row group, one thread a lane, adds the staged
//      rows to its lanes' sums in order, which no other order may round;
//   3. the first row group writes the four trial points.
// In INIT a block copies its tile of pts and draws and nothing is ranked.
// `phase` is read on the device, so a launch never waits on the host, and
// a call allocates nothing but its outputs: the kernel is captured in the
// engine's CUDA graphs like any ATen kernel.  A block takes 8 S bytes of
// shared memory for the rank and 4 kChunk kLanes for the staged rows.
//
// Bound.  Memory: 4 (S D + S) bytes read and 4 ((2 S + 3) D + S) written
// an instance in LOOP.  At gcc-options' S 329, D 328 that is 1.30 MB,
// 0.39 us at 3.35 TB/s; at the flagship's S 14, D 13 2.7 KB, where one
// launch's own cost dominates.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 32;                  // columns a block
constexpr int kGroups = kThreads / kLanes;  // rows read at a time
constexpr int kChunk = 256;                 // sorted rows staged at a time
constexpr int kUnroll = 8;                  // rows a thread reads at once
constexpr int kInit = 0;                    // techniques/simplex.py's INIT
constexpr long long kSmemDefault = 48 * 1024;
constexpr long long kSmemMax = 227 * 1024;

// A value's place in the stable order as an unsigned integer: -0 as +0,
// every NaN above +inf and equal to the others.
__device__ __forceinline__ unsigned sort_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// torch.clamp(x, 0, 1) on the card: NaN passes, else min(max(x, 0), 1)
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads) simplex_propose_kernel(
    const float* __restrict__ pts, const float* __restrict__ vals,
    const float* __restrict__ draws, const int* __restrict__ phase,
    float* __restrict__ u, float* __restrict__ new_pts,
    float* __restrict__ new_vals, int s, int d, float alpha, float gamma,
    float beta, float sigma, float inv_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long inst = blockIdx.y;
  const long long sd = static_cast<long long>(s) * d;
  pts += inst * sd;
  vals += inst * s;
  draws += inst * 3LL * d;
  u += inst * (sd + 3LL * d);
  new_pts += inst * sd;
  new_vals += inst * s;
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int col = blockIdx.x * kLanes + lane;
  const bool live = col < d;
  const bool first_tile = blockIdx.x == 0;

  if (__ldg(phase + inst) == kInit) {
    if (live) {
      for (int r = group; r < s + 3; r += kUnroll * kGroups) {
        float x[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int row = r + k * kGroups;
          x[k] = row < s       ? pts[row * d + col]
                 : row < s + 3 ? draws[(row - s) * d + col]
                               : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int row = r + k * kGroups;
          if (row < s + 3) u[row * d + col] = x[k];
          if (row < s) new_pts[row * d + col] = x[k];
        }
      }
    }
    if (first_tile) {
      for (int i = threadIdx.x; i < s; i += kThreads) new_vals[i] = vals[i];
    }
    return;
  }

  unsigned* keys = reinterpret_cast<unsigned*>(smem);   // [s]
  int* order = reinterpret_cast<int*>(keys + s);        // [s]
  float* tile = reinterpret_cast<float*>(order + s);    // [kChunk, kLanes]
  for (int i = threadIdx.x; i < s; i += kThreads) keys[i] = sort_key(vals[i]);
  __syncthreads();
  // 1. each value's rank: the values before it in the stable order
  for (int i = threadIdx.x; i < s; i += kThreads) {
    const unsigned k = keys[i];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += keys[j] <= k;
    for (int j = i + 1; j < s; ++j) rank += keys[j] < k;
    order[rank] = i;
    if (first_tile) new_vals[rank] = vals[i];
  }
  __syncthreads();
  // 2. the sorted rows, kChunk at a time: the new state and the shrink
  //    points out, the rows staged; the first group sums them in order
  const float p0 = live ? pts[order[0] * d + col] : 0.0f;
  float acc = 0.0f, worst = 0.0f;
  for (int r0 = 0; r0 < s; r0 += kChunk) {
    const int n = min(kChunk, s - r0);
    if (r0 > 0) __syncthreads();       // the first group read the last chunk
    for (int r = group; r < n; r += kUnroll * kGroups) {
      float x[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int row = r + k * kGroups;
        x[k] = live && row < n ? pts[order[r0 + row] * d + col] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int row = r + k * kGroups;
        if (row < n) {
          tile[row * kLanes + lane] = x[k];
          if (live) {
            new_pts[(r0 + row) * d + col] = x[k];
            if (r0 + row > 0) {
              u[(r0 + row + 3) * d + col] =
                  __fadd_rn(p0, __fmul_rn(__fsub_rn(x[k], p0), sigma));
            }
          }
        }
      }
    }
    __syncthreads();
    if (group == 0) {
      int r = 0;
      if (r0 == 0) {
        acc = tile[lane];
        r = 1;
      }
#pragma unroll 8
      for (; r < n; ++r) acc = __fadd_rn(acc, tile[r * kLanes + lane]);
      if (r0 + n == s) worst = tile[(n - 1) * kLanes + lane];
    }
  }
  // 3. the four trial points
  if (group == 0 && live) {
    const float c = __fmul_rn(acc, inv_s);
    const float refl =
        clamp01(__fadd_rn(c, __fmul_rn(__fsub_rn(c, worst), alpha)));
    const float diff = __fsub_rn(refl, c);
    u[col] = refl;
    u[d + col] = clamp01(__fadd_rn(c, __fmul_rn(diff, gamma)));
    u[2 * d + col] = clamp01(__fadd_rn(c, __fmul_rn(diff, beta)));
    u[3 * d + col] =
        clamp01(__fadd_rn(c, __fmul_rn(__fsub_rn(worst, c), beta)));
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = success).
//
// n instances, each: pts [s, d] float32, vals [s] float32, draws [3, d]
// float32, phase one int32; out u [s + 3, d], new_pts [s, d], new_vals
// [s] float32.  Every tensor contiguous, the instances one after another.
// inv_s: 1 / s as a float32.  Nothing is launched for n = 0 or d = 0.
extern "C" int ut_simplex_propose(
    const void* pts, const void* vals, const void* draws, const void* phase,
    void* u, void* new_pts, void* new_vals, int n, int s, int d, float alpha,
    float gamma, float beta, float sigma, float inv_s, void* stream) {
  if (n < 0 || s < 1 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (n > 65535 || (s + 3LL) * d > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 8LL * s + 4LL * kChunk * kLanes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        simplex_propose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((d + kLanes - 1) / kLanes, n);
  simplex_propose_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(vals),
      static_cast<const float*>(draws), static_cast<const int*>(phase),
      static_cast<float*>(u), static_cast<float*>(new_pts),
      static_cast<float*>(new_vals), s, d, alpha, gamma, beta, sigma, inv_s);
  return static_cast<int>(cudaGetLastError());
}
