// Fused GP scoring and acquisition tiles, for Hopper (sm_90a).
//
// One templated tile routine and four launchers.  They replace the eight
// Pallas TPU kernels of the surrogate and acquisition path:
//   A  ut_gp_mean        uptune_tpu/surrogate/pallas_score.py:66
//                        _score_kernel, :77 _score_kernel_mixed, :89
//                        _score_kernel_expham              -> mu_n [B]
//   B  ut_gp_mean_var    pallas_score.py:107 _var_kernel, :112
//                        _var_kernel_mixed, :119 _var_kernel_expham
//                                                          -> mu_n, q [B]
//   C  ut_acquire_scores uptune_tpu/ops/acquire.py:151 _scores_kernel
//                                             -> EI / -LCB / -mean [B]
//   D  ut_acquire_topk   acquire.py:157 _topk_kernel -> per-chunk top-k
// The TPU's `_expham`/`_mixed` variants exist only because a zero-width
// block does not lower through Mosaic; here the compile-time flags kCont
// and kCat cover them.
//
// The tile function (the JAX `_utility_tile`): for query row r and
// training row n,
//   k[r, n] = matern52(|qc_r - xc_n|^2) * exp(-|qk_r - xk_n|^2)
// (the continuous block pre-scaled by 1/ls, the one-hot block by
// sqrt(1/(n_cat ls_cat)), alpha and K^-1 premasked by the caller), then
//   mu_n[r] = sum_n k[r, n] alpha[n]
//   q[r]    = sum_n k[r, n] (sum_m k[r, m] Kinv[m, n])
// and one epilogue.  Distances sum (a - b)^2 directly, which is more
// exact than the |a|^2 + |b|^2 - 2ab identity the plain version follows.
//
// Design.  A block of kThreads threads holds kRows query rows.  Phase 1:
// each thread takes training rows n = tid, tid + kThreads, ...; for each
// it accumulates the kRows distances (the query rows sit in shared
// memory and are read as broadcasts), forms k, adds k * alpha[n] to its
// kRows partial means and, for the variance kinds, stores k in the
// block's [kRows, N] shared tile (64 KB at N = 1024; dynamic shared
// memory above 48 KB).  Phase 2 (variance kinds): K^-1 streams through
// the block once, in passes of kThreads * kCols columns; each thread
// keeps kRows x kCols accumulators of w = k K^-1 in registers, reads
// K^-1 rows coalesced and the k tile as float4 broadcasts (16 FMAs per
// shared load), and folds w * k into its partial q.  Per-row sums reduce
// over warps (shuffles) and then over the block, in a fixed order, so a
// row's result does not depend on where it sits: duplicated query rows
// tie exactly.  Launcher D writes the utilities to a scratch vector, then
// a selection kernel sorts each 1024-row chunk by (value desc, index asc)
// with a bitonic network in shared memory and writes its first ksel
// entries; the wrapper merges the chunks with one stable sort.
//
// Bound (B = 6040 queries, N = 1024, F = 31).  The variance kinds do
// 2BN^2 FLOP for k K^-1 (12.7 GFLOP) against about 5 MB of input: bound
// by the f32 (non-tensor-core) rate, 67 TFLOP/s, about 0.195 ms.  The
// design keeps the [B, N] products out of device memory, but every block
// re-reads K^-1 (4 MB) from L2 and the FMAs run on CUDA cores, not
// tensor cores; a tensor-core (TF32 or 3xTF32) redesign is later work.
// The mean kinds do 2BNF FLOP (0.4 GFLOP, about 6 us at that rate).
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 16;          // query rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;           // K^-1 columns per thread per pass
constexpr int kChunk = 1024;       // rows per top-k selection block
constexpr int kSelThreads = 512;
constexpr int kMaxShared = 232448;  // one block's shared memory on Hopper
constexpr int kMaxDevices = 64;

enum Epilogue { kStoreMean = 0, kStoreMeanQ = 1, kUtility = 2 };
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

// Sum every row's per-thread partials over the block; thread t < kRows
// gets row t's total.  `red` holds kWarps * kRows floats.
__device__ __forceinline__ float block_sum(const float (&part)[kRows],
                                           float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const float v = warp_sum(part[t]);
    if (lane == 0) red[warp * kRows + t] = v;
  }
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x < kRows) {
    for (int w = 0; w < kWarps; ++w) tot += red[w * kRows + threadIdx.x];
  }
  return tot;
}

// params: noise, y_mean, y_std, best_y, beta (the JAX (1, 8) scalar pack)
template <bool kCont, bool kCat, bool kVar, int kEpi>
__global__ void __launch_bounds__(kThreads) gp_tile_kernel(
    const float* __restrict__ qc, const float* __restrict__ qk,
    const float* __restrict__ xc, const float* __restrict__ xk,
    const float* __restrict__ alpha, const float* __restrict__ kinv,
    const float* __restrict__ params, float* __restrict__ out0,
    float* __restrict__ out1, int b, int n, int fc, int fk, int kind) {
  extern __shared__ __align__(16) float smem[];
  const int f = fc + fk;
  const int np = (n + 3) & ~3;
  float* s_q = smem;                        // [kRows][f]
  float* s_red = s_q + kRows * f;           // [2][kWarps][kRows]
  float* s_k = s_red + 2 * kWarps * kRows;  // [kRows][np], 16-byte aligned
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * f; i += kThreads) {
    const int t = i / f, j = i - t * f, r = row0 + t;
    float v = 0.f;
    if (r < b) {
      v = (j < fc) ? qc[static_cast<size_t>(r) * fc + j]
                   : qk[static_cast<size_t>(r) * fk + (j - fc)];
    }
    s_q[i] = v;
  }
  if (kVar) {
    const int pad = np - n;
    for (int i = threadIdx.x; i < kRows * pad; i += kThreads) {
      s_k[(i / pad) * np + n + i % pad] = 0.f;
    }
  }
  __syncthreads();

  // phase 1: the kernel rows, the partial means
  float mu_part[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) mu_part[t] = 0.f;
  for (int col = threadIdx.x; col < n; col += kThreads) {
    float dc[kRows], dk[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) dc[t] = dk[t] = 0.f;
    if (kCont) {
      const float* xr = xc + static_cast<size_t>(col) * fc;
      for (int j = 0; j < fc; ++j) {
        const float xv = xr[j];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const float d = s_q[t * f + j] - xv;
          dc[t] = fmaf(d, d, dc[t]);
        }
      }
    }
    if (kCat) {
      const float* xr = xk + static_cast<size_t>(col) * fk;
      for (int j = 0; j < fk; ++j) {
        const float xv = xr[j];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const float d = s_q[t * f + fc + j] - xv;
          dk[t] = fmaf(d, d, dk[t]);
        }
      }
    }
    const float a = alpha[col];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      float k;
      if (kCont) {
        k = matern52(dc[t]);
        if (kCat) k *= expf(-dk[t]);
      } else {
        k = expf(-dk[t]);
      }
      mu_part[t] = fmaf(k, a, mu_part[t]);
      if (kVar) s_k[t * np + col] = k;
    }
  }
  const float mu_n = block_sum(mu_part, s_red);  // syncs: s_k is complete

  // phase 2: q = rowsum((k K^-1) * k), K^-1 streamed in column passes
  float q_tot = 0.f;
  if (kVar) {
    float q_part[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) q_part[t] = 0.f;
    for (int c0 = 0; c0 < n; c0 += kThreads * kCols) {
      int cols[kCols];
      bool ok[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        cols[c] = c0 + threadIdx.x + c * kThreads;
        ok[c] = cols[c] < n;
      }
      float acc[kRows][kCols];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;
      }
      for (int m = 0; m < np; m += 4) {
        float kv[4][kCols];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            kv[r][c] = (ok[c] && m + r < n)
                           ? kinv[static_cast<size_t>(m + r) * n + cols[c]]
                           : 0.f;
          }
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const float4 kt = *reinterpret_cast<const float4*>(s_k + t * np + m);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[t][c] = fmaf(kt.x, kv[0][c], acc[t][c]);
            acc[t][c] = fmaf(kt.y, kv[1][c], acc[t][c]);
            acc[t][c] = fmaf(kt.z, kv[2][c], acc[t][c]);
            acc[t][c] = fmaf(kt.w, kv[3][c], acc[t][c]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (ok[c]) {
            q_part[t] = fmaf(acc[t][c], s_k[t * np + cols[c]], q_part[t]);
          }
        }
      }
    }
    q_tot = block_sum(q_part, s_red + kWarps * kRows);
  }

  const int r = row0 + threadIdx.x;
  if (threadIdx.x >= kRows || r >= b) return;
  if (kEpi == kStoreMean) {
    out0[r] = mu_n;
  } else if (kEpi == kStoreMeanQ) {
    out0[r] = mu_n;
    out1[r] = q_tot;
  } else {
    const float noise = params[0], y_mean = params[1], y_std = params[2];
    const float best_y = params[3], beta = params[4];
    const float mu = mu_n * y_std + y_mean;
    float u = -mu;
    if (kind != kKindMean) {
      const float sd = sqrtf(fmaxf(1.0f + noise - q_tot, 1e-9f)) * y_std;
      if (kind == kKindEI) {
        const float s = fmaxf(sd, 1e-9f);
        const float z = (best_y - mu) / s;
        const float pdf = expf(-0.5f * z * z) / 2.5066282746310002f;
        const float cdf = 0.5f * (1.0f + erff(z / 1.4142135623730951f));
        u = (best_y - mu) * cdf + s * pdf;
      } else {
        u = -(mu - beta * sd);
      }
    }
    out0[r] = u;
  }
}

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sort one chunk of kChunk utilities by (value desc, index asc) and write
// its first ksel entries; rows past b enter as (-inf, index).
__global__ void __launch_bounds__(kSelThreads) topk_select_kernel(
    const float* __restrict__ u, int b, int ksel, float* __restrict__ vals,
    int32_t* __restrict__ idx) {
  __shared__ float sv[kChunk];
  __shared__ int si[kChunk];
  const int base = blockIdx.x * kChunk;
  for (int i = threadIdx.x; i < kChunk; i += kSelThreads) {
    const int g = base + i;
    sv[i] = g < b ? u[g] : __int_as_float(0xff800000);
    si[i] = g;
  }
  __syncthreads();
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kChunk; i += kSelThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const float vi = sv[i], vj = sv[j];
          const int ii = si[i], ij = si[j];
          const bool swap = ((i & size) == 0) ? before(vj, ij, vi, ii)
                                              : before(vi, ii, vj, ij);
          if (swap) {
            sv[i] = vj;
            sv[j] = vi;
            si[i] = ij;
            si[j] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < ksel; r += kSelThreads) {
    vals[static_cast<size_t>(blockIdx.x) * ksel + r] = sv[r];
    idx[static_cast<size_t>(blockIdx.x) * ksel + r] = si[r];
  }
}

// Dynamic shared memory of one block, in floats: the query rows, the
// per-warp reduction scratch and, for the variance kinds, the [kRows, N]
// kernel rows (N rounded up to 4).
size_t shared_words(int n, int f, bool var) {
  const size_t np = static_cast<size_t>((n + 3) & ~3);
  return static_cast<size_t>(kRows) * f + 2 * kWarps * kRows +
         (var ? kRows * np : 0);
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

struct Args {
  const float *qc, *qk, *xc, *xk, *alpha, *kinv, *params;
  float *out0, *out1;
  int b, n, fc, fk, kind;
};

template <bool kCont, bool kCat, bool kVar, int kEpi>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  auto kern = gp_tile_kernel<kCont, kCat, kVar, kEpi>;
  static std::atomic<bool> shared_allowed[kMaxDevices];
  const size_t smem = shared_words(a.n, a.fc + a.fk, kVar) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxShared)) return cudaErrorInvalidValue;
  const cudaError_t attr = allow_shared(kern, shared_allowed);
  if (attr != cudaSuccess) return attr;
  const int blocks = (a.b + kRows - 1) / kRows;
  kern<<<blocks, kThreads, smem, stream>>>(a.qc, a.qk, a.xc, a.xk, a.alpha,
                                           a.kinv, a.params, a.out0, a.out1,
                                           a.b, a.n, a.fc, a.fk, a.kind);
  return cudaGetLastError();
}

template <bool kVar, int kEpi>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.b <= 0 || a.n <= 0) return cudaErrorInvalidValue;
  if (a.fc > 0 && a.fk > 0) return launch_tile<true, true, kVar, kEpi>(a, stream);
  if (a.fc > 0) return launch_tile<true, false, kVar, kEpi>(a, stream);
  if (a.fk > 0) return launch_tile<false, true, kVar, kEpi>(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t utilities(const Args& a, cudaStream_t stream) {
  if (a.kind == kKindMean) return dispatch<false, kUtility>(a, stream);
  if (a.kind == kKindEI || a.kind == kKindLCB) {
    return dispatch<true, kUtility>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes): two host-only queries of the
// launch geometry, which the wrappers read, then the four launchers.
// The geometry lives here alone.  Every launcher enqueues on
// `stream`, allocates nothing, and returns the cudaError_t of its launch
// (0 = success).  qc/xc (or qk/xk) are null when fc (or fk) is 0.

// The largest number of training rows n a call with f = fc + fk features
// takes (one block's shared memory); var != 0 for launcher B and the
// variance kinds of C and D.  INT_MAX when n is not limited.
extern "C" int ut_gp_max_train_rows(int f, int var) {
  const size_t cap = kMaxShared / sizeof(float);
  const size_t fixed = shared_words(0, f, false);
  if (f < 0 || fixed > cap) return 0;
  if (!var) return INT_MAX;
  return static_cast<int>((cap - fixed) / kRows) & ~3;
}

// Rows per selection block of launcher D: ksel is at most this, and D
// writes ceil(b / chunk) * ksel candidates.
extern "C" int ut_gp_topk_chunk() { return kChunk; }

// A: mu_n [b] = k . alpha
extern "C" int ut_gp_mean(const void* qc, const void* qk, const void* xc,
                          const void* xk, const void* alpha, void* mu, int b,
                          int n, int fc, int fk, void* stream) {
  const Args a{static_cast<const float*>(qc), static_cast<const float*>(qk),
               static_cast<const float*>(xc), static_cast<const float*>(xk),
               static_cast<const float*>(alpha), nullptr, nullptr,
               static_cast<float*>(mu), nullptr, b, n, fc, fk, kKindMean};
  return static_cast<int>(
      dispatch<false, kStoreMean>(a, static_cast<cudaStream_t>(stream)));
}

// B: mu_n [b] and q [b] = rowsum((k K^-1) * k)
extern "C" int ut_gp_mean_var(const void* qc, const void* qk, const void* xc,
                              const void* xk, const void* alpha,
                              const void* kinv, void* mu, void* q, int b,
                              int n, int fc, int fk, void* stream) {
  const Args a{static_cast<const float*>(qc), static_cast<const float*>(qk),
               static_cast<const float*>(xc), static_cast<const float*>(xk),
               static_cast<const float*>(alpha),
               static_cast<const float*>(kinv), nullptr,
               static_cast<float*>(mu), static_cast<float*>(q), b, n, fc, fk,
               kKindMean};
  return static_cast<int>(
      dispatch<true, kStoreMeanQ>(a, static_cast<cudaStream_t>(stream)));
}

// C: utilities [b] (kind 0 -mean, 1 EI, 2 -LCB); params [5] on the device
extern "C" int ut_acquire_scores(const void* qc, const void* qk,
                                 const void* xc, const void* xk,
                                 const void* alpha, const void* kinv,
                                 const void* params, void* u, int b, int n,
                                 int fc, int fk, int kind, void* stream) {
  const Args a{static_cast<const float*>(qc), static_cast<const float*>(qk),
               static_cast<const float*>(xc), static_cast<const float*>(xk),
               static_cast<const float*>(alpha),
               static_cast<const float*>(kinv),
               static_cast<const float*>(params), static_cast<float*>(u),
               nullptr, b, n, fc, fk, kind};
  return static_cast<int>(utilities(a, static_cast<cudaStream_t>(stream)));
}

// D: the utilities into `u` [b] (scratch), then per 1024-row chunk its
// ksel best (value desc, index asc) into vals / idx [ceil(b/1024) * ksel]
extern "C" int ut_acquire_topk(const void* qc, const void* qk, const void* xc,
                               const void* xk, const void* alpha,
                               const void* kinv, const void* params, void* u,
                               void* vals, void* idx, int b, int n, int fc,
                               int fk, int kind, int ksel, void* stream) {
  if (ksel < 1 || ksel > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(qc), static_cast<const float*>(qk),
               static_cast<const float*>(xc), static_cast<const float*>(xk),
               static_cast<const float*>(alpha),
               static_cast<const float*>(kinv),
               static_cast<const float*>(params), static_cast<float*>(u),
               nullptr, b, n, fc, fk, kind};
  const cudaError_t err = utilities(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (b + kChunk - 1) / kChunk;
  topk_select_kernel<<<chunks, kSelThreads, 0, s>>>(
      static_cast<const float*>(u), b, ksel, static_cast<float*>(vals),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
