// Stable two-run merge of the dedup history, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `uptune_tpu/ops/dedup.py::_merge_kernel`
// (launched at dedup.py:163 through `merge_rows_pallas`).  It computes the
// same function, not the same blocks: the h0-sorted [cap] history and the
// h0-sorted [b] batch are merged, with the new rows at the strictly
// increasing output positions `pos_new` (one searchsorted outside the
// kernel), old rows before new rows on equal h0, truncated at cap.
//
// Design.  The TPU kernel counted new positions <= p and < p per 2048-row
// tile and gathered through one-hot MXU matmuls over 16-bit-split packed
// f32 columns, because the TPU VPU has no gather.  Hopper gathers: one
// thread per output row p; the block loads pos_new into shared memory; a
// binary search gives n_le = #{i : pos_new[i] <= p}; the row is new iff
// n_le > 0 and pos_new[n_le - 1] == p; the thread then copies its row from
// new[n_le - 1] or hist[p - n_le].  Writes of the four columns are
// coalesced; qor is copied as its 32-bit pattern (int32), so inf, -0.0 and
// NaN payloads survive bitwise.  There is no shape gate: any b whose int32
// positions fit in one block's shared memory (232,448 bytes, 58,112 rows)
// is taken; the wrapper raises above that.
//
// Bound.  Memory: each of the cap output rows (h0, h1 int64, qor, age: 24
// bytes) is written once and read once from its one source row, new or
// history; batch rows that land at or past cap are never read; every
// 4-byte position is read.  48 * cap + 4 * b bytes: at cap 2^15 and b 6040
// about 1.60 MB, 0.48 us at 3.35 TB/s — far below a launch, so at the
// engine's sizes the kernel is launch-bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) merge_rows_kernel(
    const int64_t* __restrict__ hist_h0, const int64_t* __restrict__ hist_h1,
    const int32_t* __restrict__ hist_q, const int32_t* __restrict__ hist_age,
    const int64_t* __restrict__ new_h0, const int64_t* __restrict__ new_h1,
    const int32_t* __restrict__ new_q, const int32_t* __restrict__ new_age,
    const int32_t* __restrict__ pos_new, int64_t* __restrict__ out_h0,
    int64_t* __restrict__ out_h1, int32_t* __restrict__ out_q,
    int32_t* __restrict__ out_age, int cap, int b) {
  extern __shared__ int32_t s_pos[];
  for (int i = threadIdx.x; i < b; i += blockDim.x) s_pos[i] = pos_new[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap) return;
  // upper bound: the number of new rows at or before output position p
  int lo = 0, hi = b;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_pos[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int n_le = lo;
  if (n_le > 0 && s_pos[n_le - 1] == p) {
    const int j = n_le - 1;
    out_h0[p] = new_h0[j];
    out_h1[p] = new_h1[j];
    out_q[p] = new_q[j];
    out_age[p] = new_age[j];
  } else {
    const int j = p - n_le;  // 0 <= j < cap: n_le <= p when p is not new
    out_h0[p] = hist_h0[j];
    out_h1[p] = hist_h1[j];
    out_q[p] = hist_q[j];
    out_age[p] = hist_age[j];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ut_merge_rows(const void* hist_h0, const void* hist_h1,
                             const void* hist_q, const void* hist_age,
                             const void* new_h0, const void* new_h1,
                             const void* new_q, const void* new_age,
                             const void* pos_new, void* out_h0, void* out_h1,
                             void* out_q, void* out_age, int cap, int b,
                             void* stream) {
  if (cap <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(b) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (cap + kThreads - 1) / kThreads;
  merge_rows_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(hist_h0),
      static_cast<const int64_t*>(hist_h1),
      static_cast<const int32_t*>(hist_q),
      static_cast<const int32_t*>(hist_age),
      static_cast<const int64_t*>(new_h0),
      static_cast<const int64_t*>(new_h1),
      static_cast<const int32_t*>(new_q),
      static_cast<const int32_t*>(new_age),
      static_cast<const int32_t*>(pos_new), static_cast<int64_t*>(out_h0),
      static_cast<int64_t*>(out_h1), static_cast<int32_t*>(out_q),
      static_cast<int32_t*>(out_age), cap, b);
  return static_cast<int>(cudaGetLastError());
}
