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
// f32 columns, because the TPU VPU has no gather.  Hopper gathers, so the
// kernel is a chain of dependent loads, and the design keeps that chain
// short.  A block of R threads writes the R output rows [p0, p0 + R), one
// a thread.  Since `pos_new` is strictly increasing, at most R of its
// entries fall in that range, and they are contiguous:
//   1. one warp finds lo = #{i : pos_new[i] < p0} by a multiway search in
//      global memory: each round its lanes probe 32 * kProbes evenly
//      spaced entries of the range at once and ballots pick the sub-range
//      (two rounds up to b = 16,384; a binary search takes 13 dependent
//      steps at b = 6040);
//   2. thread t loads pos_new[lo + t] and, when it lies below p0 + R,
//      marks it in a shared array: slot[pos_new[lo + t] - p0] = lo + t + 1;
//   3. output row p is new iff its slot is set, and then its source is
//      new row slot - 1; otherwise its source is history row p - n_le(p),
//      n_le(p) = lo + the set slots before p in the block (a ballot and a
//      popc within the warp, plus the earlier warps' totals);
//   4. the thread copies its row: the four columns' stores are coalesced;
//      qor is copied as its 32-bit pattern (int32), so inf, -0.0 and NaN
//      payloads survive bitwise.
// No block reads more of `pos_new` than the probes and its own R entries,
// shared memory is R + a few words, static, and no size of b is special:
// any b is taken (b = 0 copies the history).  New rows that land at or
// past cap are never read.
//
// Instances.  The batched engine keeps n histories ([n, cap] columns) and
// merges n batches ([n, b] columns and positions) in one launch: one grid
// of n x ceil(cap / R) blocks, instance-major, where block x works on
// instance x / ceil(cap / R) with its columns offset by instance * cap
// and instance * b.  Nothing is shared between instances, so each
// instance's rows are those of a launch of its own; one history is n = 1.
//
// Bound.  Memory: each of the cap output rows (h0, h1 int64, qor, age: 24
// bytes) is written once and read once from its one source row, new or
// history; every 4-byte position counts as read once.  48 * cap + 4 * b
// bytes an instance: at cap 2^15 and b 6040 about 1.60 MB, 0.48 us at 3.35
// TB/s — less than any single launch takes; for n instances n times that
// (at n 256, cap 2^11, b 114 about 25.3 MB, 7.5 us), in one launch.
// `ut_merge_launch_floor` launches a kernel of the same grid that returns
// at once, so that a measurement can say how much of the kernel's time is
// the launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 128;  // R of the merge itself (ut_merge_rows)
constexpr int kProbes = 4;          // entries a lane probes in one round

struct Rows {
  const int64_t *h0, *h1;
  const int32_t *q, *age;
};

struct OutRows {
  int64_t *h0, *h1;
  int32_t *q, *age;
};

// #{i < b : pos[i] < p0} for strictly increasing pos, by the whole warp:
// the answer lies in [lo, hi]; a round probes the entries lo + (w + 1)
// step - 1, w < 32 kProbes, counts those below p0 (a prefix of them) and
// keeps the one gap of step - 1 entries the answer can still lie in; with
// step = 1 the count ends the search.
__device__ __forceinline__ int warp_lower_bound(
    const int32_t* __restrict__ pos, int b, int p0) {
  constexpr int kWays = 32 * kProbes;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = b;
  while (lo < hi) {
    const int n = hi - lo;
    const int step = n / kWays + (n % kWays != 0);
    bool below[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      const long long i =
          lo + static_cast<long long>(j * 32 + lane + 1) * step - 1;
      below[j] = i < hi && pos[i] < p0;
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      cnt += __popc(__ballot_sync(0xffffffffu, below[j]));
    }
    // every entry up to probe cnt - 1 is below p0; probe cnt, if there is
    // one, is not
    const long long next = lo + static_cast<long long>(cnt + 1) * step - 1;
    lo += cnt * step;
    if (next < hi) hi = static_cast<int>(next);
  }
  return lo;
}

// The columns of one instance: each of `rows` moved on by `off` entries.
__device__ __forceinline__ Rows instance_rows(Rows rows, size_t off) {
  return Rows{rows.h0 + off, rows.h1 + off, rows.q + off, rows.age + off};
}

template <int kR>
__global__ void __launch_bounds__(kR) merge_rows_kernel(
    Rows hist_all, Rows add_all, const int32_t* __restrict__ pos_all,
    OutRows out_all, int cap, int b, int blocks_per_instance) {
  __shared__ int32_t s_slot[kR];
  __shared__ int32_t s_sets[kR / 32];
  __shared__ int32_t s_lo;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int inst = blockIdx.x / blocks_per_instance;
  const int p0 = (blockIdx.x - inst * blocks_per_instance) * kR;
  const size_t hoff = static_cast<size_t>(inst) * cap;
  const size_t boff = static_cast<size_t>(inst) * b;
  const Rows hist = instance_rows(hist_all, hoff);
  const Rows add = instance_rows(add_all, boff);
  const int32_t* __restrict__ pos_new = pos_all + boff;
  const OutRows out{out_all.h0 + hoff, out_all.h1 + hoff, out_all.q + hoff,
                    out_all.age + hoff};
  s_slot[t] = 0;
  if (warp == 0) {
    const int found = warp_lower_bound(pos_new, b, p0);
    if (lane == 0) s_lo = found;
  }
  __syncthreads();
  const int lo = s_lo;
  if (t < b - lo) {
    // at >= 0, since lo is the lower bound; positions that do not
    // increase must not write outside the slots
    const int at = pos_new[lo + t] - p0;
    if (static_cast<unsigned>(at) < static_cast<unsigned>(kR)) {
      s_slot[at] = lo + t + 1;
    }
  }
  __syncthreads();

  const int p = p0 + t;
  const int mark = s_slot[t];
  int64_t h0 = 0, h1 = 0;
  int32_t q = 0, age = 0;
  if (mark != 0 && p < cap) {
    const int j = mark - 1;
    h0 = add.h0[j];
    h1 = add.h1[j];
    q = add.q[j];
    age = add.age[j];
  }
  const unsigned sets = __ballot_sync(0xffffffffu, mark != 0);
  if (lane == 0) s_sets[warp] = __popc(sets);
  __syncthreads();
  if (p >= cap) return;
  if (mark == 0) {
    int n_le = lo + __popc(sets & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) n_le += s_sets[w];
    const int j = p - n_le;  // 0 <= j < cap: n_le <= p when p is not new
    h0 = hist.h0[j];
    h1 = hist.h1[j];
    q = hist.q[j];
    age = hist.age[j];
  }
  out.h0[p] = h0;
  out.h1[p] = h1;
  out.q[p] = q;
  out.age[p] = age;
}

__global__ void launch_floor_kernel() {}

struct Merge {
  Rows hist, add;
  const int32_t* pos_new;
  OutRows out;
  int n, cap, b;
};

// The grid of n instances of cap rows, R a block: n x ceil(cap / R)
// blocks, or 0 when that does not fit a grid's x dimension.
long long grid_blocks(int n, int cap, int rows) {
  const long long blocks =
      static_cast<long long>(n) * ((cap + rows - 1) / rows);
  return blocks <= 0x7fffffffLL ? blocks : 0;
}

template <int kR>
cudaError_t launch(const Merge& m, cudaStream_t stream) {
  const long long blocks = grid_blocks(m.n, m.cap, kR);
  if (blocks == 0) return cudaErrorInvalidValue;
  merge_rows_kernel<kR><<<static_cast<unsigned>(blocks), kR, 0, stream>>>(
      m.hist, m.add, m.pos_new, m.out, m.cap, m.b, (m.cap + kR - 1) / kR);
  return cudaGetLastError();
}

// The merge with R = rows (0: kRowsPerBlock); only 128, 256 and 512 are
// instantiated.
cudaError_t merge(const Merge& m, int rows, cudaStream_t stream) {
  if (m.n < 0 || m.b < 0) return cudaErrorInvalidValue;
  if (m.cap <= 0 || m.n == 0) return cudaSuccess;
  switch (rows == 0 ? kRowsPerBlock : rows) {
    case 128: return launch<128>(m, stream);
    case 256: return launch<256>(m, stream);
    case 512: return launch<512>(m, stream);
    default: return cudaErrorInvalidValue;
  }
}

Rows rows_of(const void* h0, const void* h1, const void* q, const void* age) {
  return Rows{static_cast<const int64_t*>(h0), static_cast<const int64_t*>(h1),
              static_cast<const int32_t*>(q), static_cast<const int32_t*>(age)};
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function launches on
// `stream`, allocates nothing and returns cudaGetLastError() after the
// launch (0 = success).

// The merge of n instances: columns [n, cap] (history, output) and [n, b]
// (batch, positions), row-major; rows_per_block is R, 0 for the one the
// port uses (ut_merge_rows).  The other values are there to be measured
// against it.
extern "C" int ut_merge_rows_with(const void* hist_h0, const void* hist_h1,
                                  const void* hist_q, const void* hist_age,
                                  const void* new_h0, const void* new_h1,
                                  const void* new_q, const void* new_age,
                                  const void* pos_new, void* out_h0,
                                  void* out_h1, void* out_q, void* out_age,
                                  int n, int cap, int b, int rows_per_block,
                                  void* stream) {
  const Merge m{rows_of(hist_h0, hist_h1, hist_q, hist_age),
                rows_of(new_h0, new_h1, new_q, new_age),
                static_cast<const int32_t*>(pos_new),
                OutRows{static_cast<int64_t*>(out_h0),
                        static_cast<int64_t*>(out_h1),
                        static_cast<int32_t*>(out_q),
                        static_cast<int32_t*>(out_age)},
                n, cap, b};
  return static_cast<int>(
      merge(m, rows_per_block, static_cast<cudaStream_t>(stream)));
}

extern "C" int ut_merge_rows(const void* hist_h0, const void* hist_h1,
                             const void* hist_q, const void* hist_age,
                             const void* new_h0, const void* new_h1,
                             const void* new_q, const void* new_age,
                             const void* pos_new, void* out_h0, void* out_h1,
                             void* out_q, void* out_age, int n, int cap,
                             int b, void* stream) {
  return ut_merge_rows_with(hist_h0, hist_h1, hist_q, hist_age, new_h0, new_h1,
                            new_q, new_age, pos_new, out_h0, out_h1, out_q,
                            out_age, n, cap, b, 0, stream);
}

// R of ut_merge_rows.
extern "C" int ut_merge_rows_per_block() { return kRowsPerBlock; }

// A kernel of the merge's grid (n instances of cap rows, rows_per_block a
// block, 0 for the port's) that returns at once: the least a launch of
// that grid takes.  For measurements only.
extern "C" int ut_merge_launch_floor(int n, int cap, int rows_per_block,
                                     void* stream) {
  const int rows = rows_per_block == 0 ? kRowsPerBlock : rows_per_block;
  if (n <= 0 || cap <= 0 || rows <= 0 || rows > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = grid_blocks(n, cap, rows);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  launch_floor_kernel<<<static_cast<unsigned>(blocks), rows, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
