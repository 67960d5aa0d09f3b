// The launch geometry of csrc/gp_tile.cu, on the host alone: tile sizes,
// the scratch plan of launchers B, C and D, which route their krows pass
// takes at a width, and the host-only queries the wrappers read.  It
// includes no CUDA header, so a host compiler builds it by itself (the
// CPU tests build a one-line file that includes it with g++).
#pragma once

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;  // one block's shared memory on Hopper

// B, C and D
constexpr int kTileM = 128;        // query rows of one W tile
constexpr int kTileN = 128;        // K^-1 columns of one W tile
constexpr int kTileK = 32;         // depth of one pipeline stage
constexpr int kKRows = 32;         // query rows of one krows block
constexpr int kSel = 256;          // rows of one first-level selection
constexpr int kMergeSlots = 8192;  // candidates one merge block ranks

// A, and krows on the tensor cores
constexpr int kMeanRows = 64;      // query rows of a block: wgmma's N
constexpr int kMeanChunk = kMeanRows * kTileK;   // a query chunk's plane

// Dynamic shared memory of one krows block on the CUDA cores, in floats,
// for all f features at once.
inline size_t krows_words(int f) {
  return static_cast<size_t>(kKRows) * f +
         static_cast<size_t>(kTileN) * (f | 1) +
         kWarps * (kKRows * kTileN / kThreads);
}

// krows takes f features on the tensor cores when they do not fit one
// block on the CUDA cores (past 361 features); up to there the CUDA-core
// route and its summation order stay.
inline bool krows_on_tensor_cores(int f) {
  return krows_words(f) * sizeof(float) > static_cast<size_t>(kMaxShared);
}

// Where krows on the tensor cores keeps its data, in 4-byte words of
// dynamic shared memory, whatever f: two chunk buffers (chunk c in buffer
// c % 2), each the query rows' and the training rows' TF32 hi and lo
// planes, swizzled as A's; the query and training rows' norms {c, k};
// each warp's partial means of the block's query rows.  About 100 KB, so
// two blocks share an SM.
struct KRowsMmaLayout {
  static constexpr int kMmaBuffers = 2;
  static constexpr int kBlocksPerSM = 2;
  static constexpr size_t qh = 0;
  static constexpr size_t ql = qh + kMeanChunk;
  static constexpr size_t xh = ql + kMeanChunk;
  static constexpr size_t xl = xh + static_cast<size_t>(kTileN) * kTileK;
  static constexpr size_t kBufWords = xl + static_cast<size_t>(kTileN) * kTileK;
  static constexpr size_t nq = kMmaBuffers * kBufWords;
  static constexpr size_t nx = nq + 2 * kMeanRows;
  static constexpr size_t red = nx + 2 * kTileN;
  static constexpr size_t words = red + kWarps * kMeanRows;
};

// Where B, C and D keep their passes' data: offsets into the scratch
// buffer, in 4-byte words (the k and K^-1 blocks 16-byte aligned), and the
// selection's geometry (k = 0 for B and C).  Neither krows route needs a
// word of its own: both write k and the partial means to the same places.
// D ranks `segs` lists of b rows each in one launch (an instance axis):
// the passes run over the segs * b rows as one batch, and the selection
// (n1 first-level lists of k1, groups of them, n2 lists of k2) is each
// segment's own, so the candidates take segs times a segment's words.
struct Plan {
  int np, bp, tn, n1, k1, group, n2, k2, segs;
  size_t mupart, qpart, kscr, khi, klo, cand, words;
};

inline bool make_plan(int b, int n, int var, int k, Plan* p, int segs = 1) {
  if (b <= 0 || n <= 0 || k < 0 || k > b || segs < 1) return false;
  const long long rows = static_cast<long long>(b) * segs;
  const long long np = (static_cast<long long>(n) + kTileN - 1) / kTileN * kTileN;
  const long long bp = (rows + kTileM - 1) / kTileM * kTileM;
  if (np > INT_MAX || bp > INT_MAX) return false;
  p->segs = segs;
  p->np = static_cast<int>(np);
  p->bp = static_cast<int>(bp);
  p->tn = p->np / kTileN;
  p->n1 = (b + kSel - 1) / kSel;
  p->k1 = k < kSel ? k : kSel;
  p->group = p->k1 > 0 ? kMergeSlots / p->k1 : 1;
  p->n2 = (p->n1 + p->group - 1) / p->group;
  p->k2 = k < p->group * p->k1 ? k : p->group * p->k1;
  const size_t part = static_cast<size_t>(p->tn) * p->bp;
  size_t off = 0;
  p->mupart = off;
  off += part;
  p->qpart = off;
  p->kscr = p->khi = p->klo = 0;
  if (var) {
    off += part;
    p->kscr = off;
    off += static_cast<size_t>(p->bp) * p->np;
    p->khi = off;
    off += static_cast<size_t>(p->np) * p->np;
    p->klo = off;
    off += static_cast<size_t>(p->np) * p->np;
  }
  p->cand = off;
  off += 2 * static_cast<size_t>(segs) * p->n1 * p->k1;
  p->words = off;
  return true;
}

}  // namespace

// Plain C interface: host-only queries of the launch geometry, which the
// wrappers read (loaded with ctypes from the launchers' library).

// The largest number of training rows n that A takes with f = fc + fk
// features, however they split: its blocks keep nothing of size n in shared
// memory, so n is not limited (INT_MAX), and any f >= 1 is taken (past 376
// features the query planes hold one chunk at a time); 0 for f < 1.  `var`
// is not used: every limit query takes (f, var).
extern "C" int ut_gp_max_train_rows(int f, int var) {
  (void)var;
  return f > 0 ? INT_MAX : 0;
}

// The same for B, C and D (either kind): their passes keep nothing of size
// n in shared memory either, and past 361 features krows takes them on the
// tensor cores, 32 at a time, so any f >= 1 is taken.
extern "C" int ut_acquire_max_train_rows(int f, int var) {
  (void)var;
  return f > 0 ? INT_MAX : 0;
}

// The route of B's, C's and D's krows pass at f features: 0 on the CUDA
// cores (all f in one block), 1 on the tensor cores; -1 for f < 1.
extern "C" int ut_krows_route(int f) {
  if (f < 1) return -1;
  return krows_on_tensor_cores(f) ? 1 : 0;
}

// Dynamic shared memory of one krows block at f features, in bytes, on
// the route ut_krows_route(f) names; -1 for f < 1.
extern "C" long long ut_krows_shared_bytes(int f) {
  if (f < 1) return -1;
  const size_t words =
      krows_on_tensor_cores(f) ? KRowsMmaLayout::words : krows_words(f);
  return static_cast<long long>(words * sizeof(float));
}

// The 4-byte words of scratch B (var != 0, k = 0, segs = 1), C (k = 0,
// segs = 1) or D (top-k, 1 <= k <= b, over segs segments of b rows each)
// needs for b query rows and n training rows; var != 0 for the variance
// kinds; -1 when the arguments are out of range.
extern "C" long long ut_acquire_scratch_words(int b, int n, int var, int k,
                                              int segs) {
  Plan p;
  if (!make_plan(b, n, var, k, &p, segs)) return -1;
  return static_cast<long long>(p.words);
}

// The candidate slots D writes into vals / idx for b rows and top k: one
// list of min(k, group k1) entries per group of first-level lists (k1 =
// min(k, kSel), group = kMergeSlots / k1), each sorted by (value desc,
// index asc), in index order; -1 out of range.  When this is k, vals /
// idx are the top k.  Over segments each segment writes this many, its
// own, one segment after another.
extern "C" int ut_acquire_topk_slots(int b, int k) {
  Plan p;
  if (k < 1 || !make_plan(b, 1, 0, k, &p)) return -1;
  return p.n2 * p.k2;
}
