// The port's counter-based draws, one pass a block, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws with `jax.random`, and the
// port draws from its own counter hash (`uptune_tpu_torch/rng.py`).  There
// the hash of a block of count elements was some 26 elementwise passes
// over int64 tensors (an arange, the affine step, masks, two mixes of ten
// ops each, an xor with the key), then a shift, a cast and a scale: about
// 444 bytes of device traffic an element.  This kernel computes the same
// words in one pass and writes only what the caller keeps.
//
// The function.  For key row r (two 32-bit words k0, k1 held in int64) and
// element i < count of a block that starts at element `start`:
//   j    = start + i
//   word = mix(mix(j * kStep + k0 + domain) ^ k1)      (mod 2^32)
// with mix the bijection of rng.py's `_mix`.  rng.py computes it in int64
// with every product masked to its low 32 bits; here the arithmetic is
// uint32 with wrapping multiplies, which is bit for bit the same, since the
// low 32 bits of a sum or a product depend only on the low 32 bits of its
// operands (so `start` is passed as its low 32 bits too).
//
// Two modes.  Draw (uniforms and integers, `Stream`'s blocks): the top 24
// bits of the word as int64 and, from the same register, those bits times
// 2^-24 as float32 (exact, as rng.py's cast and scale are).  Split (keys):
// the whole 32-bit word as int64.
//
// Design.  The output is the row-major [rows, count] block, seen flat: a
// thread takes kVec = 4 consecutive elements, finds the row of the first
// one (one division, none for one key row) and steps along, so that each
// store is a 16-byte vector (two longlong2 of words, one float4 of
// uniforms); the rest of rows * count after the last full vector goes to
// the first threads of block 0, one element each.  A grid-stride loop over
// the vectors, no shared memory, no scratch, no atomics; a thread reads
// the key row of its vector (and the next one, where the vector runs on
// into it) from the cache.  The wrapper allocates the outputs (16-byte
// aligned, as the caching allocator gives them).
//
// Bound.  Memory: 12 bytes written an element in draw mode (8 in split
// mode), the keys' 16 bytes a row read once.  At the gcc-options proposal's
// block of 8,616,696 elements 103.4 MB, 30.9 us at 3.35 TB/s.  The integer
// work is about 20 32-bit operations an element (five of them multiplies)
// and one conversion: below the memory time at the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x7FEB352Du;    // rng.py's _M1
constexpr uint32_t kM2 = 0x5BD1E995u;    // rng.py's _M2
constexpr uint32_t kStep = 0x61C88647u;  // rng.py's _STEP
constexpr int kThreads = 256;
constexpr int kVec = 4;                  // elements a thread stores at once
constexpr long long kMaxBlocks = 132 * 8;  // 8 blocks an SM of the H100

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  return x ^ (x >> 16);
}

// The word of element j of a key (k0, k1).
__device__ __forceinline__ uint32_t word_of(uint32_t k0, uint32_t k1,
                                            uint32_t j, uint32_t domain) {
  return mix(mix(j * kStep + k0 + domain) ^ k1);
}

template <bool kDraw>
__device__ __forceinline__ void store_one(int64_t* __restrict__ words,
                                          float* __restrict__ floats,
                                          long long e, uint32_t w) {
  if (kDraw) {
    const uint32_t top = w >> 8;
    words[e] = top;
    floats[e] = __uint2float_rn(top) * 0x1p-24f;
  } else {
    words[e] = w;
  }
}

template <bool kDraw>
__global__ void __launch_bounds__(kThreads) rng_block_kernel(
    const int64_t* __restrict__ keys, int64_t* __restrict__ words,
    float* __restrict__ floats, long long rows, long long count,
    uint32_t start, uint32_t domain) {
  const long long total = rows * count;
  const long long n_vec = total / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       v < n_vec; v += stride) {
    const long long e0 = v * kVec;
    long long r = rows == 1 ? 0 : e0 / count;
    long long i = e0 - r * count;
    uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
    uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
    uint32_t w[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      if (i == count) {  // the vector runs on into the next key row
        ++r;
        i = 0;
        k0 = static_cast<uint32_t>(keys[2 * r]);
        k1 = static_cast<uint32_t>(keys[2 * r + 1]);
      }
      w[q] = word_of(k0, k1, start + static_cast<uint32_t>(i), domain);
      ++i;
    }
    longlong2* wv = reinterpret_cast<longlong2*>(words) + 2 * v;
    if (kDraw) {
#pragma unroll
      for (int q = 0; q < kVec; ++q) w[q] >>= 8;
      wv[0] = make_longlong2(w[0], w[1]);
      wv[1] = make_longlong2(w[2], w[3]);
      reinterpret_cast<float4*>(floats)[v] = make_float4(
          __uint2float_rn(w[0]) * 0x1p-24f, __uint2float_rn(w[1]) * 0x1p-24f,
          __uint2float_rn(w[2]) * 0x1p-24f, __uint2float_rn(w[3]) * 0x1p-24f);
    } else {
      wv[0] = make_longlong2(w[0], w[1]);
      wv[1] = make_longlong2(w[2], w[3]);
    }
  }
  // the last total % kVec elements
  const long long e = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && e < total) {
    const long long r = rows == 1 ? 0 : e / count;
    const long long i = e - r * count;
    store_one<kDraw>(words, floats, e,
                     word_of(static_cast<uint32_t>(keys[2 * r]),
                             static_cast<uint32_t>(keys[2 * r + 1]),
                             start + static_cast<uint32_t>(i), domain));
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = success).
//
// keys: [rows, 2] int64, contiguous; words: [rows, count] int64; floats:
// [rows, count] float32 for a draw block (the 24-bit words and their
// uniforms), or null for a split block (the whole words).  words and
// floats 16-byte aligned.  start: the block's first element, its low 32
// bits.  Nothing is launched for an empty block.
extern "C" int ut_rng_block(const void* keys, void* words, void* floats,
                            long long rows, long long count,
                            unsigned int start, unsigned int domain,
                            void* stream) {
  if (rows < 0 || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * count;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long n_vec = total / kVec;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int64_t*>(keys);
  const auto w = static_cast<int64_t*>(words);
  if (floats != nullptr) {
    rng_block_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        k, w, static_cast<float*>(floats), rows, count, start, domain);
  } else {
    rng_block_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        k, w, nullptr, rows, count, start, domain);
  }
  return static_cast<int>(cudaGetLastError());
}
