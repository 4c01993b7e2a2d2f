// Shared scan machinery of the kernels that turn flags or digits into
// positions (stream_compact.cu, seg_unique.cu, radix_sort.cu).
//
// The Pallas kernels these replace carry a running total across a grid that
// runs in order (the revisited-window idiom of kernels/compact.py and
// kernels/aggregate.py). CUDA blocks run in no fixed order, so a total that
// crosses blocks is carried by a decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016): each block takes the next tile id from a counter, so every earlier
// tile is already running, publishes its tile's sum, and adds up its
// predecessors' published sums (tile_* below; digit_* for many sums a
// tile).
// A thread owns kItems consecutive flags, read as one 16-byte load when the
// flag array is 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// Exclusive scan of one int per thread over a block of Threads threads
// (a multiple of 32, at most 1,024); *total receives the block sum. smem
// holds Threads / 32 + 1 ints. Every thread of the block must call.
template <int Threads = kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem,
                                                    int* total) {
  constexpr int kW = Threads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kW ? smem[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kW) smem[lane] = wi - w;
    if (lane == kW - 1) smem[kW] = wi;
  }
  __syncthreads();
  const int out = smem[warp] + incl - v;
  *total = smem[kW];
  __syncthreads();
  return out;
}

// The kItems flags (0/1 bytes) of this thread at flat positions
// [first, first + kItems), zero past n.
__device__ __forceinline__ void load_flags(const uint8_t* __restrict__ flags,
                                           int64_t n, int64_t first,
                                           bool aligned, uint8_t* out) {
  if (aligned && first + kItems <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(flags + first);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      out[i] = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      out[i] = first + i < n ? flags[first + i] : 0;
  }
}

// The Loads * kItems flags at [first, first + Loads * kItems) as a bit
// mask (bit i set when flag first + i is non-zero), zero past n; the
// Loads 16-byte loads are issued together (Loads <= 2).
template <int Loads>
__device__ __forceinline__ uint32_t load_flag_mask(
    const uint8_t* __restrict__ flags, int64_t n, int64_t first,
    bool aligned) {
  static_assert(Loads * kItems <= 32, "the mask is 32 bits");
  uint8_t f[Loads][kItems];
#pragma unroll
  for (int j = 0; j < Loads; ++j) {
    load_flags(flags, n, first + j * kItems, aligned, f[j]);
  }
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < Loads; ++j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      m |= (uint32_t)(f[j][i] != 0) << (j * kItems + i);
    }
  }
  return m;
}

// -- decoupled look-back ----------------------------------------------------
// A tile's status is one 64-bit word, so that its flag and its value are
// read together: the flag in the high half (0: nothing yet, kTileAggregate:
// the tile's own sum, kTilePrefix: the sum of every tile up to and
// including it), the value in the low half. The words and the tile counter
// start at zero (the caller clears them before the launch).
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

__device__ __forceinline__ void tile_publish(unsigned long long* status,
                                             int64_t tile,
                                             unsigned long long flag,
                                             int value) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(status + tile), "l"(flag | (uint32_t)value)
               : "memory");
}

__device__ __forceinline__ unsigned long long tile_status(
    const unsigned long long* status, int64_t tile) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(status + tile) : "memory");
  return w;
}

// The sum of every tile before `tile`, on every lane of the one warp that
// calls it, after `tile` has published its aggregate. The warp reads 32
// predecessors' words at once, nearest first, waits while any is still
// empty, and adds the aggregates down to the nearest inclusive prefix; with
// none in the window it moves 32 tiles back.
__device__ __forceinline__ int tile_lookback(
    const unsigned long long* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t t = end - lane;
    unsigned long long w;
    do {
      w = t >= 0 ? tile_status(status, t) : kTilePrefix;
    } while (__any_sync(0xffffffffu, (w >> 32) == 0));
    const unsigned prefix = __ballot_sync(0xffffffffu, w >= kTilePrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    excl += (int)__reduce_add_sync(0xffffffffu,
                                   lane <= stop ? (uint32_t)w : 0u);
    if (prefix) return excl;
  }
}

// -- decoupled look-back over many digits a tile (radix_sort.cu) -----------
// A tile publishes one status word per digit, at status[tile * 256 + digit].
// The flag half also carries a tag (the launch that wrote the word), so
// that one memset serves several launches over the same words: a word with
// another tag reads as not yet published.
constexpr int kLookbackDigits = 256;
constexpr unsigned kDigitAggregate = 1u;
constexpr unsigned kDigitPrefix = 2u;

__device__ __forceinline__ void digit_publish(unsigned long long* tile_words,
                                              int digit, unsigned tag,
                                              unsigned kind, int value) {
  tile_publish(tile_words, digit,
               (unsigned long long)((tag << 2) | kind) << 32, value);
}

// The sum of `digit` over every tile before `tile`, in the one thread that
// owns the digit, after `tile` has published its aggregate: it reads the
// words of the Window tiles before the last one it read at once, nearest
// first, waits on a word not yet published under `tag`, and adds the
// aggregates down to the nearest inclusive prefix (tile 0 always publishes
// one; tiles before it read as a prefix of 0).
template <int Window>
__device__ __forceinline__ int digit_lookback(
    const unsigned long long* status, int64_t tile, int digit, unsigned tag) {
  const unsigned long long none = (unsigned long long)((tag << 2) |
                                                       kDigitPrefix) << 32;
  int excl = 0;
  for (int64_t end = tile - 1;; end -= Window) {
    unsigned long long w[Window];
#pragma unroll
    for (int k = 0; k < Window; ++k) {
      w[k] = end - k >= 0
                 ? tile_status(status, (end - k) * kLookbackDigits + digit)
                 : none;
    }
#pragma unroll
    for (int k = 0; k < Window; ++k) {
      while ((unsigned)(w[k] >> 34) != tag) {
        w[k] = tile_status(status, (end - k) * kLookbackDigits + digit);
      }
      excl += (int)(uint32_t)w[k];
      if ((unsigned)(w[k] >> 32 & 3u) == kDigitPrefix) return excl;
    }
  }
}

}  // namespace repro
