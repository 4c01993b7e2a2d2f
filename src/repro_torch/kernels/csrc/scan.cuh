// Shared block-scan machinery of the two scan kernels (stream_compact.cu,
// seg_unique.cu).
//
// The Pallas kernels these replace carry a running total across a grid that
// runs in order (the revisited-window idiom of kernels/compact.py and
// kernels/aggregate.py). CUDA blocks run in no fixed order, so both kernels
// here are three launches over tiles of kTile flags:
//   1. count:   each block counts the set flags of its tile;
//   2. offsets: one block turns the tile counts into exclusive offsets in
//               place and writes the grand total (the unclamped count);
//   3. scatter: each block rescans its tile from its offset and writes.
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

// Exclusive scan of one int per thread over the block; *total receives the
// block sum. smem holds kWarps + 1 ints. Every thread of the block must call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? smem[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kWarps) smem[lane] = wi - w;
    if (lane == kWarps - 1) smem[kWarps] = wi;
  }
  __syncthreads();
  const int out = smem[warp] + incl - v;
  *total = smem[kWarps];
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

// Pass 2: one block turns tile counts into exclusive offsets (in place) and
// writes the grand total to *total. Static: each including file gets its own.
static __global__ void tile_offsets_kernel(int* __restrict__ tiles, int64_t n_tiles,
                                    int* __restrict__ total) {
  __shared__ int smem[kWarps + 1];
  int carry = 0;
  for (int64_t base = 0; base < n_tiles; base += kThreads) {
    const int64_t t = base + threadIdx.x;
    const int v = t < n_tiles ? tiles[t] : 0;
    int sum;
    const int excl = block_exclusive_scan(v, smem, &sum);
    if (t < n_tiles) tiles[t] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

}  // namespace repro
