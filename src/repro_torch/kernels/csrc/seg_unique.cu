// Segment-unique over sorted rows: (new, valid) (B,) bool ->
// src (cap,) int32, counts (cap,) int32, slot (B,) int32, n () int32.
//
// Replaces: src/repro/kernels/aggregate.py:seg_unique_pallas
// (_seg_unique_kernel), which carries the running distinct total across a
// grid that runs in order and accumulates per-slot counts in a window that
// every grid step revisits.
//
// Contract (identical to the plain version, seg_unique_ref):
//   slot[r] = (number of rows at or before r with new & valid) - 1 for a
//   valid row, -1 otherwise; it is not clamped to cap.
//   src[s] = the first row of segment s (s < cap); other slots hold 0.
//   counts[s] = valid rows of segment s (s < cap); other slots hold 0.
//   n = the unclamped number of segments, left on the device.
//   Rows whose slot is at or past cap land nowhere (the Pallas kernel's dump
//   slot, which it slices off).
//
// Bound on this card: bytes. It reads 2B flag bytes and writes 4B slot bytes
// plus the two cap-slot windows. Design: one launch over tiles of 4,096 rows
// with a decoupled look-back (scan.cuh, as stream_compact.cu). A block takes
// the next tile id from a counter, reads each flag byte once (16-byte loads,
// 16 rows a thread) and scans, in one packed int, the tile's heads
// (new & valid) and valid rows. Warp 0 publishes the tile's head count and
// adds up its predecessors'; meanwhile the block stages each row's
// tile-local slot in shared memory (16-byte chunks, swizzled against bank
// conflicts) and, for each head, its row and the valid rows before it.
// Then the slots are stored as contiguous 16-byte runs (a tile without a
// valid row stores its -1s before the look-back), and each head of
// the tile writes src and its segment's count: a segment's rows in the
// tile are the valid rows from its head to the next head, so the counts
// are differences of the staged prefix, with no per-row atomic. A segment
// that may go on past the tile (the tile's last head, and the rows before
// its first head, which belong to an earlier tile's segment) is added with
// one integer atomicAdd per tile; every other segment is stored. Integer
// adds give the same total in any order. The windows, the tile words and
// the counter are one scratch buffer, cleared by one memset; the last tile
// writes n.
#include <limits.h>

#include "scan.cuh"

namespace {

using namespace repro;

constexpr int kSegTile = kTile;                  // rows a tile
constexpr int kChunks = kSegTile / 4;            // 16-byte slot chunks a tile

// Chunk c of the staged slots lives at swizzle(c): the 8 chunks one
// quarter-warp touches land in 8 distinct 16-byte bank groups both when a
// thread writes its 4 consecutive chunks and when consecutive threads read
// consecutive chunks.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 3); }

__global__ void __launch_bounds__(kThreads)
seg_unique_kernel(const uint8_t* __restrict__ nw,
                  const uint8_t* __restrict__ vd, int64_t n, bool aligned,
                  int64_t n_tiles, unsigned long long* __restrict__ status,
                  unsigned* __restrict__ next_tile, int cap,
                  int* __restrict__ src, int* __restrict__ counts,
                  int* __restrict__ n_out, int* __restrict__ slot) {
  __shared__ int4 stage[kChunks];                // tile-local slots
  __shared__ uint16_t head_row[kSegTile];        // tile row of head k
  __shared__ uint16_t head_valid[kSegTile + 1];  // valid rows before head k
  __shared__ int smem[kWarps + 1];
  __shared__ int64_t s_tile;
  __shared__ int s_excl;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile_first = tile * kSegTile;
  const int own = threadIdx.x * kItems;
  const uint32_t vm = load_flag_mask<1>(vd, n, tile_first + own, aligned);
  const uint32_t hm = load_flag_mask<1>(nw, n, tile_first + own, aligned) & vm;
  // heads in the high half, valid rows in the low half (each <= 4,096)
  int total;
  const int pre = block_exclusive_scan((__popc(hm) << 16) | __popc(vm), smem,
                                       &total);
  const int tile_heads = total >> 16;
  const int tile_valid = total & 0xFFFF;
  if (tile_valid == 0) {
    // every slot is -1 whatever the offset: store before the look-back,
    // which only passes the offset on (the level-2 table's tail)
#pragma unroll
    for (int j = 0; j < kChunks / kThreads; ++j) {
      const int64_t r = tile_first + 4 * (j * kThreads + threadIdx.x);
      if (r + 4 <= n) {
        *reinterpret_cast<int4*>(slot + r) = make_int4(-1, -1, -1, -1);
      } else {
        for (int64_t i = r; i < n && i < r + 4; ++i) slot[i] = -1;
      }
    }
  }
  if (threadIdx.x < 32) {
    int excl = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) tile_publish(status, 0, kTilePrefix, tile_heads);
    } else {
      if (threadIdx.x == 0) {
        tile_publish(status, tile, kTileAggregate, tile_heads);
      }
      excl = tile_lookback(status, tile);
      if (threadIdx.x == 0) {
        tile_publish(status, tile, kTilePrefix, excl + tile_heads);
      }
    }
    if (threadIdx.x == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) *n_out = excl + tile_heads;
    }
  }
  if (tile_valid == 0) return;
  // tile-local slots: the heads at or before the row, less one (-1: the
  // segment an earlier tile started); INT_MIN marks an invalid row
  int h = pre >> 16;
  int v = pre & 0xFFFF;
  int loc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = (vm >> i) & 1u;
    if ((hm >> i) & 1u) {
      head_row[h] = (uint16_t)(own + i);
      head_valid[h] = (uint16_t)v;
      ++h;
    }
    loc[i] = valid ? h - 1 : INT_MIN;
    v += valid;
  }
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    stage[swizzle(threadIdx.x * (kItems / 4) + k)] =
        make_int4(loc[4 * k], loc[4 * k + 1], loc[4 * k + 2], loc[4 * k + 3]);
  }
  if (threadIdx.x == 0) head_valid[tile_heads] = (uint16_t)tile_valid;
  __syncthreads();
  const int excl = s_excl;
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int c = j * kThreads + threadIdx.x;
    const int4 l = stage[swizzle(c)];
    const int4 s = make_int4(l.x == INT_MIN ? -1 : excl + l.x,
                             l.y == INT_MIN ? -1 : excl + l.y,
                             l.z == INT_MIN ? -1 : excl + l.z,
                             l.w == INT_MIN ? -1 : excl + l.w);
    const int64_t r = tile_first + 4 * c;
    if (r + 4 <= n) {
      *reinterpret_cast<int4*>(slot + r) = s;
    } else {
      const int e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r + i < n) slot[r + i] = e[i];
      }
    }
  }
  // heads k of the tile hold the consecutive slots excl + k
  const int stop = min(tile_heads, cap - excl);
  for (int k = threadIdx.x; k < stop; k += kThreads) {
    const int s = excl + k;
    src[s] = (int)(tile_first + head_row[k]);
    const int cnt = (int)head_valid[k + 1] - (int)head_valid[k];
    if (k + 1 < tile_heads) {
      counts[s] = cnt;
    } else {
      atomicAdd(counts + s, cnt);
    }
  }
  if (threadIdx.x == 0) {
    const int lead = tile_heads ? head_valid[0] : tile_valid;
    if (lead > 0 && excl >= 1 && excl - 1 < cap) {
      atomicAdd(counts + excl - 1, lead);
    }
  }
}

}  // namespace

extern "C" int repro_seg_unique_tile() { return kSegTile; }

// new_, valid: n bool bytes (n >= 1); scratch: the int32 words src (cap)
// and counts (cap), then ceil(n / tile) + 1 eight-byte words (the tile
// words, then the tile counter), cleared here by one memset; slot: n int32,
// 16-byte aligned; n_out: one int32. Returns the memset's error, else
// cudaGetLastError() after the launch.
extern "C" int repro_seg_unique(const void* new_, const void* valid,
                                long long n, int cap, void* scratch,
                                void* slot, void* n_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* nw = (const uint8_t*)new_;
  const uint8_t* vd = (const uint8_t*)valid;
  const bool aligned = (((uintptr_t)nw | (uintptr_t)vd) & 15u) == 0;
  const int64_t n_tiles = (n + kSegTile - 1) / kSegTile;
  int* src = (int*)scratch;
  int* counts = src + cap;
  unsigned long long* status = (unsigned long long*)(counts + cap);
  const size_t bytes = (size_t)(2 * (int64_t)cap) * sizeof(int) +
                       (size_t)(n_tiles + 1) * sizeof(unsigned long long);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, bytes, s);
  if (e != cudaSuccess) return (int)e;
  seg_unique_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      nw, vd, n, aligned, n_tiles, status, (unsigned*)(status + n_tiles), cap,
      src, counts, (int*)n_out, (int*)slot);
  return (int)cudaGetLastError();
}
