// Stream compaction: keep (B,) bool -> idx (out_cap,) int32, count () int32.
//
// Replaces: src/repro/kernels/compact.py:stream_compact_pallas
// (_compact_kernel), which walks `keep` in blocks over a grid that runs in
// order and carries the running kept total from one block to the next.
//
// Contract (identical to the plain version, stream_compact_ref):
//   idx[:min(count, out_cap)] are the kept positions in ascending order;
//   slots past the count hold 0; count is the TOTAL kept, not clamped to
//   out_cap (a kept index whose position is at or past out_cap is dropped
//   but still counted), and it stays on the device.
//
// Bound on this card: bytes. It reads B flag bytes and writes out_cap int32
// slots; there is next to no arithmetic. Design: one pass over the flags.
// A block of 256 threads takes the next tile of 8,192 flags from a counter
// (two 16-byte loads a thread, issued together), scans the tile's counts,
// publishes the tile's sum and finds its offset by a decoupled look-back
// over the earlier tiles' published sums (scan.cuh), then stages the
// tile's kept positions in shared memory and stores them as one contiguous
// run from the offset, so neighbouring threads store to neighbouring
// slots rather than each thread storing its own run. The last tile writes
// the count; a second, small launch zeroes the slots from the count to
// out_cap, each once. The wrapper allocates idx uninitialised, so nothing
// is written twice; the tile words and the counter are cleared by one
// memset of 8 bytes a tile.
#include "scan.cuh"

namespace {

using namespace repro;

constexpr int kCompactThreads = 256;
constexpr int kCompactLoads = 2;  // 16-byte flag loads a thread
constexpr int kCompactTile = kCompactThreads * kCompactLoads * kItems;
constexpr int kPadThreads = 256;
constexpr unsigned kMaxPadBlocks = 1024;

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const uint8_t* __restrict__ keep, int64_t n, bool aligned,
               int64_t n_tiles, unsigned long long* __restrict__ status,
               unsigned* __restrict__ next_tile, int out_cap,
               int* __restrict__ idx, int* __restrict__ count) {
  __shared__ int stage[kCompactTile];
  __shared__ int smem[kCompactThreads / 32 + 1];
  __shared__ int64_t s_tile;
  __shared__ int s_excl;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t first =
      tile * kCompactTile + (int64_t)threadIdx.x * kCompactLoads * kItems;
  uint32_t mask = load_flag_mask<kCompactLoads>(keep, n, first, aligned);
  int sum;
  int pos = block_exclusive_scan<kCompactThreads>(__popc(mask), smem, &sum);
  if (threadIdx.x < 32) {
    int excl = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) tile_publish(status, 0, kTilePrefix, sum);
    } else {
      if (threadIdx.x == 0) tile_publish(status, tile, kTileAggregate, sum);
      excl = tile_lookback(status, tile);
      if (threadIdx.x == 0) {
        tile_publish(status, tile, kTilePrefix, excl + sum);
      }
    }
    if (threadIdx.x == 0) {
      s_excl = excl;
      if (tile == n_tiles - 1) *count = excl + sum;
    }
  }
  while (mask) {
    stage[pos++] = (int)(first + __ffs(mask) - 1);
    mask &= mask - 1;
  }
  __syncthreads();
  const int excl = s_excl;
  const int stop = min(sum, out_cap - excl);  // drop past out_cap
  for (int j = threadIdx.x; j < stop; j += kCompactThreads) {
    idx[excl + j] = stage[j];
  }
}

// idx[min(count, out_cap):out_cap] = 0.
__global__ void __launch_bounds__(kPadThreads)
pad_kernel(int* __restrict__ idx, int out_cap, const int* __restrict__ count) {
  const int64_t from = min(*count, out_cap);
  const int64_t stride = (int64_t)gridDim.x * kPadThreads;
  for (int64_t i = from + (int64_t)blockIdx.x * kPadThreads + threadIdx.x;
       i < out_cap; i += stride) {
    idx[i] = 0;
  }
}

}  // namespace

extern "C" int repro_compact_tile() { return kCompactTile; }

// keep: n bool bytes (n >= 1); idx: out_cap int32, uninitialised; count:
// one int32; scratch: ceil(n / repro_compact_tile()) + 1 eight-byte words
// (the tile words, then the tile counter), cleared here. Returns the
// memset's error, else cudaGetLastError() after the launches.
extern "C" int repro_stream_compact(const void* keep, long long n, int out_cap,
                                    void* idx, void* count, void* scratch,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* k = (const uint8_t*)keep;
  const bool aligned = ((uintptr_t)k & 15u) == 0;
  const int64_t n_tiles = (n + kCompactTile - 1) / kCompactTile;
  unsigned long long* status = (unsigned long long*)scratch;
  const cudaError_t e = cudaMemsetAsync(
      status, 0, (size_t)(n_tiles + 1) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<(unsigned)n_tiles, kCompactThreads, 0, s>>>(
      k, n, aligned, n_tiles, status, (unsigned*)(status + n_tiles),
      out_cap, (int*)idx, (int*)count);
  if (out_cap > 0) {
    const long long want = ((long long)out_cap + kPadThreads - 1) / kPadThreads;
    const unsigned blocks =
        want < kMaxPadBlocks ? (unsigned)want : kMaxPadBlocks;
    pad_kernel<<<blocks, kPadThreads, 0, s>>>((int*)idx, out_cap,
                                              (const int*)count);
  }
  return (int)cudaGetLastError();
}
