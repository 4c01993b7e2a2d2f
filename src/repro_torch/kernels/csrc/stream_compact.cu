// Stream compaction: keep (B,) bool -> idx (out_cap,) int32, count () int32.
//
// Replaces: src/repro/kernels/compact.py:stream_compact_pallas
// (_compact_kernel), which walks `keep` in blocks over a grid that runs in
// order and carries the running kept total from one block to the next.
//
// Contract (identical to the plain version, stream_compact_ref):
//   idx[:min(count, out_cap)] are the kept positions in ascending order;
//   slots past the count hold 0 (the wrapper allocates idx zeroed);
//   count is the TOTAL kept, not clamped to out_cap (a kept index whose
//   position is at or past out_cap is dropped but still counted), and it
//   stays on the device.
//
// Bound on this card: bytes. It reads B flag bytes and writes at most
// out_cap int32 indices; there is next to no arithmetic. Design: the
// three-pass tile scan of scan.cuh (count, offsets, scatter). Each thread
// reads its 16 flags as one 16-byte load in both passes, so the flags are
// read twice (the second read mostly from L2); the scatter writes each kept
// index once.
#include "scan.cuh"

namespace {

using namespace repro;

__global__ void compact_count_kernel(const uint8_t* __restrict__ keep,
                                     int64_t n, bool aligned,
                                     int* __restrict__ tiles) {
  __shared__ int smem[kWarps + 1];
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t f[kItems];
  load_flags(keep, n, first, aligned, f);
  int local = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) local += f[i] != 0;
  int sum;
  block_exclusive_scan(local, smem, &sum);
  if (threadIdx.x == 0) tiles[blockIdx.x] = sum;
}

__global__ void compact_scatter_kernel(const uint8_t* __restrict__ keep,
                                       int64_t n, bool aligned,
                                       const int* __restrict__ tiles,
                                       int out_cap, int* __restrict__ idx) {
  __shared__ int smem[kWarps + 1];
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t f[kItems];
  load_flags(keep, n, first, aligned, f);
  int local = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) local += f[i] != 0;
  int sum;
  int pos = tiles[blockIdx.x] + block_exclusive_scan(local, smem, &sum);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (f[i]) {
      if (pos < out_cap) idx[pos] = (int)(first + i);
      ++pos;
    }
  }
}

}  // namespace

extern "C" int repro_scan_tile() { return kTile; }

// keep: n bool bytes; idx: out_cap int32 (zeroed by the caller); count: one
// int32; tiles: ceil(n / kTile) int32 scratch. Returns cudaGetLastError().
extern "C" int repro_stream_compact(const void* keep, long long n, int out_cap,
                                    void* idx, void* count, void* tiles,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* k = (const uint8_t*)keep;
  const bool aligned = ((uintptr_t)k & 15u) == 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0) {
    compact_count_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        k, n, aligned, (int*)tiles);
  }
  tile_offsets_kernel<<<1, kThreads, 0, s>>>((int*)tiles, n_tiles, (int*)count);
  if (n_tiles > 0) {
    compact_scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        k, n, aligned, (const int*)tiles, out_cap, (int*)idx);
  }
  return (int)cudaGetLastError();
}
