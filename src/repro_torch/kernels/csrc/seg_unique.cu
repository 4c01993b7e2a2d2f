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
// plus the O(cap) windows. Design: the three-pass tile scan of scan.cuh over
// new & valid. In the scatter pass each thread walks its 16 consecutive rows,
// sums the run of rows that share a slot in a register and adds the run to
// counts with one integer atomicAdd when the slot changes (integer adds give
// the same total in any order). Sorted rows make runs long, so few atomics
// reach the same address.
#include "scan.cuh"

namespace {

using namespace repro;

__device__ __forceinline__ void load_newv(const uint8_t* __restrict__ nw,
                                          const uint8_t* __restrict__ vd,
                                          int64_t n, int64_t first,
                                          bool aligned, uint8_t* newv,
                                          uint8_t* valid) {
  uint8_t a[kItems];
  load_flags(nw, n, first, aligned, a);
  load_flags(vd, n, first, aligned, valid);
#pragma unroll
  for (int i = 0; i < kItems; ++i) newv[i] = a[i] & valid[i];
}

__global__ void seg_count_kernel(const uint8_t* __restrict__ nw,
                                 const uint8_t* __restrict__ vd, int64_t n,
                                 bool aligned, int* __restrict__ tiles) {
  __shared__ int smem[kWarps + 1];
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t newv[kItems], valid[kItems];
  load_newv(nw, vd, n, first, aligned, newv, valid);
  int local = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) local += newv[i] != 0;
  int sum;
  block_exclusive_scan(local, smem, &sum);
  if (threadIdx.x == 0) tiles[blockIdx.x] = sum;
}

__global__ void seg_scatter_kernel(const uint8_t* __restrict__ nw,
                                   const uint8_t* __restrict__ vd, int64_t n,
                                   bool aligned, const int* __restrict__ tiles,
                                   int cap, int* __restrict__ src,
                                   int* __restrict__ counts,
                                   int* __restrict__ slot) {
  __shared__ int smem[kWarps + 1];
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  uint8_t newv[kItems], valid[kItems];
  load_newv(nw, vd, n, first, aligned, newv, valid);
  int local = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) local += newv[i] != 0;
  int sum;
  int incl = tiles[blockIdx.x] + block_exclusive_scan(local, smem, &sum);
  int run_slot = -1, run_len = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t r = first + i;
    if (r >= n) break;
    incl += newv[i] != 0;
    const int s = valid[i] ? incl - 1 : -1;
    slot[r] = s;
    if (newv[i] && s < cap) src[s] = (int)r;
    const int cs = (valid[i] && s >= 0 && s < cap) ? s : -1;
    if (cs != run_slot) {
      if (run_slot >= 0) atomicAdd(counts + run_slot, run_len);
      run_slot = cs;
      run_len = 0;
    }
    ++run_len;
  }
  if (run_slot >= 0) atomicAdd(counts + run_slot, run_len);
}

}  // namespace

extern "C" int repro_scan_tile() { return kTile; }

// new_, valid: n bool bytes; src, counts: cap int32 (zeroed by the caller);
// slot: n int32; n_out: one int32; tiles: ceil(n / kTile) int32 scratch.
// Returns cudaGetLastError().
extern "C" int repro_seg_unique(const void* new_, const void* valid,
                                long long n, int cap, void* src, void* counts,
                                void* slot, void* n_out, void* tiles,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* nw = (const uint8_t*)new_;
  const uint8_t* vd = (const uint8_t*)valid;
  const bool aligned = (((uintptr_t)nw | (uintptr_t)vd) & 15u) == 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0) {
    seg_count_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        nw, vd, n, aligned, (int*)tiles);
  }
  tile_offsets_kernel<<<1, kThreads, 0, s>>>((int*)tiles, n_tiles, (int*)n_out);
  if (n_tiles > 0) {
    seg_scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        nw, vd, n, aligned, (const int*)tiles, cap, (int*)src, (int*)counts,
        (int*)slot);
  }
  return (int)cudaGetLastError();
}
