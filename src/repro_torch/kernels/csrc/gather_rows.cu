// Halo-tile row gather: table (N, R) int32, rows (U,) int32 ->
// out (U, R) int32, out[i, :] = table[rows[i], :] when 0 <= rows[i] < N,
// else a row of `fill`.
//
// Replaces: src/repro/kernels/gather.py:gather_rows_pallas (_gather_kernel),
// which keeps the whole shard-stacked table resident in the TPU's VMEM and
// copies one block of rows per grid step (the fill is applied outside it).
//
// Bound on this card: bytes. It reads U row ids and U * R table words and
// writes U * R words; there is no arithmetic. On the partitioned main path
// the neighbour table is 273 MB (MiCo/10, 4 shards), far past shared memory
// and L2, so the table stays in device memory and each copied row is one
// contiguous stream. Design: one block per output row (grid-strided), its
// threads walking the R columns with 4-byte loads and stores, so a warp
// reads and writes 128 contiguous bytes; R = 2,945 is odd, so rows are not
// 16-byte aligned and wider loads would need a misaligned head and tail on
// both sides. The fill is written in the same pass, saving the separate
// masking pass the reference does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const int32_t* __restrict__ table,
                                   int64_t n_rows, int64_t width,
                                   const int32_t* __restrict__ rows,
                                   int64_t n_out, int32_t fill,
                                   int32_t* __restrict__ out) {
  for (int64_t i = blockIdx.x; i < n_out; i += gridDim.x) {
    const int64_t r = rows[i];
    int32_t* dst = out + i * width;
    if (r >= 0 && r < n_rows) {
      const int32_t* src = table + r * width;
      for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
        dst[j] = __ldg(src + j);
      }
    } else {
      for (int64_t j = threadIdx.x; j < width; j += blockDim.x) dst[j] = fill;
    }
  }
}

}  // namespace

// table: n_rows x width int32; rows: n_out int32; out: n_out x width int32.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_gather_rows(const void* table, long long n_rows,
                                 long long width, const void* rows,
                                 long long n_out, int fill, void* out,
                                 void* stream) {
  if (n_out > 0 && width > 0) {
    const unsigned grid =
        (unsigned)(n_out < (1LL << 30) ? n_out : (1LL << 30));
    gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, n_rows, width, (const int32_t*)rows, n_out,
        (int32_t)fill, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
