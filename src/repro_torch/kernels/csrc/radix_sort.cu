// One stable 8-bit LSB radix pass over the rows of a quick-code batch:
// the digit statistics (radix_hist) and the stable counting scatter
// (radix_scatter). kernels/radix_bin.py chains 13 passes into
// radix_sort_codes (w2, w1, w0 a byte at a time, then the invalid flag).
//
// Replaces: src/repro/kernels/radix_bin.py:radix_sort_codes, whose passes
// are two Pallas kernels: _hist_kernel (per-block digit histogram) and
// _scatter_kernel (stable scatter with a per-digit write cursor carried
// across a grid that runs in order, seeded from a jnp exclusive scan).
//
// CUDA blocks run in no fixed order, so no cursor is carried. Instead:
//   radix_hist    1. each block of kTileRows rows counts its digits in
//                    shared memory and writes them digit-major,
//                    hist[d * nb + block];
//                 2. one block per digit turns its row of hist into
//                    exclusive block offsets in place and writes the
//                    digit's total to totals[d];
//   radix_scatter 3. each block scans totals into digit bases, adds its own
//                    hist entry, and walks its rows in index order, 256 at
//                    a time: __match_any_sync ranks a row among the lanes
//                    of its warp with the same digit, per-warp digit counts
//                    in shared memory rank it among earlier warps, and a
//                    per-digit running count carries across the 256-row
//                    steps. The result is exactly a stable sort by digit.
//
// Rows whose pass digit is constant over the whole batch are not permuted
// by a stable pass, and the reference skips such passes with lax.cond. To
// skip without a host read, the first pass's histogram kernel also ORs
// (word[r] ^ word[0]) over all rows into vary[4] (the three code words'
// low 32 bits and the invalid flag); every later kernel reads the pass's
// byte of that mask and, when it is 0, returns at once (histogram) or
// copies order_in to order_out (scatter). The output is the same either
// way; only the work differs.
//
// Bound on this card: bytes. A pass reads the order (4 B a row), gathers
// one code word (8 B a row, from L2 for the main path's batches) and
// writes the new order (4 B a row); the 256 x nb histogram is small beside
// that. Nothing is atomically added in device memory except the 4-word
// vary mask.
#include "scan.cuh"

namespace {

using namespace repro;

constexpr int kDigits = 256;
constexpr int kSteps = 16;                       // 256-row steps a block
constexpr int kTileRows = kThreads * kSteps;     // rows per block: RADIX_TILE
                                                 // in kernels/radix_bin.py
static_assert(kThreads == kDigits, "one thread per digit");

__device__ __forceinline__ uint32_t word_of(const int64_t* __restrict__ codes,
                                            const uint8_t* __restrict__ valid,
                                            int64_t row, int word) {
  return word == 3 ? (valid[row] ? 0u : 1u)
                   : (uint32_t)(uint64_t)codes[row * 3 + word];
}

__device__ __forceinline__ bool pass_varies(const int* __restrict__ vary,
                                            int word, int shift) {
  return ((((uint32_t)vary[word]) >> shift) & 0xFFu) != 0u;
}

__global__ void radix_hist_kernel(const int64_t* __restrict__ codes,
                                  const uint8_t* __restrict__ valid,
                                  const int* __restrict__ order, int64_t n,
                                  int word, int shift, bool first,
                                  int* __restrict__ vary,
                                  int* __restrict__ hist, int64_t nb) {
  // `first` computes the vary mask, so it cannot consult it
  if (!first && !pass_varies(vary, word, shift)) return;
  __shared__ int counts[kDigits];
  counts[threadIdx.x] = 0;
  __syncthreads();
  uint32_t ref[4], diff[4] = {0u, 0u, 0u, 0u};
  if (first) {
#pragma unroll
    for (int w = 0; w < 4; ++w) ref[w] = word_of(codes, valid, 0, w);
  }
  const int64_t base = (int64_t)blockIdx.x * kTileRows;
  for (int s = 0; s < kSteps; ++s) {
    const int64_t r = base + (int64_t)s * kThreads + threadIdx.x;
    if (r >= n) break;
    const uint32_t d = (word_of(codes, valid, order[r], word) >> shift) & 0xFFu;
    atomicAdd(&counts[d], 1);
    if (first) {
      // the mask does not depend on the order: read row r directly
#pragma unroll
      for (int w = 0; w < 4; ++w) diff[w] |= word_of(codes, valid, r, w) ^ ref[w];
    }
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * nb + blockIdx.x] = counts[threadIdx.x];
  if (first) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t v = diff[w];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
      if ((threadIdx.x & 31) == 0 && v) atomicOr(vary + w, (int)v);
    }
  }
}

// Block d: exclusive scan of hist[d * nb, (d + 1) * nb) in place.
__global__ void radix_colscan_kernel(const int* __restrict__ vary, int word,
                                     int shift, int* __restrict__ hist,
                                     int64_t nb, int* __restrict__ totals) {
  if (!pass_varies(vary, word, shift)) return;
  __shared__ int smem[kWarps + 1];
  int* row = hist + (int64_t)blockIdx.x * nb;
  int carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += kThreads) {
    const int64_t t = b0 + threadIdx.x;
    const int v = t < nb ? row[t] : 0;
    int sum;
    const int excl = block_exclusive_scan(v, smem, &sum);
    if (t < nb) row[t] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void radix_scatter_kernel(const int64_t* __restrict__ codes,
                                     const uint8_t* __restrict__ valid,
                                     const int* __restrict__ order_in,
                                     int64_t n, int word, int shift,
                                     const int* __restrict__ vary,
                                     const int* __restrict__ hist, int64_t nb,
                                     const int* __restrict__ totals,
                                     int* __restrict__ order_out) {
  const int64_t base = (int64_t)blockIdx.x * kTileRows;
  if (!pass_varies(vary, word, shift)) {
    // a constant digit permutes nothing
    for (int s = 0; s < kSteps; ++s) {
      const int64_t r = base + (int64_t)s * kThreads + threadIdx.x;
      if (r < n) order_out[r] = order_in[r];
    }
    return;
  }
  __shared__ int smem[kWarps + 1];
  __shared__ int running[kDigits];
  __shared__ int wcount[kWarps][kDigits];
  const int me = threadIdx.x;             // this thread's digit below
  int all;
  const int dbase = block_exclusive_scan(totals[me], smem, &all);
  running[me] = dbase + hist[(int64_t)me * nb + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcount[w][me] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < kSteps; ++s) {
    const int64_t r = base + (int64_t)s * kThreads + threadIdx.x;
    const bool live = r < n;
    int row = 0;
    uint32_t d = kDigits;                  // a digit no live row has
    if (live) {
      row = order_in[r];
      d = (word_of(codes, valid, row, word) >> shift) & 0xFFu;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & below);
    if (live && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int pos = running[d] + rank;
      for (int w = 0; w < warp; ++w) pos += wcount[w][d];
      order_out[pos] = row;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add += wcount[w][me];
      wcount[w][me] = 0;
    }
    running[me] += add;
    __syncthreads();
  }
}

}  // namespace

// codes: n x 3 int64; valid: n bool bytes; order: n int32 (a permutation
// of the rows); word in 0..3 (3 = the invalid flag), shift in {0,8,16,24};
// first: also OR the vary mask (vary: 4 int32, zeroed by the caller before
// the first pass); hist: 256 * nb int32; totals: 256 int32.
// Returns cudaGetLastError().
extern "C" int repro_radix_hist(const void* codes, const void* valid,
                                const void* order, long long n, int word,
                                int shift, int first, void* vary, void* hist,
                                void* totals, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (n + kTileRows - 1) / kTileRows;
  if (nb > 0) {
    radix_hist_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
        (const int64_t*)codes, (const uint8_t*)valid, (const int*)order, n,
        word, shift, first != 0, (int*)vary, (int*)hist, nb);
    radix_colscan_kernel<<<kDigits, kThreads, 0, s>>>(
        (const int*)vary, word, shift, (int*)hist, nb, (int*)totals);
  }
  return (int)cudaGetLastError();
}

// order_in, order_out: n int32 (distinct buffers); the other arguments as
// for repro_radix_hist, after it ran for the same pass.
extern "C" int repro_radix_scatter(const void* codes, const void* valid,
                                   const void* order_in, long long n,
                                   int word, int shift, const void* vary,
                                   const void* hist, const void* totals,
                                   void* order_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (n + kTileRows - 1) / kTileRows;
  if (nb > 0) {
    radix_scatter_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
        (const int64_t*)codes, (const uint8_t*)valid, (const int*)order_in, n,
        word, shift, (const int*)vary, (const int*)hist, nb,
        (const int*)totals, (int*)order_out);
  }
  return (int)cudaGetLastError();
}
