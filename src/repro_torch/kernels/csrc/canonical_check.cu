// Embedding-canonicality check (paper Alg. 2) over a flat batch:
// members (B, k) int32, n_valid (B,) int32, cand (B,) int32,
// adj (N, W) packed adjacency bits -> out (B,) bool, true iff
// members[:n_valid] + [cand] is canonical.
//
// Replaces: src/repro/kernels/canonical_check/canonical_check.py:
// canonical_check_pallas (_kernel), which keeps the whole packed bitmap
// resident in the TPU's VMEM and evaluates a block of rows as mask algebra.
//
// Bound on this card: bytes. Per row it reads k + 2 int32 and writes one
// byte, and does k bit tests. The k adjacency words it gathers are random
// reads, but the bitmap of the graphs this path mines (12.5 MB at MiCo/10)
// sits in the 50 MB L2, so they cost L2 latency, not device-memory bytes.
// Design: one thread per row; the found/violation scan of Alg. 2 runs in
// registers over the k <= 8 members, and the thread stops at n_valid. Row
// and word indices are clamped into the table as the TPU gather clamps them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void canonical_check_kernel(const int32_t* __restrict__ members,
                                       const int32_t* __restrict__ n_valid,
                                       const int32_t* __restrict__ cand,
                                       const uint32_t* __restrict__ adj,
                                       int64_t batch, int k, int64_t n_rows,
                                       int64_t words, bool* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < batch;
       r += stride) {
    const int nv = n_valid[r];
    const int c = cand[r];
    const int32_t* m = members + r * k;
    const int cs = c > 0 ? c : 0;
    const int64_t col = (int64_t)(cs >> 5) < words - 1 ? (int64_t)(cs >> 5) : words - 1;
    const uint32_t sh = (uint32_t)cs & 31u;
    bool found = false, violation = false;
    for (int j = 0; j < k && j < nv; ++j) {
      const int mj = m[j];
      if (found && mj > c) violation = true;
      if (mj >= 0 && c >= 0) {
        const int64_t row = (int64_t)mj < n_rows - 1 ? (int64_t)mj : n_rows - 1;
        found |= ((__ldg(adj + row * words + col) >> sh) & 1u) != 0;
      }
    }
    const bool first_ok = nv > 0 ? m[0] < c : true;
    out[r] = first_ok && !violation;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_canonical_check(const void* members, const void* n_valid,
                                     const void* cand, const void* adj,
                                     long long batch, int k, long long n_rows,
                                     long long words, void* out, void* stream) {
  if (batch > 0) {
    const long long blocks = (batch + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
    canonical_check_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)members, (const int32_t*)n_valid,
        (const int32_t*)cand, (const uint32_t*)adj, batch, k, n_rows, words,
        (bool*)out);
  }
  return (int)cudaGetLastError();
}
