// Embedding-canonicality check (paper Alg. 2) over a gathered halo tile:
// members (B, k) int32 global ids, ranks (B, k) int32 rows of the tile,
// n_valid (B,) int32, cand (B,) int32 global ids, adj (U, W) packed
// adjacency rows of the chunk's halo -> out (B,) bool, true iff
// members[:n_valid] + [cand] is canonical.
//
// Replaces: src/repro/kernels/canonical_check/canonical_check.py:
// canonical_check_tiles_pallas (_tiles_kernel), which keeps the halo tile
// resident in the TPU's VMEM across a grid that runs in order.
//
// The adjacency of member j is read at its tile rank, the order tests use
// the global ids: neigh[j] = j < n_valid && members[j] >= 0 && ranks[j] >= 0
// && cand >= 0 && bit(adj[ranks[j]], cand); the result is
// (n_valid == 0 || members[0] < cand) && no j with an earlier neighbour and
// members[j] > cand. Ranks are clamped into [0, U) and the word index into
// [0, W) only for the load, as the TPU gather clamps them.
//
// Bound on this card: bytes. Per row it reads 2k + 2 int32 and writes one
// byte (25 B at k = 2), and does k bit tests. The tile of the partitioned
// main path (8,192 rows x 313 words, 10.3 MB at MiCo/10) sits in the 50 MB
// L2, so the random word reads cost L2 latency, not device-memory bytes.
// Design: blocks are independent (no sequential grid); one thread per row,
// the found/violation scan of Alg. 2 in registers over the k <= 8 members,
// stopping at n_valid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void canonical_check_tiles_kernel(
    const int32_t* __restrict__ members, const int32_t* __restrict__ ranks,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ cand,
    const uint32_t* __restrict__ adj, int64_t batch, int k, int64_t n_rows,
    int64_t words, bool* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < batch;
       r += stride) {
    const int nv = n_valid[r];
    const int c = cand[r];
    const int32_t* m = members + r * k;
    const int32_t* rk = ranks + r * k;
    const int cs = c > 0 ? c : 0;
    const int64_t col =
        (int64_t)(cs >> 5) < words - 1 ? (int64_t)(cs >> 5) : words - 1;
    const uint32_t sh = (uint32_t)cs & 31u;
    bool found = false, violation = false;
    for (int j = 0; j < k && j < nv; ++j) {
      const int mj = m[j];
      if (found && mj > c) violation = true;
      const int rj = rk[j];
      if (mj >= 0 && rj >= 0 && c >= 0) {
        const int64_t row = (int64_t)rj < n_rows - 1 ? (int64_t)rj : n_rows - 1;
        found |= ((__ldg(adj + row * words + col) >> sh) & 1u) != 0;
      }
    }
    const bool first_ok = nv > 0 ? m[0] < c : true;
    out[r] = first_ok && !violation;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_canonical_check_tiles(const void* members,
                                           const void* ranks,
                                           const void* n_valid,
                                           const void* cand, const void* adj,
                                           long long batch, int k,
                                           long long n_rows, long long words,
                                           void* out, void* stream) {
  if (batch > 0) {
    const long long blocks = (batch + kThreads - 1) / kThreads;
    const unsigned grid =
        (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
    canonical_check_tiles_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)members, (const int32_t*)ranks,
        (const int32_t*)n_valid, (const int32_t*)cand, (const uint32_t*)adj,
        batch, k, n_rows, words, (bool*)out);
  }
  return (int)cudaGetLastError();
}
