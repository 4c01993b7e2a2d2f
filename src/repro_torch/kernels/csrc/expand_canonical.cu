// Fused vertex expansion: members (C, k) int32, n_valid (C,) int32,
// nbr (N, D) int32 padded neighbour table (pad -1), adj (N, W) packed
// adjacency bits -> cand (C, k, D) int32, valid (C, k, D) bool,
// keep (C, k, D) bool.
//
// Replaces: src/repro/kernels/canonical_check/canonical_check.py:
// expand_canonical_pallas (_expand_kernel), which keeps the neighbour table
// and the bitmap resident in the TPU's VMEM and evaluates a block of parents
// as (TC, k, k, D) mask algebra.
//
// Per slot (c, i, j), the candidate is neighbour j of member i:
//   cand  = nbr[m_i, j] if i < n_valid[c] else -1
//   valid = cand >= 0 and cand is no member of c and no earlier member
//           (q < i) is adjacent to cand (first-occurrence dedup)
//   keep  = valid and members[:n_valid] + [cand] is canonical (Alg. 2)
// A slot past the degree of m_i reads the -1 pad and writes cand = -1,
// valid = keep = false, which keeps the dense (C, k, D) contract.
//
// Bound on this card: bytes. It writes 6 bytes per slot (C*k*D slots) and
// reads one neighbour-table word per slot; the k member<->candidate bit tests
// per slot gather from a bitmap that sits in the 50 MB L2 at the sizes this
// path mines. Design: blockIdx.y walks the (c, i) parent rows, the threads
// of a block walk the D neighbour slots, so the neighbour-row read and the
// three output writes are coalesced. Each thread holds the row's k <= 8
// members in registers, gathers each member<->candidate adjacency bit once
// and uses it for both the dedup rule and the Alg.-2 scan, as the TPU kernel
// does; nothing of the (k, k, D) intermediate reaches memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;

__global__ void expand_canonical_kernel(
    const int32_t* __restrict__ members, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ nbr, const uint32_t* __restrict__ adj,
    int64_t C, int k, int64_t D, int64_t n_rows, int64_t words,
    int32_t* __restrict__ cand_out, bool* __restrict__ valid_out,
    bool* __restrict__ keep_out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  for (int64_t ci = blockIdx.y; ci < C * k; ci += gridDim.y) {
    const int64_t c = ci / k;
    const int i = (int)(ci - c * k);
    const int nv = n_valid[c];
    int m[kMaxK];
#pragma unroll
    for (int q = 0; q < kMaxK; ++q) m[q] = q < k ? members[c * k + q] : -1;

    int cv = -1;
    if (i < nv) {
      const int mi_id = members[c * k + i];
      const int64_t mi = mi_id > 0 ? mi_id : 0;
      cv = __ldg(nbr + (mi < n_rows - 1 ? mi : n_rows - 1) * D + j);
    }
    const bool slot_ok = cv >= 0;
    const int cs = cv > 0 ? cv : 0;
    const int64_t col = (int64_t)(cs >> 5) < words - 1 ? (int64_t)(cs >> 5) : words - 1;
    const uint32_t sh = (uint32_t)cs & 31u;

    bool is_member = false, seen_earlier = false, found = false,
         violation = false;
#pragma unroll
    for (int q = 0; q < kMaxK; ++q) {
      if (q < k) {
        is_member |= m[q] == cv;
        const bool member_ok = q < nv;
        bool adjacent = false;
        if (member_ok && slot_ok) {
          const int64_t mq = m[q] > 0 ? m[q] : 0;
          const int64_t row = mq < n_rows - 1 ? mq : n_rows - 1;
          adjacent = ((__ldg(adj + row * words + col) >> sh) & 1u) != 0;
        }
        if (q < i && adjacent) seen_earlier = true;
        if (member_ok && found && m[q] > cv) violation = true;
        found |= adjacent;
      }
    }
    const bool first_ok = nv > 0 ? m[0] < cv : true;
    const bool valid = slot_ok && !is_member && !seen_earlier;
    const int64_t t = ci * D + j;
    cand_out[t] = cv;
    valid_out[t] = valid;
    keep_out[t] = valid && first_ok && !violation;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_expand_canonical(const void* members, const void* n_valid,
                                      const void* nbr, const void* adj,
                                      long long C, int k, long long D,
                                      long long n_rows, long long words,
                                      void* cand, void* valid, void* keep,
                                      void* stream) {
  if (C > 0 && D > 0) {
    const long long rows = C * k;
    const dim3 grid((unsigned)((D + kThreads - 1) / kThreads),
                    (unsigned)(rows < 65535 ? rows : 65535));
    expand_canonical_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)members, (const int32_t*)n_valid,
        (const int32_t*)nbr, (const uint32_t*)adj, C, k, D, n_rows, words,
        (int32_t*)cand, (bool*)valid, (bool*)keep);
  }
  return (int)cudaGetLastError();
}
