// Batched canonical refine of quick-pattern codes (level 2 on the device):
// codes (Q, 3) int64, valid (Q,) bool -> canon (Q, 3) int64,
// sigma (Q, 8) int32, rep (Q, 8) int32.
//
// Replaces: src/repro/kernels/canonical_refine.py:_refine_nv_pallas
// (_refine_kernel), whose grid walks (row block, permutation tile) with the
// permutation axis fastest and carries the running lexicographic best in
// output windows that each tile revisits; one pallas_call per nv.
//
// Contract (identical to the plain version, refine_codes_ref): a row whose
// nv (the low nibble of w0) is one of the launch's nvs, and which is valid,
// gets the lexicographically least (w0, w1, w2) over all nv! permutations of
// its vertex positions; sigma[local] = canonical position under the FIRST
// permutation, in itertools.permutations order, that attains it (identity
// at positions >= nv); with_orbits, rep[c] = the least p[c] over the
// permutations p that map the code to itself (identity without). Every
// other row passes through: canon = the code, sigma = rep = identity.
//
// Design: one group of G lanes (G a power of two <= 32, from the largest
// nv! of the launch) per row, lane j walking the permutations j, j + G, ...
// of the row's own nv, so one launch serves a batch of mixed nv. Each lane
// keeps a strict-less running minimum, i.e. the first minimum of its own
// permutations; the group then reduces the 4-tuple (w0, w1, w2, index)
// lexicographically with shuffles. That tuple order does not depend on the
// reduction order, so the first minimal permutation wins, as in the
// reference's ordered tiles. The orbit minimum is order-free. The
// permutation table holds nv! rows of 32 bytes each for every nv of the
// launch (the permutation as 8 nibbles, then the 28 source-bit bytes of the
// permuted adjacency word), read as two 16-byte loads; at nv = 8 it is
// 1.3 MB and stays in L2.
//
// Bound on this card: integer operations. Each (row, permutation) costs
// about 3 per adjacency bit, 4 per label and 8 for the compare; the input
// and output bytes are tiny beside that for nv >= 3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNv = 8;

__device__ __forceinline__ bool lex_less4(uint32_t a0, uint32_t a1,
                                          uint32_t a2, int ai, uint32_t b0,
                                          uint32_t b1, uint32_t b2, int bi) {
  if (a0 != b0) return a0 < b0;
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ai < bi;
}

__global__ void refine_kernel(const int64_t* __restrict__ codes,
                              const uint8_t* __restrict__ valid, int64_t q,
                              const uint4* __restrict__ table,
                              const int* __restrict__ meta, int group,
                              bool with_orbits, int64_t* __restrict__ canon,
                              int* __restrict__ sigma, int* __restrict__ rep) {
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = gt / group;
  const int lane = (int)(gt % group);
  const bool live = row < q;
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
  int nv = 0, count = 0, off = 0;
  if (live) {
    w0 = (uint32_t)(uint64_t)codes[row * 3];
    w1 = (uint32_t)(uint64_t)codes[row * 3 + 1];
    w2 = (uint32_t)(uint64_t)codes[row * 3 + 2];
    nv = (int)(w0 & 0xFu);
    if (valid[row] && nv >= 2 && nv <= kMaxNv) {
      off = meta[nv];
      count = meta[kMaxNv + 1 + nv];
    }
  }
  const uint32_t bits = w0 >> 4;
  const int nbits = nv * (nv - 1) / 2;
  uint32_t b0 = 0xFFFFFFFFu, b1 = 0xFFFFFFFFu, b2 = 0xFFFFFFFFu;
  int bpi = 0x7FFFFFFF;
  int orb[kMaxNv];
#pragma unroll
  for (int c = 0; c < kMaxNv; ++c) orb[c] = c;
  for (int p = lane; p < count; p += group) {
    const uint4 a = table[(int64_t)(off + p) * 2];
    const uint4 b = table[(int64_t)(off + p) * 2 + 1];
    const uint32_t pk = a.x;
    const uint32_t src[7] = {a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t nb = 0u;
#pragma unroll
    for (int t = 0; t < 28; ++t) {
      if (t < nbits) {
        const uint32_t s = (src[t >> 2] >> (8 * (t & 3))) & 0xFFu;
        nb |= ((bits >> s) & 1u) << t;
      }
    }
    const uint32_t k0 = (nb << 4) | (uint32_t)nv;
    uint32_t k1 = 0u, k2 = 0u;
#pragma unroll
    for (int i = 0; i < kMaxNv; ++i) {
      const uint32_t j = i < nv ? (pk >> (4 * i)) & 0xFu : (uint32_t)i;
      const uint32_t lab = ((j < 4 ? w1 : w2) >> (8 * (j & 3))) & 0xFFu;
      if (i < 4) k1 |= lab << (8 * i);
      else k2 |= lab << (8 * (i - 4));
    }
    if (lex_less4(k0, k1, k2, p, b0, b1, b2, bpi)) {
      b0 = k0; b1 = k1; b2 = k2; bpi = p;
    }
    if (with_orbits && k0 == w0 && k1 == w1 && k2 == w2) {
#pragma unroll
      for (int c = 0; c < kMaxNv; ++c) {
        if (c < nv) orb[c] = min(orb[c], (int)((pk >> (4 * c)) & 0xFu));
      }
    }
  }
  // reduce over the group (aligned lanes of one warp; every lane of the
  // warp takes part, live or not)
  for (int o = group >> 1; o > 0; o >>= 1) {
    const uint32_t o0 = __shfl_xor_sync(0xffffffffu, b0, o);
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, b1, o);
    const uint32_t o2 = __shfl_xor_sync(0xffffffffu, b2, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bpi, o);
    if (lex_less4(o0, o1, o2, oi, b0, b1, b2, bpi)) {
      b0 = o0; b1 = o1; b2 = o2; bpi = oi;
    }
    if (with_orbits) {
#pragma unroll
      for (int c = 0; c < kMaxNv; ++c)
        orb[c] = min(orb[c], __shfl_xor_sync(0xffffffffu, orb[c], o));
    }
  }
  if (!live || lane != 0) return;
  int* sg = sigma + row * kMaxNv;
  int* rp = rep + row * kMaxNv;
  if (count == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) canon[row * 3 + k] = codes[row * 3 + k];
#pragma unroll
    for (int c = 0; c < kMaxNv; ++c) {
      sg[c] = c;
      rp[c] = c;
    }
    return;
  }
  canon[row * 3] = (int64_t)b0;
  canon[row * 3 + 1] = (int64_t)b1;
  canon[row * 3 + 2] = (int64_t)b2;
  const uint32_t pk = table[(int64_t)(off + bpi) * 2].x;
#pragma unroll
  for (int c = 0; c < kMaxNv; ++c) {
    const int j = c < nv ? (int)((pk >> (4 * c)) & 0xFu) : c;
    sg[j] = c;
    rp[c] = orb[c];
  }
}

}  // namespace

// codes: q x 3 int64; valid: q bool bytes; table: the packed permutation
// rows (32 bytes each, 16-byte aligned); meta: 18 int32, the first table
// row of each nv (index nv) then the row count of each nv (index 9 + nv, 0
// for an nv outside the launch); group: lanes per row, a power of two
// <= 32; canon: q x 3 int64; sigma, rep: q x 8 int32.
// Returns cudaGetLastError().
extern "C" int repro_canonical_refine(const void* codes, const void* valid,
                                      long long q, const void* table,
                                      const void* meta, int group,
                                      int with_orbits, void* canon,
                                      void* sigma, void* rep, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t threads = (int64_t)q * group;
  if (threads > 0) {
    refine_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                    0, s>>>(
        (const int64_t*)codes, (const uint8_t*)valid, q,
        (const uint4*)table, (const int*)meta, group, with_orbits != 0,
        (int64_t*)canon, (int*)sigma, (int*)rep);
  }
  return (int)cudaGetLastError();
}
