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
// Bound on this card: bytes where few rows are live (the main path's
// level-2 table: 68,743 live rows of 33,554,432, 113 B a row moved),
// integer operations where many are (about 3 per adjacency bit, 4 per
// label and 8 for the compare, a (row, permutation)).
//
// Design: a block of 256 threads takes a tile of consecutive rows (the
// wrapper sizes it from the launch: up to 1,024 rows, fewer where the
// launch's largest nv! or a short batch would leave the card idle). It
// stages the tile's codes in shared memory (coalesced 8-byte loads) and
// queues its live rows (valid, nv in the launch) by ballot, in one queue
// per lane count. It then writes the pass-through outputs of the other
// rows: canon coalesced from the staged codes, sigma and rep as 16-byte
// identity halves. Last, the warps walk the queues: a row of nv 2 takes 2
// lanes, of nv 3 takes 8, of nv 4 and up a whole warp, lane j walking
// permutations j, j + lanes, ... of the row's own nv, so one launch serves
// a batch of mixed nv and a pass-through row costs no search lanes. Each
// lane keeps a strict-less running minimum, i.e. the first minimum of its
// own permutations; the group then reduces the 4-tuple (w0, w1, w2, index)
// lexicographically with shuffles. That tuple order does not depend on the
// reduction order, so the first minimal permutation wins, as in the
// reference's ordered tiles. The orbit minimum is order-free. Every output
// row is written once. The permutation table holds nv! rows of 32 bytes
// each for every nv of the launch (the permutation as 8 nibbles, then the
// 28 source-bit bytes of the permuted adjacency word), read as two 16-byte
// loads; at nv = 8 it is 1.3 MB and stays in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNv = 8;
constexpr int kMinTile = 8;
constexpr int kMaxTile = 1024;
constexpr int kQueues = 3;                 // 2, 8 and 32 lanes a row
constexpr int kRowsPerThread = kMaxTile / kThreads;

__device__ __forceinline__ int queue_of(int nv) {
  return nv == 2 ? 0 : nv == 3 ? 1 : 2;
}

__device__ __forceinline__ bool lex_less4(uint32_t a0, uint32_t a1,
                                          uint32_t a2, int ai, uint32_t b0,
                                          uint32_t b1, uint32_t b2, int bi) {
  if (a0 != b0) return a0 < b0;
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ai < bi;
}

__device__ __forceinline__ bool is_live(const uint32_t* live, int r) {
  return (live[r >> 5] >> (r & 31)) & 1u;
}

// The rows of one queue, G lanes a row (aligned groups of a warp): each
// warp takes 32 / G rows at a time. The loop bounds are uniform over a
// warp, so every lane of it takes part in the shuffles.
template <int G>
__device__ __forceinline__ void walk(const uint16_t* __restrict__ queue,
                                     int qn, const int64_t* __restrict__ st,
                                     int64_t row0,
                                     const uint4* __restrict__ table,
                                     const int* __restrict__ meta,
                                     bool with_orbits,
                                     int64_t* __restrict__ canon,
                                     int* __restrict__ sigma,
                                     int* __restrict__ rep) {
  constexpr int kRows = 32 / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int base = warp * kRows; base < qn; base += kWarps * kRows) {
    const int k = base + lane / G;
    const bool have = k < qn;
    const int r = have ? queue[k] : 0;
    // a lane past the queue walks no permutation (nv 0)
    const uint32_t w0 = have ? (uint32_t)(uint64_t)st[r * 3] : 0u;
    const uint32_t w1 = have ? (uint32_t)(uint64_t)st[r * 3 + 1] : 0u;
    const uint32_t w2 = have ? (uint32_t)(uint64_t)st[r * 3 + 2] : 0u;
    const int nv = (int)(w0 & 0xFu);
    const int off = meta[nv];
    const int count = meta[kMaxNv + 1 + nv];
    const uint32_t bits = w0 >> 4;
    const int nbits = nv * (nv - 1) / 2;
    uint32_t b0 = 0xFFFFFFFFu, b1 = 0xFFFFFFFFu, b2 = 0xFFFFFFFFu;
    int bpi = 0x7FFFFFFF;
    int orb[kMaxNv];
#pragma unroll
    for (int c = 0; c < kMaxNv; ++c) orb[c] = c;
    for (int p = lane % G; p < count; p += G) {
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
#pragma unroll
    for (int o = G >> 1; o > 0; o >>= 1) {
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
    if (!have || lane % G != 0) continue;
    const int64_t row = row0 + r;
    canon[row * 3] = (int64_t)b0;
    canon[row * 3 + 1] = (int64_t)b1;
    canon[row * 3 + 2] = (int64_t)b2;
    // sigma[perm[c]] = c, gathered as nibbles
    const uint32_t pk = table[(int64_t)(off + bpi) * 2].x;
    uint32_t sg = 0u;
#pragma unroll
    for (int c = 0; c < kMaxNv; ++c) {
      const uint32_t j = c < nv ? (pk >> (4 * c)) & 0xFu : (uint32_t)c;
      sg |= (uint32_t)c << (4 * j);
    }
    int4* so = reinterpret_cast<int4*>(sigma + row * kMaxNv);
    int4* ro = reinterpret_cast<int4*>(rep + row * kMaxNv);
    so[0] = make_int4(sg & 0xF, (sg >> 4) & 0xF, (sg >> 8) & 0xF,
                      (sg >> 12) & 0xF);
    so[1] = make_int4((sg >> 16) & 0xF, (sg >> 20) & 0xF, (sg >> 24) & 0xF,
                      sg >> 28);
    ro[0] = make_int4(orb[0], orb[1], orb[2], orb[3]);
    ro[1] = make_int4(orb[4], orb[5], orb[6], orb[7]);
  }
}

__global__ void __launch_bounds__(kThreads)
refine_kernel(const int64_t* __restrict__ codes,
              const uint8_t* __restrict__ valid, int64_t q, int tile_rows,
              const uint4* __restrict__ table, const int* __restrict__ meta_g,
              bool with_orbits, int64_t* __restrict__ canon,
              int* __restrict__ sigma, int* __restrict__ rep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int meta[2 * (kMaxNv + 1)];
  __shared__ int qn[kQueues];
  int64_t* st = reinterpret_cast<int64_t*>(smem_raw);        // 3 R codes
  uint32_t* live = reinterpret_cast<uint32_t*>(st + 3 * tile_rows);
  uint16_t* queue = reinterpret_cast<uint16_t*>(live + (tile_rows + 31) / 32);
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)min((int64_t)tile_rows, q - row0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 2 * (kMaxNv + 1)) meta[threadIdx.x] = meta_g[threadIdx.x];
  if (threadIdx.x < kQueues) qn[threadIdx.x] = 0;
  // row j * kThreads + threadIdx.x's valid flag, loaded beside the codes
  bool vf[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = j * kThreads + threadIdx.x;
    vf[j] = r < rows && valid[row0 + r];
  }
  const int64_t* cw = codes + row0 * 3;
  for (int i = threadIdx.x; i < rows * 3; i += kThreads) st[i] = cw[i];
  __syncthreads();
  // live rows: one ballot a warp over 32 consecutive rows, queued by the
  // lanes they take
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = j * kThreads + threadIdx.x;
    if (j * kThreads >= tile_rows) break;
    int qi = -1;
    if (vf[j]) {
      const int nv = (int)(st[r * 3] & 0xF);
      if (nv >= 2 && nv <= kMaxNv && meta[kMaxNv + 1 + nv] > 0) {
        qi = queue_of(nv);
      }
    }
    const unsigned lm = __ballot_sync(0xffffffffu, qi >= 0);
    if (lane == 0 && r < tile_rows) live[r >> 5] = lm;
#pragma unroll
    for (int c = 0; c < kQueues; ++c) {
      const unsigned m = __ballot_sync(0xffffffffu, qi == c);
      if (m == 0u) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(&qn[c], __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (qi == c) {
        queue[c * tile_rows + at + __popc(m & ((1u << lane) - 1u))] =
            (uint16_t)r;
      }
    }
  }
  __syncthreads();
  // the other rows pass through
  int64_t* cc = canon + row0 * 3;
  for (int i = threadIdx.x; i < rows * 3; i += kThreads) {
    if (!is_live(live, i / 3)) cc[i] = st[i];
  }
  int4* so = reinterpret_cast<int4*>(sigma + row0 * kMaxNv);
  int4* ro = reinterpret_cast<int4*>(rep + row0 * kMaxNv);
  for (int i = threadIdx.x; i < rows * 2; i += kThreads) {
    if (is_live(live, i >> 1)) continue;
    const int4 id = (i & 1) ? make_int4(4, 5, 6, 7) : make_int4(0, 1, 2, 3);
    so[i] = id;
    ro[i] = id;
  }
  walk<2>(queue, qn[0], st, row0, table, meta, with_orbits, canon, sigma,
          rep);
  walk<8>(queue + tile_rows, qn[1], st, row0, table, meta, with_orbits,
          canon, sigma, rep);
  walk<32>(queue + 2 * tile_rows, qn[2], st, row0, table, meta, with_orbits,
           canon, sigma, rep);
}

}  // namespace

// codes: q x 3 int64; valid: q bool bytes; tile_rows: rows a block, a
// multiple of 8 from 8 to 1,024; table: the packed permutation rows (32
// bytes each, 16-byte aligned); meta: 18 int32, the first table row of each
// nv (index nv) then the row count of each nv (index 9 + nv, 0 for an nv
// outside the launch); canon: q x 3 int64; sigma, rep: q x 8 int32, 16-byte
// aligned. Returns cudaErrorInvalidValue for a tile_rows out of range, else
// cudaGetLastError().
extern "C" int repro_canonical_refine(const void* codes, const void* valid,
                                      long long q, int tile_rows,
                                      const void* table, const void* meta,
                                      int with_orbits, void* canon,
                                      void* sigma, void* rep, void* stream) {
  if (tile_rows < kMinTile || tile_rows > kMaxTile || tile_rows % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t blocks = (q + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)tile_rows * 3 * sizeof(int64_t) +
                      (size_t)(tile_rows + 31) / 32 * sizeof(uint32_t) +
                      (size_t)kQueues * tile_rows * sizeof(uint16_t);
  if (blocks > 0) {
    refine_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        (const int64_t*)codes, (const uint8_t*)valid, q, tile_rows,
        (const uint4*)table, (const int*)meta, with_orbits != 0,
        (int64_t*)canon, (int*)sigma, (int*)rep);
  }
  return (int)cudaGetLastError();
}
