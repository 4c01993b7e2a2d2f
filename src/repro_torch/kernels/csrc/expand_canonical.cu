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
//   valid = cand >= 0 and cand is none of the row's k members (all k, also
//           those past n_valid) and no earlier member (q < i, q < n_valid)
//           is adjacent to cand (first-occurrence dedup)
//   keep  = valid and members[:n_valid] + [cand] is canonical (Alg. 2:
//           members[0] < cand when n_valid > 0, then the found/violation
//           scan over the valid members)
// Member rows are clamped into the tables and bitmap words into the row, as
// the JAX gathers clamp them. A slot past the degree of m_i reads the -1 pad
// and writes cand = -1, valid = keep = false: the dense (C, k, D) contract.
//
// Bound on this card: bytes. It writes 6 bytes a slot and reads each
// distinct member's neighbour row and bitmap row once; at the main path's
// chunk (C = 4,096, k = 2, D = 2,945) 76 % of that is the 144.75 MB of
// output. The first kernel gave each thread one slot and ran a chain of four
// dependent accesses (members, the neighbour word, k bitmap words from L2,
// three narrow stores): about 8 KB of loads in flight an SM where the rate
// needs ~15 KB, and 98,304 short blocks, a quarter of the bound.
//
// Design: a block (128 threads; 256 in the global variant) owns a parent at a
// time (a grid-stride loop over c; the grid holds a block a parent up to 2^20,
// so the hardware hands parents to SMs as blocks finish). The block loads the
// parent's k members and n_valid into shared memory once and, in the staged
// variant, copies the valid members' bitmap rows there (cp.async, coalesced):
// every member<->candidate bit test is then a shared-memory read. The slots are
// split into items: member row i and a window of 256 slots, aligned to the flat
// output index, that meets row i's slots. The warps of a block take the items
// in turn, so the member is uniform across a warp; a lane loads its 8 slots of
// the window (lane + 32u: each load coalesced) before it tests any, and a -1
// pad skips the bit tests. The window leaves as 16-byte streaming stores: valid
// and keep one store a lane, built from the warp's ballots (16 slots of 0/1
// bytes), cand through the warp's row of shared memory. A 16-slot or 4-slot
// group that crosses its row's edge is stored slot by slot, so the unaligned
// head and tail of a parent whose k*D is odd need no other path. Tried and
// dropped: a persistent grid with the next parent prefetched, 256 threads in
// the staged variant, 16 slots a lane, and the next window in flight during the
// tests (cp.async double buffer, or registers): none was faster.
//
// Shared-memory budget of the staged variant: k*W*4 bytes of bitmap rows up
// to kStageBytes = 100 KiB, so that two blocks (each also holding 4 KiB of
// cand rows) fit an SM's 228 KB; mico_like(0.1) stages 2 * 313 words, full
// MiCo at k = 8 stages 100,000 bytes (above 48 KB: the dynamic-shared-memory
// attribute is raised once per device). Above the budget (a Patents-scale
// W of ~117,800 words), the global variant of the same kernel reads the
// words from device memory, the k words of 4 slots issued before any is
// tested, in blocks of 256 threads; random 4-byte reads of the bitmap bound
// it, as they bound the first kernel. The wrapper picks the variant by
// shape (repro_expand_stage_bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads of a block: the staged variant's bit tests are shared-memory
// reads and it wants more blocks an SM; the global variant's random bitmap
// reads want more warps in flight in each block.
__host__ __device__ constexpr int threads(bool staged) {
  return staged ? 128 : 256;
}
constexpr int kRun = 8;                       // slots a lane in one window
constexpr int kStrip = 32 * kRun;             // slots of one window
constexpr int kStageBytes = 100 * 1024;       // staged bitmap rows, at most
constexpr int kMaxGrid = 1 << 20;             // blocks of one launch, at most

// Bits 0-15 of b -> 16 bytes of 0/1, slot order (little-endian).
__device__ __forceinline__ uint4 flag_bytes(uint32_t b) {
  uint4 v;
  v.x = ((b & 15u) * 0x204081u) & 0x01010101u;
  v.y = (((b >> 4) & 15u) * 0x204081u) & 0x01010101u;
  v.z = (((b >> 8) & 15u) * 0x204081u) & 0x01010101u;
  v.w = (((b >> 12) & 15u) * 0x204081u) & 0x01010101u;
  return v;
}

// 16 bytes, streamed: the outputs are read by the next kernel, not by this
// one, and must not push the member rows out of L2.
__device__ __forceinline__ void store16(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int clamp_row(int m, int n_rows) {
  return m < 0 ? 0 : (m < n_rows ? m : n_rows - 1);
}

// m[i] for a runtime i in [0, K), without indexing the register array.
template <int K>
__device__ __forceinline__ int pick(const int (&m)[K], int i) {
  int r = m[0];
#pragma unroll
  for (int q = 1; q < K; ++q) r = q == i ? m[q] : r;
  return r;
}

// A work item of a parent whose slots start at flat index b0: the window
// [s0, s0 + kStrip) of slots (aligned to the flat index) met by member row
// i's slots [r0, r0 + D). Items run over rows in order, then windows.
struct Item {
  int i;
  int64_t s0, r0;
};

template <int K>
__device__ __forceinline__ Item locate(int t, int64_t b0, int D) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int64_t r0 = b0 + (int64_t)i * D, w0 = r0 / kStrip;
    const int n = (int)((r0 + D - 1) / kStrip - w0 + 1);
    if (t < n) return Item{i, (w0 + t) * kStrip, r0};
    t -= n;
  }
  return Item{K - 1, 0, 0};   // t past the last item: not reached
}

template <int K>
__device__ __forceinline__ int count_items(int64_t b0, int D) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int64_t r0 = b0 + (int64_t)i * D;
    n += (int)((r0 + D - 1) / kStrip - r0 / kStrip + 1);
  }
  return n;
}

// Lane l loads slots s0 + l + 32u of the item, all before any is used;
// `row` is member i's neighbour row, or null when i >= n_valid (every slot
// is then -1), and slots outside the row read as -1.
__device__ __forceinline__ void load_item(const Item& it, const int32_t* row,
                                          int D, int (&cv)[kRun]) {
  const int j0 = (int)(it.s0 - it.r0) + (threadIdx.x & 31);
#pragma unroll
  for (int u = 0; u < kRun; ++u)
    cv[u] = row && (unsigned)(j0 + 32 * u) < (unsigned)D
                ? __ldg(row + j0 + 32 * u)
                : -1;
}

// Tests the item's loaded slots cv and stores them; win is the warp's
// row of shared memory for the cand stores.
template <int K, bool kStaged>
__device__ __forceinline__ void process(
    const Item& it, const int (&cv)[kRun], const int (&m)[K], int nvq,
    const int64_t (&arow)[K], const uint32_t* s_adj,
    const uint32_t* __restrict__ adj, int D, int words, int32_t* win,
    int32_t* __restrict__ cand_out, uint8_t* __restrict__ valid_out,
    uint8_t* __restrict__ keep_out) {
  const int lane = threadIdx.x & 31;
  const int64_t s0 = it.s0, r0 = it.r0, r1 = it.r0 + D;

  // the global variant issues the bitmap words of kBatch slots before it
  // tests any of them
  constexpr int kBatch = kStaged ? kRun : 4;
  uint32_t vmask = 0, kmask = 0;   // bit u: slot u of this lane
#pragma unroll
  for (int u0 = 0; u0 < kRun; u0 += kBatch) {
    uint32_t wd[kStaged ? 1 : kBatch][K];
    if constexpr (!kStaged) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int v = cv[u0 + u] > 0 ? cv[u0 + u] : 0;
        const int col = (v >> 5) < words - 1 ? (v >> 5) : words - 1;
#pragma unroll
        for (int q = 0; q < K; ++q)
          wd[u][q] = cv[u0 + u] >= 0 && q < nvq ? __ldg(adj + arow[q] + col)
                                                : 0u;
      }
    }
#pragma unroll
    for (int u = u0; u < u0 + kBatch; ++u) {
      const int v = cv[u];
      if (v < 0) continue;          // a pad: no bit tests
      const int col = (v >> 5) < words - 1 ? (v >> 5) : words - 1;
      bool is_member = false, seen_earlier = false, found = false,
           violation = false;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        is_member |= m[q] == v;
        if (q < nvq) {
          uint32_t w;
          if constexpr (kStaged) w = s_adj[q * words + col];
          else w = wd[u - u0][q];
          const bool adjacent = ((w >> (v & 31)) & 1u) != 0;
          seen_earlier |= adjacent && q < it.i;
          violation |= found && m[q] > v;
          found |= adjacent;
        }
      }
      const bool valid = !is_member && !seen_earlier;
      vmask |= (uint32_t)valid << u;
      kmask |= (uint32_t)(valid && m[0] < v && !violation) << u;  // nv > 0
    }
  }

  // the 32 16-slot flag groups of the window: lane l < 16 stores valid's
  // group l, lane l >= 16 keep's group l - 16; group g is half of ballot
  // row g / 2
  uint32_t flags = 0;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const uint32_t vb = __ballot_sync(0xffffffffu, (vmask >> u) & 1u);
    const uint32_t kb = __ballot_sync(0xffffffffu, (kmask >> u) & 1u);
    if (((lane & 15) >> 1) == u) flags = lane < 16 ? vb : kb;
  }

  // cand: 16-byte groups of 4 slots through the warp's shared row
#pragma unroll
  for (int u = 0; u < kRun; ++u) win[32 * u + lane] = cv[u];
  __syncwarp();
#pragma unroll
  for (int e = lane; e < kStrip / 4; e += 32) {
    const int64_t g = s0 + 4 * e;
    if (g >= r0 && g + 4 <= r1) {
      store16(cand_out + g, *reinterpret_cast<const uint4*>(win + 4 * e));
    } else {
      for (int b = 0; b < 4; ++b)
        if (g + b >= r0 && g + b < r1) cand_out[g + b] = win[4 * e + b];
    }
  }
  // valid and keep: 16 slots of 0/1 bytes a group, one 16-byte store
  const int group = lane & 15;
  const uint32_t bits = (flags >> (16 * (group & 1))) & 0xffffu;
  uint8_t* out = lane < 16 ? valid_out : keep_out;
  const int64_t g = s0 + 16 * group;
  if (g >= r0 && g + 16 <= r1) {
    store16(out + g, flag_bytes(bits));
  } else {
    for (int b = 0; b < 16; ++b)
      if (g + b >= r0 && g + b < r1) out[g + b] = (bits >> b) & 1u;
  }
}

template <int K, bool kStaged>
__global__ void __launch_bounds__(threads(kStaged))
expand_canonical_kernel(const int32_t* __restrict__ members,
                        const int32_t* __restrict__ n_valid,
                        const int32_t* __restrict__ nbr,
                        const uint32_t* __restrict__ adj, int C, int D,
                        int n_rows, int words, int32_t* __restrict__ cand_out,
                        uint8_t* __restrict__ valid_out,
                        uint8_t* __restrict__ keep_out) {
  extern __shared__ uint32_t s_adj[];         // staged: K rows of W words
  __shared__ int s_par[K + 1];                // members, n_valid
  constexpr int kThreads = threads(kStaged), kWarps = kThreads / 32;
  __shared__ __align__(16) int32_t s_win[kWarps][kStrip];
  const int warp = threadIdx.x >> 5;

  for (int c = blockIdx.x; c < C; c += gridDim.x) {
    if (threadIdx.x <= K)
      s_par[threadIdx.x] = threadIdx.x < K
                               ? members[(int64_t)c * K + threadIdx.x]
                               : n_valid[c];
    __syncthreads();
    int m[K];
#pragma unroll
    for (int q = 0; q < K; ++q) m[q] = s_par[q];
    const int nv = s_par[K];
    const int nvq = nv < 0 ? 0 : (nv < K ? nv : K);   // members tested
    int64_t arow[K];                                   // bitmap row offsets
#pragma unroll
    for (int q = 0; q < K; ++q)
      arow[q] = (int64_t)clamp_row(m[q], n_rows) * words;
    if (kStaged) {
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (q < nvq)
          for (int w = threadIdx.x; w < words; w += kThreads)
            cp_async4(s_adj + q * words + w, adj + arow[q] + w);
    }
    cp_async_wait_all();
    __syncthreads();

    // warp w takes items w, w + kWarps, ... (a loop bounded by the count
    // measured faster than one that stops where locate finds no item)
    const int64_t b0 = (int64_t)c * K * D;
    const int total = count_items<K>(b0, D);
    for (int t = warp; t < total; t += kWarps) {
      const Item it = locate<K>(t, b0, D);
      const int32_t* row =
          it.i < nvq ? nbr + (int64_t)clamp_row(pick(m, it.i), n_rows) * D
                     : nullptr;
      int cv[kRun];
      load_item(it, row, D, cv);
      process<K, kStaged>(it, cv, m, nvq, arow, s_adj, adj, D, words,
                          s_win[warp], cand_out, valid_out, keep_out);
      __syncwarp();
    }
    __syncthreads();                // s_par and s_adj are reused
  }
}

// Lets the staged variant take kStageBytes of dynamic shared memory (above
// the 48 KB default), once per device.
template <int K>
cudaError_t allow_stage_bytes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || done[dev & 63]) return err;
  err = cudaFuncSetAttribute(expand_canonical_kernel<K, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageBytes);
  if (err == cudaSuccess) done[dev & 63] = true;
  return err;
}

template <int K, bool kStaged>
int launch(const void* members, const void* n_valid, const void* nbr,
           const void* adj, int C, int D, int n_rows, int words, void* cand,
           void* valid, void* keep, cudaStream_t stream) {
  const int smem = kStaged ? K * words * 4 : 0;
  if (kStaged) {
    const cudaError_t err = allow_stage_bytes<K>();
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = C < kMaxGrid ? C : kMaxGrid;
  expand_canonical_kernel<K, kStaged>
      <<<grid, threads(kStaged), smem, stream>>>(
      (const int32_t*)members, (const int32_t*)n_valid, (const int32_t*)nbr,
      (const uint32_t*)adj, C, D, n_rows, words, (int32_t*)cand,
      (uint8_t*)valid, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

template <bool kStaged>
int launch_k(int k, const void* members, const void* n_valid, const void* nbr,
             const void* adj, int C, int D, int n_rows, int words, void* cand,
             void* valid, void* keep, cudaStream_t s) {
#define REPRO_EXPAND_K(K)                                                     \
  case K:                                                                     \
    return launch<K, kStaged>(members, n_valid, nbr, adj, C, D, n_rows,       \
                              words, cand, valid, keep, s);
  switch (k) {
    REPRO_EXPAND_K(1)
    REPRO_EXPAND_K(2)
    REPRO_EXPAND_K(3)
    REPRO_EXPAND_K(4)
    REPRO_EXPAND_K(5)
    REPRO_EXPAND_K(6)
    REPRO_EXPAND_K(7)
    REPRO_EXPAND_K(8)
  }
#undef REPRO_EXPAND_K
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Most bytes of bitmap rows (k * W * 4) the staged variant holds.
extern "C" int repro_expand_stage_bytes() { return kStageBytes; }

// staged: 1 for the shared-memory variant (k * words * 4 must be at most
// repro_expand_stage_bytes()), 0 for the global-read one. Output pointers
// are 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_expand_canonical(const void* members, const void* n_valid,
                                      const void* nbr, const void* adj,
                                      long long C, int k, long long D,
                                      long long n_rows, long long words,
                                      int staged, void* cand, void* valid,
                                      void* keep, void* stream) {
  if (C <= 0 || D <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > 8 || n_rows < 1 || words < 1 || C * k * D > INT32_MAX ||
      n_rows > INT32_MAX || words > INT32_MAX ||
      (staged && (long long)k * words * 4 > kStageBytes))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return staged ? launch_k<true>(k, members, n_valid, nbr, adj, (int)C,
                                 (int)D, (int)n_rows, (int)words, cand, valid,
                                 keep, s)
                : launch_k<false>(k, members, n_valid, nbr, adj, (int)C,
                                  (int)D, (int)n_rows, (int)words, cand,
                                  valid, keep, s);
}
