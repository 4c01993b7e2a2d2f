// Stable LSB radix sort of the rows of a quick-code batch: one digit
// histogram of every pass (radix_hist), then one one-sweep launch per
// varying pass over carried keys (radix_scatter). kernels/radix_bin.py
// chains them into radix_sort_codes: 1 + 13 launches a sort.
//
// Replaces: src/repro/kernels/radix_bin.py:radix_sort_codes, whose 13
// passes (w2, w1, w0 a byte at a time, then the invalid flag) are two
// Pallas kernels each: _hist_kernel (per-block digit histogram) and
// _scatter_kernel (stable scatter with a per-digit write cursor carried
// across a grid that runs in order, seeded from a jnp exclusive scan).
//
// Bound on this card: bytes. The design moves each row's bytes as few
// times as the sort allows:
//   radix_hist    one read of codes and valid (25 B a row), coalesced, in
//                 a grid of persistent blocks. Each row's 13 digits are
//                 counted at once into 13 x 256 shared counters, one add
//                 per distinct digit per warp (__match_any_sync), so a
//                 skewed digit costs no same-address atomics per row; the
//                 blocks then add their non-zero counters into device
//                 memory. The last block to finish (an atomic counter)
//                 turns the counts into each pass's exclusive digit bases
//                 and writes the plan: the number of passes whose digit
//                 varies, then their indices, least significant first. A
//                 pass whose digit is constant permutes nothing and is
//                 never run. In the same read the three code words are
//                 written as int32 arrays (12 B a row), so that a pass
//                 that starts a word gathers 4 bytes a row, not a sector
//                 of the 24-byte rows.
//   radix_scatter launch i runs the plan's i-th pass, and returns at once
//                 when i is past the count, so the host never reads the
//                 plan. Blocks take 4,096-row tiles from a counter, so a
//                 tile waits only on tiles that are already running. Each
//                 tile loads its rows' carried key (the pass's 32-bit word,
//                 in the current order) and order: read coalesced from the
//                 previous pass when that pass sorted by the same word,
//                 else gathered through the order (the first pass reads
//                 the rows in place). It ranks its rows stably by digit
//                 (__match_any_sync within a warp, skipped when the warp's
//                 digit is uniform; per-warp counts in warp order),
//                 publishes its 256 digit counts and adds up the earlier
//                 tiles' by a decoupled look-back four tiles at a read
//                 (scan.cuh; Merrill & Garland 2016, Adinets & Merrill
//                 2022), stages the tile sorted by digit in shared memory
//                 and stores order and key in digit-contiguous runs. The
//                 key is stored only when the next pass sorts by the same
//                 word; the last pass stores, instead of keys, the rows'
//                 codes and valid flags in the sorted order (the sort's
//                 outputs), so no gather follows the sort.
// Ping-pong parity is resolved on the device: pass i reads buffer i & 1
// and writes buffer (i + 1) & 1, and the last varying pass writes the
// caller's outputs; with no varying pass, launch 0 writes the identity.
// The per-tile digit statuses carry the pass's launch index as a tag, so
// one memset a sort (in radix_hist's call) serves every pass.
#include "scan.cuh"

namespace {

using namespace repro;

constexpr int kDigits = 256;
constexpr int kPasses = 13;                      // _PASSES in radix_bin.py
constexpr int kHistUnroll = 4;                   // rows a thread loads at once
constexpr int kHistBlocksPerSM = 4;
constexpr int kPassItems = 16;                   // rows a thread, a tile
constexpr int kPassBlocksPerSM = 2;              // register budget: 128
constexpr int kLookbackWindow = 4;               // tiles a look-back read
constexpr int kOutFlight = 4;                    // output rows loaded at once
constexpr int kWarpRows = kPassItems * 32;
constexpr int kTileRows = kThreads * kPassItems; // RADIX_TILE in radix_bin.py
// scratch: the header (counts, the finish counter, the 13 tile counters),
// then kDigits status words a tile
constexpr int kHeaderWords = 2048;
constexpr int kCountsInts = kPasses * kDigits;
static_assert(kThreads == kDigits, "one thread per digit");
static_assert(kLookbackDigits == kDigits, "scan.cuh's status layout");
static_assert(kCountsInts + 1 + kPasses <= 2 * kHeaderWords, "header");

struct PassShared {
  int wcount[kWarps][kDigits];   // per-warp digit counts, then offsets
  uint32_t key[kTileRows];       // the tile, sorted by digit
  int row[kTileRows];
  int start[kDigits];            // tile-local start of each digit's run
  int gbase[kDigits];            // its global position less that start
  int scan[kWarps + 1];
  long long tile;
};
// the whole tile is staged in static shared memory, within the 48 KB a
// block may have without an opt-in
static_assert(sizeof(PassShared) <= 48 * 1024, "pass kernel shared memory");

// pass p of _PASSES: word 2, 1, 0 a byte at a time, then the flag (word 3)
__device__ __forceinline__ int pass_word(int p) {
  return p == kPasses - 1 ? 3 : 2 - p / 4;
}
__device__ __forceinline__ int pass_shift(int p) {
  return p == kPasses - 1 ? 0 : 8 * (p & 3);
}

// Digit of pass p from a row's four words (w0, w1, w2, flag).
__device__ __forceinline__ uint32_t row_digit(const uint32_t* w, int p) {
  return (w[pass_word(p)] >> pass_shift(p)) & 0xFFu;
}

// The lanes of the warp that hold this lane's d (the pass kernel's rank):
// all of them when every lane holds the same value (a constant or heavily
// skewed digit: one vote), else one __match_any_sync.
__device__ __forceinline__ unsigned peers_of(uint32_t d) {
  if (__all_sync(0xffffffffu, d == __shfl_sync(0xffffffffu, d, 0))) {
    return 0xffffffffu;
  }
  return __match_any_sync(0xffffffffu, d);
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint32_t* __restrict__ codes,  // (n, 3) int64 as u32
                  const uint8_t* __restrict__ valid, int64_t n,
                  uint32_t* __restrict__ words,       // 3 x n
                  unsigned* __restrict__ counts, unsigned* __restrict__ done,
                  int* __restrict__ plan, int* __restrict__ bases) {
  __shared__ unsigned s_count[kPasses][kDigits];
  __shared__ int s_scan[kWarps + 1];
  __shared__ bool s_last;
  for (int k = threadIdx.x; k < kCountsInts; k += kThreads) {
    (&s_count[0][0])[k] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * kThreads * kHistUnroll;
  for (int64_t base = ((int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31))
                      * kHistUnroll;
       base < n; base += step) {
    // a warp takes kHistUnroll x 32 consecutive rows; all loads first
    uint32_t w[kHistUnroll][4];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t r = base + u * 32 + lane;
      if (r < n) {
#pragma unroll
        for (int k = 0; k < 3; ++k) w[u][k] = codes[(r * 3 + k) * 2];
        w[u][3] = valid[r] ? 0u : 1u;
      }
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t r = base + u * 32 + lane;
      const bool live = r < n;
      if (live) {
#pragma unroll
        for (int k = 0; k < 3; ++k) words[k * n + r] = w[u][k];
      }
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const uint32_t d = live ? row_digit(w[u], p) : (uint32_t)kDigits;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (live && (__ffs(peers) - 1) == lane) {
          atomicAdd(&s_count[p][d], (unsigned)__popc(peers));
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kCountsInts; k += kThreads) {
    const unsigned v = (&s_count[0][0])[k];
    if (v) atomicAdd(counts + k, v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: every block's counts are in; bases and the plan
  __threadfence();
  const int d = threadIdx.x;
  int nvary = 0;                       // meaningful in thread 0
  for (int p = 0; p < kPasses; ++p) {
    const int c = (int)__ldcg(counts + p * kDigits + d);
    int total;
    bases[p * kDigits + d] = block_exclusive_scan(c, s_scan, &total);
    // a pass varies unless one digit holds every row
    if (!__syncthreads_or((int64_t)c == n) && threadIdx.x == 0) {
      plan[1 + nvary++] = p;
    }
  }
  if (threadIdx.x == 0) {
    plan[0] = nvary;
    for (int k = nvary; k < kPasses; ++k) plan[1 + k] = -1;
  }
}

// The buffers of one sort (radix_bin.py:RadixScratch), passed by value.
struct PassArgs {
  const int* plan;
  const int* bases;
  const int64_t* codes;              // (n, 3)
  const uint32_t* words;             // (3, n)
  const uint8_t* valid;
  int64_t n;
  int64_t n_tiles;
  unsigned long long* status;
  unsigned* next_tile;
  int* order0;                       // the ping-pong buffers
  int* order1;
  uint32_t* keys0;
  uint32_t* keys1;
  int* out;                          // the sorted order
  int64_t* codes_out;                // codes[out]
  uint8_t* valid_out;                // valid[out]
};

__global__ void __launch_bounds__(kThreads, kPassBlocksPerSM)
radix_pass_kernel(int i, const PassArgs a) {
  __shared__ PassShared sh;
  const int nvary = a.plan[0];
  const int64_t n = a.n;
  if (i >= nvary) {
    if (i == 0) {
      // nothing varies: the order is the identity
      for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < n;
           r += (int64_t)gridDim.x * kThreads) {
        a.out[r] = (int)r;
#pragma unroll
        for (int k = 0; k < 3; ++k) a.codes_out[r * 3 + k] = a.codes[r * 3 + k];
        a.valid_out[r] = a.valid[r];
      }
    }
    return;
  }
  const int p = a.plan[1 + i];
  const int word = pass_word(p), shift = pass_shift(p);
  const bool gather = i == 0 || pass_word(a.plan[i]) != word;
  const bool last = i == nvary - 1;
  const bool carry = !last && pass_word(a.plan[2 + i]) == word;
  // selects, not indexing: a parameter array indexed at run time would be
  // copied to local memory
  const bool odd = i & 1;
  const int* __restrict__ order_in = odd ? a.order1 : a.order0;
  const uint32_t* __restrict__ keys_in = odd ? a.keys1 : a.keys0;
  int* __restrict__ order_out = last ? a.out : odd ? a.order0 : a.order1;
  uint32_t* __restrict__ keys_out = odd ? a.keys0 : a.keys1;
  const int* __restrict__ pbase = a.bases + p * kDigits;
  // the key: carried at r, or the row's word
  const uint32_t* __restrict__ src = gather ? a.words + word * n : keys_in;
  const unsigned tag = (unsigned)i + 1u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int me = threadIdx.x;          // this thread's digit below

  for (;;) {
    if (threadIdx.x == 0) sh.tile = atomicAdd(a.next_tile + i, 1u);
    for (int k = lane; k < kDigits; k += 32) sh.wcount[warp][k] = 0;
    __syncthreads();
    const int64_t tile = sh.tile;
    if (tile >= a.n_tiles) break;
    const int64_t first = tile * kTileRows + warp * kWarpRows + lane;
    uint32_t key[kPassItems];
    int row[kPassItems];
    // one load instruction an item: the branches are uniform and sit
    // outside the unrolled loops, so all the tile's loads are in flight
    // together
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < kPassItems; ++j) row[j] = (int)(first + j * 32);
    } else {
#pragma unroll
      for (int j = 0; j < kPassItems; ++j) {
        const int64_t r = first + j * 32;
        row[j] = r < n ? order_in[r] : 0;
      }
    }
    if (gather && word == 3) {
#pragma unroll
      for (int j = 0; j < kPassItems; ++j) {
        key[j] = first + j * 32 < n ? (a.valid[row[j]] ? 0u : 1u) : 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPassItems; ++j) {
        const int64_t r = first + j * 32;
        key[j] = r < n ? src[gather ? (int64_t)row[j] : r] : 0u;
      }
    }
    // stable rank within the warp: rows before this one in earlier steps
    // (the warp's running count) and at lower lanes of this step; below
    // 512, so two ranks share a register
    uint32_t rank[kPassItems / 2];
#pragma unroll
    for (int j = 0; j < kPassItems; ++j) {
      const bool live = first + j * 32 < n;
      const uint32_t d = live ? (key[j] >> shift) & 0xFFu : (uint32_t)kDigits;
      const unsigned peers = peers_of(d);
      const int before = live ? sh.wcount[warp][d] : 0;
      __syncwarp();
      if (live && (peers & below) == 0u) {
        sh.wcount[warp][d] = before + __popc(peers);
      }
      __syncwarp();
      const uint32_t rk = before + __popc(peers & below);
      rank[j / 2] = j & 1 ? rank[j / 2] | rk << 16 : rk;
    }
    __syncthreads();
    // this digit's count in each warp -> offsets in warp order
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.wcount[w][me];
      sh.wcount[w][me] = count;
      count += c;
    }
    unsigned long long* st = a.status + tile * kDigits;
    int excl = 0;
    if (tile == 0) {
      digit_publish(st, me, tag, kDigitPrefix, count);
    } else {
      digit_publish(st, me, tag, kDigitAggregate, count);
      excl = digit_lookback<kLookbackWindow>(a.status, tile, me, tag);
      digit_publish(st, me, tag, kDigitPrefix, excl + count);
    }
    int total;
    const int start = block_exclusive_scan(count, sh.scan, &total);
    sh.start[me] = start;
    sh.gbase[me] = pbase[me] + excl - start;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPassItems; ++j) {
      if (first + j * 32 < n) {
        const uint32_t d = (key[j] >> shift) & 0xFFu;
        const int local = sh.start[d] + sh.wcount[warp][d]
                          + (int)(rank[j / 2] >> (16 * (j & 1)) & 0xFFFFu);
        sh.key[local] = key[j];
        sh.row[local] = row[j];
      }
    }
    __syncthreads();
    // neighbouring threads store neighbouring slots of a digit's run
    const int64_t left = n - tile * kTileRows;
    const int rows = left < kTileRows ? (int)left : kTileRows;
    if (last) {
      // the sort's outputs: the order, and the rows' codes and valid flags
      // gathered in it; kOutFlight slots' loads in flight before their
      // stores
#pragma unroll
      for (int j0 = 0; j0 < kPassItems; j0 += kOutFlight) {
        int pos[kOutFlight], r[kOutFlight];
        int64_t c[kOutFlight][3];
        uint8_t v[kOutFlight];
#pragma unroll
        for (int u = 0; u < kOutFlight; ++u) {
          const int k = (j0 + u) * kThreads + threadIdx.x;
          if (k < rows) {
            pos[u] = sh.gbase[(sh.key[k] >> shift) & 0xFFu] + k;
            r[u] = sh.row[k];
#pragma unroll
            for (int w = 0; w < 3; ++w) {
              c[u][w] = a.codes[(int64_t)r[u] * 3 + w];
            }
            v[u] = a.valid[r[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kOutFlight; ++u) {
          if ((j0 + u) * kThreads + threadIdx.x < rows) {
            order_out[pos[u]] = r[u];
#pragma unroll
            for (int w = 0; w < 3; ++w) {
              a.codes_out[(int64_t)pos[u] * 3 + w] = c[u][w];
            }
            a.valid_out[pos[u]] = v[u];
          }
        }
      }
    } else {
      for (int k = threadIdx.x; k < rows; k += kThreads) {
        const uint32_t v = sh.key[k];
        const int pos = sh.gbase[(v >> shift) & 0xFFu] + k;
        order_out[pos] = sh.row[k];
        if (carry) keys_out[pos] = v;
      }
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

int64_t tiles_of(int64_t n) { return (n + kTileRows - 1) / kTileRows; }

// Scratch words (8 bytes) a sort of n rows needs (RadixScratch in
// kernels/radix_bin.py).
int64_t scratch_words(int64_t n) { return kHeaderWords + tiles_of(n) * kDigits; }

// Persistent grid sizes on the current device, queried once per device.
struct Grids {
  int hist = 0;
  int pass = 0;
};

Grids grids() {
  static Grids cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  Grids& g = cached[dev & 63];
  if (g.pass == 0) {
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, radix_pass_kernel,
                                                  kThreads, 0);
    sms = sms > 0 ? sms : 1;
    g.hist = sms * kHistBlocksPerSM;
    g.pass = sms * (per > 0 ? per : 1);
  }
  return g;
}

}  // namespace

extern "C" int repro_radix_tile() { return kTileRows; }

// codes: n x 3 int64; valid: n bool bytes; words: 3 x n int32, written
// here; scratch: 2,048 + 256 x ceil(n / 4,096) words, cleared here;
// plan: 1 + 13 int32; bases: 13 x 256 int32. Returns the memset's error,
// else cudaGetLastError() after the launch.
extern "C" int repro_radix_hist(const void* codes, const void* valid,
                                long long n, void* words, void* scratch,
                                void* plan, void* bases, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)scratch_words(n) * 8, s);
  if (e != cudaSuccess) return (int)e;
  // at least one block: with no rows it writes an empty plan
  const int64_t want = (n + kThreads * kHistUnroll - 1)
                       / (kThreads * kHistUnroll);
  const int64_t blocks =
      want < 1 ? 1 : (want < grids().hist ? want : grids().hist);
  unsigned* header = (unsigned*)scratch;
  radix_hist_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint32_t*)codes, (const uint8_t*)valid, n, (uint32_t*)words,
      header, header + kCountsInts, (int*)plan, (int*)bases);
  return (int)cudaGetLastError();
}

// Launch i (0..12) of the sort, after repro_radix_hist on the same scratch:
// the plan's i-th pass reads order/keys buffer i & 1 and writes buffer
// (i + 1) & 1; the last varying pass writes out, codes_out and valid_out.
// order0, order1, keys0, keys1, out: n int32 each; codes_out: n x 3 int64;
// valid_out: n bytes.
extern "C" int repro_radix_scatter(int i, const void* codes,
                                   const void* valid, long long n,
                                   const void* words, void* scratch,
                                   const void* plan, const void* bases,
                                   void* order0, void* order1, void* keys0,
                                   void* keys1, void* out, void* codes_out,
                                   void* valid_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = tiles_of(n);
  if (n_tiles == 0) return (int)cudaGetLastError();
  unsigned* header = (unsigned*)scratch;
  PassArgs a;
  a.plan = (const int*)plan;
  a.bases = (const int*)bases;
  a.codes = (const int64_t*)codes;
  a.words = (const uint32_t*)words;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.n_tiles = n_tiles;
  a.status = (unsigned long long*)scratch + kHeaderWords;
  a.next_tile = header + kCountsInts + 1;
  a.order0 = (int*)order0;
  a.order1 = (int*)order1;
  a.keys0 = (uint32_t*)keys0;
  a.keys1 = (uint32_t*)keys1;
  a.out = (int*)out;
  a.codes_out = (int64_t*)codes_out;
  a.valid_out = (uint8_t*)valid_out;
  const int64_t blocks = n_tiles < grids().pass ? n_tiles : grids().pass;
  radix_pass_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(i, a);
  return (int)cudaGetLastError();
}
