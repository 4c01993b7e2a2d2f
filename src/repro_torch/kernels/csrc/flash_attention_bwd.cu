// The gradient of flash_attention.cu: causal / windowed / full attention
// with grouped-query heads, bf16 or f32:
//   q (B, Sq, H, D), k and v (B, Sk, KV, D), out and dout (B, Sq, H, D),
//   all read at their strides (the last dimension contiguous), and the
//   forward's lse (B, H, Sq) f32 (each row's log-sum-exp of its scaled
//   scores, natural log)
//   -> dq (B, Sq, H, D), dk and dv (B, Sk, KV, D), contiguous, in q's type;
//   dk and dv summed over the H / KV query heads of each KV head.
// The same function as the forward: the start-aligned causal mask (key j
// kept for query i when i >= j, both from 0, also when Sq != Sk), a window
// w > 0 (key j dropped when j <= i - w), or no mask; D a multiple of 8 up
// to 256; scale D^-1/2.
//
// Replaces no TPU kernel. The JAX package trains through jnp attention
// (models/layers.py's blocked attention, differentiated by XLA) and has no
// backward kernel; the port's training path needs one because its forward
// is a hand-written kernel that autograd cannot see into.
//
// What it computes (FlashAttention-2's backward):
//   P_ij = exp(S_ij scale - lse_i), S = Q K^T          (recomputed)
//   dP = dO V^T,  delta_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - delta_i)
//   dV = P^T dO,  dK = dS^T Q scale,  dQ = dS K scale.
// P is recomputed from the lse, so the backward differentiates the exact
// softmax that the bf16 forward approximates (it rounds P before P V).
// No atomics anywhere: every sum runs in a fixed order, so two calls give
// the same bits (the training loop's bit-exact resume rests on it).
//
// Bound on this card: operations. A kept (q, k) pair of one head costs
// 10 D flops at the least (QK^T, dO V^T, P^T dO, dS^T Q, dS K). At the
// training shape (stablelm-1.6b: B = 4, S = 2,048, 32 heads of 64, causal)
// that is 1.7e11 flops a layer, 0.174 ms at the bf16 tensor cores' 989
// TFLOP/s of an H100 SXM at its 700 W limit. The CUDA-core kernels that
// came first took 13.0-13.2 ms there; these take 1.38-1.46 ms (NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py 13a, PERF.md).
//
// bf16 (the model's type): every product on the tensor cores (wgmma), every
// tile fed by TMA (hopper.cuh, shared with the forward). Two launches (three
// at D > 64), dQ first:
//   1. dQ and delta: one CTA per (q tile, head, batch), the longest causal
//      q tiles first; 64 q rows per consumer warpgroup (two at D <= 128,
//      one at D = 256) and one producer warp. The producer loads Q and dO
//      once, then streams 64-row K and V tiles (each on its own mbarrier)
//      through a two-stage ring, twice. Each pass forms S = Q K^T and then
//      dP = dO V^T by wgmma m64n64k16 from shared memory (K-major), and P
//      in f32 registers from the lse (times log2 e, one ex2; +inf for rows
//      past Sq or without a key, so P = 0 there) while dP runs. The first
//      pass sums delta = rowsum(P o dP) and writes it out; the second forms
//      dS = P (dP - delta) and adds dQ += dS K with wgmma m64n{D}k16, A from
//      registers and K read N-major through the transpose bit. Tiles wholly
//      before a q tile's window are skipped, as the forward skips them.
//   2. dK/dV: one CTA per (key tile, KV head, batch), key tile 0 (the most
//      causal queries) first; 64 key rows per consumer warpgroup. The
//      producer loads the K and V tile once, then streams the 64-row Q and
//      dO tiles of every head of the group and every q tile the mask keeps,
//      its 32 lanes staging each tile's lse and delta in shared memory
//      beside it, since here they are indexed by column. The consumers form
//      S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and dS^T in
//      registers (the accumulator of S^T is already the A fragment of the
//      next products), and add dV += P^T dO and dK += dS^T Q with dO and Q
//      read N-major, as the forward reads V. At D = 64 both sums fit in
//      registers (64 floats a thread, 160-168 registers under the 288-thread
//      block's cap); above, a dV pass and a dK pass (64 or 128 floats a
//      thread each) keep the consumers under it.
// Precision. P goes to the dV product rounded to bf16, as FlashAttention
// does. dS goes to the dK and dQ products as two bf16 terms (hi + lo,
// about 16 bits), and delta is the softmax's own row sum rather than
// FlashAttention's dO . out: dS sums to zero along each query row, so an
// error in dS or in delta reaches dQ times the keys' common component,
// which trained activations carry, and both forms missed the bf16 error
// rule on stablelm-1.6b's training activations (PERF.md). Each
// output is rounded once from its f32 sum. The tensor maps' zero fill pads
// ragged rows and D up to the tile width (64, 128 or 256).
//
// f32 (off the model's path): the first CUDA-core kernels, unchanged: a
// warp per row forms delta = dO . out, and a 256-thread block keeps its
// tiles in shared memory as f32 (64 x 64, or 32 x 32 at D = 256, rows
// padded by one word) and forms S, dP and the sums per thread with fmaf.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// Element strides of one (B, S, heads, D) operand.
struct Strides {
  long long b, s, h;
};

template <int DMAX>  // D padded: 64, 128 or 256
struct Cfg {
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;  // q rows a tile
  static constexpr int BK = BQ;                     // k rows a tile
  static constexpr int LD = DMAX + 1;               // padded operand row
  static constexpr int LDS = BK + 1;                // padded score row
  static constexpr int SR = BQ / 16;  // score rows a thread (and dQ rows)
  static constexpr int SC = BK / 16;  // score columns a thread
  static constexpr int KR = BK / 16;  // dK / dV rows a thread
  static constexpr int NC = DMAX / 16;  // accumulator columns a thread
  // two operand tiles of BQ rows, two of BK rows, P and dS, lse and delta
  static constexpr size_t SMEM =
      sizeof(float) *
      ((size_t)(2 * BQ + 2 * BK) * LD + 2 * (size_t)BQ * LDS + 2 * BQ);
};

// rows x DMAX of a (B, S, heads, D) operand into shared memory as f32,
// zero past S and past D.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int head, int r0,
                                          int rows, int n, int d) {
  const T* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    float val = 0.f;
    if (r0 + r < n && c < d) val = to_f(base[(int64_t)(r0 + r) * st.s + c]);
    dst[r * (DMAX + 1) + c] = val;
  }
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int sq, int sk,
                                     int causal, int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// This thread's block of S = Q K^T and dP = dO V^T (rows rg SR + i, columns
// cg + 16 j), turned into P and dS in shared memory.
template <int DMAX>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float* sdS, int q0, int k0,
                                       int sq, int sk, int d, int causal,
                                       int window, float scale) {
  using C = Cfg<DMAX>;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[C::SR][C::SC], dp[C::SR][C::SC];
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float qa[C::SR], ga[C::SR], ka[C::SC], va[C::SC];
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      qa[i] = sQ[(rg * C::SR + i) * C::LD + c];
      ga[i] = sdO[(rg * C::SR + i) * C::LD + c];
    }
#pragma unroll
    for (int j = 0; j < C::SC; ++j) {
      ka[j] = sK[(cg + 16 * j) * C::LD + c];
      va[j] = sV[(cg + 16 * j) * C::LD + c];
    }
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < C::SC; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int row = rg * C::SR + i;
    const float l = sL[row], delta = sD[row];
#pragma unroll
    for (int j = 0; j < C::SC; ++j) {
      const int col = cg + 16 * j;
      const bool ok = kept(q0 + row, k0 + col, sq, sk, causal, window) &&
                      l != -INFINITY;
      const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
      sP[row * C::LDS + col] = p;
      sdS[row * C::LDS + col] = p * (dp[i][j] - delta);
    }
  }
}

// Stages lse and delta of q rows q0 .. q0 + BQ - 1 of (b, head).
template <int DMAX>
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int64_t off, int q0, int sq) {
  for (int r = threadIdx.x; r < Cfg<DMAX>::BQ; r += kThreads) {
    const bool in = q0 + r < sq;
    sL[r] = in ? lse[off + q0 + r] : -INFINITY;
    sD[r] = in ? delta[off + q0 + r] : 0.f;
  }
}

// delta (B, H, Sq) = rowsum(dO o O), one warp a row (f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int sq, int n_heads, int d,
             long long rows, Strides so, Strides sdo) {
  const long long w =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int i = (int)(w % sq);
  const int head = (int)((w / sq) % n_heads);
  const long long b = w / ((long long)sq * n_heads);
  const T* orow = o + b * so.b + (int64_t)i * so.s + head * so.h;
  const T* grow = dout + b * sdo.b + (int64_t)i * sdo.s + head * sdo.h;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f(orow[c]) * to_f(grow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[w] = s;
}

// f32: dK and dV of a k tile on the CUDA cores.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
            int n_heads, int n_kv, int d, Strides qs, Strides ks, Strides vs,
            Strides gs, int causal, int window, float scale) {
  using C = Cfg<DMAX>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + C::BK * C::LD;
  float* sQ = sV + C::BK * C::LD;
  float* sdO = sQ + C::BQ * C::LD;
  float* sP = sdO + C::BQ * C::LD;
  float* sdS = sP + C::BQ * C::LDS;
  float* sL = sdS + C::BQ * C::LDS;
  float* sD = sL + C::BQ;

  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int k0 = blockIdx.x * C::BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv;
  load_tile<T, DMAX>(sK, k, ks, b, kvh, k0, C::BK, sk, d);
  load_tile<T, DMAX>(sV, v, vs, b, kvh, k0, C::BK, sk, d);

  float acc_k[C::KR][C::NC], acc_v[C::KR][C::NC];
#pragma unroll
  for (int i = 0; i < C::KR; ++i)
#pragma unroll
    for (int j = 0; j < C::NC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the queries that keep a key of this tile: q >= k0 (causal) and
  // q < k_last + window (window)
  const int k_last = min(k0 + C::BK, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const int64_t off = ((int64_t)b * n_heads + head) * sq;
    for (int q0 = (q_lo / C::BQ) * C::BQ; q0 < q_hi; q0 += C::BQ) {
      __syncthreads();  // the previous tile is done with sQ, sdO, sP, sdS
      load_tile<T, DMAX>(sQ, q, qs, b, head, q0, C::BQ, sq, d);
      load_tile<T, DMAX>(sdO, dout, gs, b, head, q0, C::BQ, sq, d);
      load_rows<DMAX>(sL, sD, lse, delta, off, q0, sq);
      __syncthreads();
      scores<DMAX>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, sq, sk, d,
                   causal, window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (rows past Sq hold P = dS = 0)
      const int rows = min(C::BQ, sq - q0);
      for (int r = 0; r < rows; ++r) {
        float p[C::KR], ds[C::KR], g[C::NC], qv[C::NC];
#pragma unroll
        for (int i = 0; i < C::KR; ++i) {
          p[i] = sP[r * C::LDS + rg * C::KR + i];
          ds[i] = sdS[r * C::LDS + rg * C::KR + i];
        }
#pragma unroll
        for (int j = 0; j < C::NC; ++j) {
          g[j] = sdO[r * C::LD + cg + 16 * j];
          qv[j] = sQ[r * C::LD + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < C::KR; ++i)
#pragma unroll
          for (int j = 0; j < C::NC; ++j) {
            acc_v[i][j] = fmaf(p[i], g[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::KR; ++i) {
    const int kpos = k0 + rg * C::KR + i;
    if (kpos >= sk) continue;
    const int64_t row = (((int64_t)b * sk + kpos) * n_kv + kvh) * d;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      const int col = cg + 16 * j;
      if (col < d) {
        dk[row + col] = from_f<T>(acc_k[i][j] * scale);
        dv[row + col] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

// f32: dQ of a q tile on the CUDA cores.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int sk, int n_heads, int n_kv, int d,
          Strides qs, Strides ks, Strides vs, Strides gs, int causal,
          int window, float scale) {
  using C = Cfg<DMAX>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + C::BK * C::LD;
  float* sQ = sV + C::BK * C::LD;
  float* sdO = sQ + C::BQ * C::LD;
  float* sP = sdO + C::BQ * C::LD;
  float* sdS = sP + C::BQ * C::LDS;
  float* sL = sdS + C::BQ * C::LDS;
  float* sD = sL + C::BQ;

  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  load_tile<T, DMAX>(sQ, q, qs, b, head, q0, C::BQ, sq, d);
  load_tile<T, DMAX>(sdO, dout, gs, b, head, q0, C::BQ, sq, d);
  load_rows<DMAX>(sL, sD, lse, delta, ((int64_t)b * n_heads + head) * sq, q0,
                  sq);

  float acc[C::SR][C::NC];
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + C::BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_first / C::BK) * C::BK; k0 < k_end; k0 += C::BK) {
    __syncthreads();  // the previous tile is done with sK, sV, sdS
    load_tile<T, DMAX>(sK, k, ks, b, kvh, k0, C::BK, sk, d);
    load_tile<T, DMAX>(sV, v, vs, b, kvh, k0, C::BK, sk, d);
    __syncthreads();
    scores<DMAX>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, sq, sk, d, causal,
                 window, scale);
    __syncthreads();
    // dQ += dS K (columns past Sk hold dS = 0)
    const int cols = min(C::BK, sk - k0);
    for (int kk = 0; kk < cols; ++kk) {
      float ds[C::SR], kv[C::NC];
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
        ds[i] = sdS[(rg * C::SR + i) * C::LDS + kk];
#pragma unroll
      for (int j = 0; j < C::NC; ++j) kv[j] = sK[kk * C::LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int j = 0; j < C::NC; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int qpos = q0 + rg * C::SR + i;
    if (qpos >= sq) continue;
    const int64_t row = (((int64_t)b * sq + qpos) * n_heads + head) * d;
#pragma unroll
    for (int j = 0; j < C::NC; ++j) {
      const int col = cg + 16 * j;
      if (col < d) dq[row + col] = from_f<T>(acc[i][j] * scale);
    }
  }
}


// ===========================================================================
// bf16: tensor cores (wgmma), copies by TMA
// ===========================================================================

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // depth of the streamed-tile ring

// which sums a dK/dV launch keeps
constexpr int kBoth = 0, kDvOnly = 1, kDkOnly = 2;

// Two values as bf16 pairs hi + lo (about 16 bits of mantissa), for the
// products with dS: dS sums to zero along each query row, so its rounding
// error, once summed over the keys, is not relative to the result but to
// the keys' (and queries') common component, which trained activations
// have. One bf16 rounding of dS misses the error rule there (chip_smoke.py
// 13a's offset case); two terms meet it.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DP>  // D padded to the tile width: 64, 128 or 256
struct BwdShape {
  static constexpr int NWG = DP <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
  // the CTA's own rows (keys of dK/dV, queries of dQ), loaded once, and
  // the rows of each streamed tile
  static constexpr int ROWS = 64 * NWG;
  static constexpr int STEP = 64;
  static constexpr int ATOMS = DP / 64;  // 64-column slabs
  static constexpr int OWN_ATOM = ROWS * kSwizzleRow;
  static constexpr int STEP_ATOM = STEP * kSwizzleRow;
  static constexpr int OWN_BYTES = ATOMS * OWN_ATOM;
  static constexpr int STEP_BYTES = ATOMS * STEP_ATOM;
  // two own tiles, two streamed tiles a stage, lse and delta a stage,
  // 1,024 bytes to align the tiles (the swizzle's period), barriers
  static constexpr int FLOATS = 2 * kStages * STEP * 4;
  static constexpr int SMEM = 2 * OWN_BYTES + 2 * kStages * STEP_BYTES +
                              FLOATS + 1024 + 128;
};

// Each thread of a consumer warpgroup holds, of a 64 x N accumulator, rows
// 16 w + lane / 4 (h = 0) and 8 more (h = 1) and, of each 8-column block,
// columns 2 (lane % 4) and one more: element e sits at row h = (e / 2) % 2,
// column (e / 4) * 8 + 2 (lane % 4) + e % 2.
__device__ __forceinline__ int frag_col(int e, int lane) {
  return (e / 4) * 8 + 2 * (lane % 4) + (e % 2);
}

// dK and dV of ROWS key rows of one KV head, summed over the group's heads
// and the q tiles the mask keeps.
template <int DP, int MODE>
__global__ void __launch_bounds__(BwdShape<DP>::THREADS, 1)
dkdv_tc(const __grid_constant__ CUtensorMap tmq,
        const __grid_constant__ CUtensorMap tmk,
        const __grid_constant__ CUtensorMap tmv,
        const __grid_constant__ CUtensorMap tmdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int sq, int sk, int n_heads, int n_kv, int d, int causal, int window,
        float scale, float scale_log2) {
  using T = BwdShape<DP>;
  constexpr int STEP = T::STEP;
  constexpr int NS = STEP / 2;  // score floats a thread
  constexpr int NO = DP / 2;    // accumulator floats a thread
  constexpr bool DV = MODE != kDkOnly, DK = MODE != kDvOnly;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + T::OWN_BYTES;
  const uint32_t sQ = sV + T::OWN_BYTES;               // Q of each stage
  const uint32_t sG = sQ + kStages * T::STEP_BYTES;    // dO of each stage
  const uint32_t sF = sG + kStages * T::STEP_BYTES;
  float* const s_lse = reinterpret_cast<float*>(smem_raw + (sF - raw));
  float* const s_delta = s_lse + kStages * STEP;
  // barriers: K/V full, then full and empty for each stage
  const uint32_t kv_full = sF + T::FLOATS;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * T::ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv;
  // the queries that keep a key of this tile: q >= k0 (causal) and
  // q < k_last + window (window); n_t q tiles of each head from t_lo
  const int k_last = min(k0 + T::ROWS, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int t_lo = q_lo / STEP;
  const int n_t = q_hi > t_lo * STEP ? (q_hi - t_lo * STEP + STEP - 1) / STEP
                                     : 0;
  const int n_steps = group * n_t;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the copies' and each lane's
      mbar_init(empty + 8 * s, T::CONSUMERS / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // producer: lane 0 issues every copy; the 32 lanes stage lse and delta
    const int lane = tid - T::CONSUMERS;
    if (lane == 0) {
      mbar_expect_tx(kv_full, (DK ? 2 : 1) * T::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load(sK + a * T::OWN_ATOM, &tmk, kv_full, a * 64, k0, kvh, b);
      if constexpr (DK) {
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sV + a * T::OWN_ATOM, &tmv, kv_full, a * 64, k0, kvh, b);
      }
    }
    for (int i = 0; i < n_steps; ++i) {
      const int head = kvh * group + i / n_t;
      const int q0 = (t_lo + i % n_t) * STEP;
      const int s = i % kStages, use = i / kStages;
      if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * T::STEP_BYTES);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load(sQ + s * T::STEP_BYTES + a * T::STEP_ATOM, &tmq,
                   full + 8 * s, a * 64, q0, head, b);
          tma_load(sG + s * T::STEP_BYTES + a * T::STEP_ATOM, &tmdo,
                   full + 8 * s, a * 64, q0, head, b);
        }
      }
      const int64_t off = ((int64_t)b * n_heads + head) * sq;
      for (int r = lane; r < STEP; r += 32) {
        const int row = q0 + r;
        const float l = row < sq ? lse[off + row] : -INFINITY;
        s_lse[s * STEP + r] = l == -INFINITY ? INFINITY : l * kLog2e;
        if constexpr (DK)
          s_delta[s * STEP + r] = row < sq ? delta[off + row] : 0.f;
      }
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns key rows j0 .. j0 + 63
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int j0 = k0 + wg * 64;
  const int r0 = j0 + warp * 16 + lane / 4;
  const uint32_t k_rows = sK + wg * 64 * kSwizzleRow;
  const uint32_t v_rows = sV + wg * 64 * kSwizzleRow;
  float acc_v[DV ? NO : 1], acc_k[DK ? NO : 1];
#pragma unroll
  for (int i = 0; i < (DV ? NO : 1); ++i) acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DK ? NO : 1); ++i) acc_k[i] = 0.f;
  float st[NS], dpt[NS];
  uint32_t pa[NS / 2], da[NS / 2], dlo[NS / 2];

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int q0 = (t_lo + i % n_t) * STEP;
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const uint32_t q_tile = sQ + s * T::STEP_BYTES;
    const uint32_t g_tile = sG + s * T::STEP_BYTES;
    mbar_wait(full + 8 * s, parity);

    // S^T = K Q^T and dP^T = V dO^T. The dK pass forms P^T while dP^T
    // runs (two groups); the one pass at D = 64 waits for both, since two
    // groups there leave ptxas too few registers and it serialises them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns, within a slab
      wgmma_ss(st, desc_kmajor(k_rows + (kk / 4) * T::OWN_ATOM + off),
               desc_kmajor(q_tile + (kk / 4) * T::STEP_ATOM + off), kk > 0);
    }
    if constexpr (MODE == kDkOnly) wg_commit();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(dpt, desc_kmajor(v_rows + (kk / 4) * T::OWN_ATOM + off),
                 desc_kmajor(g_tile + (kk / 4) * T::STEP_ATOM + off), kk > 0);
      }
    }
    wg_commit();
    if constexpr (MODE == kDkOnly) {
      wg_wait<1>();
    } else {
      wg_wait<0>();
      if constexpr (DK) pin(dpt);
    }
    pin(st);

    // P^T = exp2(S^T scale log2 e - lse log2 e), the masked pairs 0;
    // dS^T = P^T (dP^T - delta); lse and delta by column (query)
    const float* lrow = s_lse + s * STEP;
    const float* drow = s_delta + s * STEP;
    const bool edge = (causal && j0 + 63 > q0) ||
                      (window > 0 && j0 <= q0 + STEP - 1 - window);
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int col = frag_col(e, lane);
      float p = ex2(fmaf(st[e], scale_log2, -lrow[col]));
      if (edge) {
        const int key = r0 + 8 * ((e / 2) % 2), qpos = q0 + col;
        if ((causal && key > qpos) || (window > 0 && key <= qpos - window))
          p = 0.f;
      }
      st[e] = p;
      if constexpr (MODE == kBoth) dpt[e] = p * (dpt[e] - drow[col]);
    }
    if constexpr (MODE == kDkOnly) {
      wg_wait<0>();
      pin(dpt);
#pragma unroll
      for (int e = 0; e < NS; ++e)
        dpt[e] = st[e] * (dpt[e] - drow[frag_col(e, lane)]);
    }
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) {
      if constexpr (DV) pa[e] = pack_bf16(st[2 * e], st[2 * e + 1]);
      if constexpr (DK)
        split_bf16(dpt[2 * e], dpt[2 * e + 1], da[e], dlo[e]);
    }

    // dV += P^T dO, dK += dS^T Q: the tile's rows run along K
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < STEP / 16; ++kb) {
      if constexpr (DV)
        wgmma_rs(acc_v, pa[4 * kb], pa[4 * kb + 1], pa[4 * kb + 2],
                 pa[4 * kb + 3],
                 desc_nmajor(g_tile + kb * 16 * kSwizzleRow, T::STEP_ATOM));
      if constexpr (DK) {
        const uint64_t q_desc =
            desc_nmajor(q_tile + kb * 16 * kSwizzleRow, T::STEP_ATOM);
        wgmma_rs(acc_k, da[4 * kb], da[4 * kb + 1], da[4 * kb + 2],
                 da[4 * kb + 3], q_desc);
        wgmma_rs(acc_k, dlo[4 * kb], dlo[4 * kb + 1], dlo[4 * kb + 2],
                 dlo[4 * kb + 3], q_desc);
      }
    }
    wg_commit();
    wg_wait<0>();
    if constexpr (DV) pin(acc_v);
    if constexpr (DK) pin(acc_k);
    if constexpr (DV) pin(pa);
    if constexpr (DK) pin(da);
    if constexpr (DK) pin(dlo);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const int c = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= sk) continue;
    const int64_t at = (((int64_t)b * sk + row) * n_kv + kvh) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + c;
      if (col >= d) continue;
      if constexpr (DV)
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(acc_v[4 * n + 2 * h],
                                  acc_v[4 * n + 2 * h + 1]);
      if constexpr (DK)
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(acc_k[4 * n + 2 * h] * scale,
                                  acc_k[4 * n + 2 * h + 1] * scale);
    }
  }
}

// delta and dQ of ROWS q rows of one head: two sweeps over the key tiles
// the mask keeps, the first summing delta = rowsum(P o dP) (written out for
// the dK/dV kernel), the second dQ.
template <int DP>
__global__ void __launch_bounds__(BwdShape<DP>::THREADS, 1)
dq_tc(const __grid_constant__ CUtensorMap tmq,
      const __grid_constant__ CUtensorMap tmk,
      const __grid_constant__ CUtensorMap tmv,
      const __grid_constant__ CUtensorMap tmdo,
      const float* __restrict__ lse, float* __restrict__ delta,
      __nv_bfloat16* __restrict__ dq, int sq, int sk, int n_heads, int n_kv,
      int d, int causal, int window, float scale, float scale_log2) {
  using T = BwdShape<DP>;
  constexpr int STEP = T::STEP;
  constexpr int NS = STEP / 2;
  constexpr int NO = DP / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sG = sQ + T::OWN_BYTES;               // dO
  const uint32_t sK = sG + T::OWN_BYTES;               // K of each stage
  const uint32_t sV = sK + kStages * T::STEP_BYTES;    // V of each stage
  // barriers: Q/dO full, then K full, V full and K/V empty for each stage
  const uint32_t own_full = sV + kStages * T::STEP_BYTES + T::FLOATS;
  const uint32_t k_full = own_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t kv_empty = v_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::ROWS;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  const int q_last = min(q0 + T::ROWS, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  // the key tiles from t_first, before which q0's window keeps no key:
  // nt of them, loaded twice (one sweep each); i counts the loads
  const int t_first = window > 0 ? max(0, q0 - window + 1) / STEP : 0;
  const int nt = max(0, (k_end + STEP - 1) / STEP - t_first);

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, T::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    if (tid == T::CONSUMERS) {
      mbar_expect_tx(own_full, 2 * T::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load(sQ + a * T::OWN_ATOM, &tmq, own_full, a * 64, q0, head, b);
        tma_load(sG + a * T::OWN_ATOM, &tmdo, own_full, a * 64, q0, head, b);
      }
      for (int i = 0; i < 2 * nt; ++i) {
        const int t = t_first + i % nt;
        const int s = i % kStages, use = i / kStages;
        if (use > 0) mbar_wait(kv_empty + 8 * s, (use - 1) & 1);
        const uint32_t kf = k_full + 8 * s, vf = v_full + 8 * s;
        mbar_expect_tx(kf, T::STEP_BYTES);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sK + s * T::STEP_BYTES + a * T::STEP_ATOM, &tmk, kf,
                   a * 64, t * STEP, kvh, b);
        mbar_expect_tx(vf, T::STEP_BYTES);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sV + s * T::STEP_BYTES + a * T::STEP_ATOM, &tmv, vf,
                   a * 64, t * STEP, kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const uint32_t q_rows = sQ + wg * 64 * kSwizzleRow;
  const uint32_t g_rows = sG + wg * 64 * kSwizzleRow;
  // each row's lse (times log2 e; +inf past Sq or without a key: P = 0)
  float l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const float l = row < sq ? lse[((int64_t)b * n_heads + head) * sq + row]
                             : -INFINITY;
    l2[h] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float sc[NS], dp[NS];
  uint32_t da[NS / 2], dlo[NS / 2];

  // P (into sc) and dP of the i-th tile loaded, the key tile t
  auto scores = [&](int i, int t) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = t * STEP;
    const uint32_t k_tile = sK + s * T::STEP_BYTES;
    const uint32_t v_tile = sV + s * T::STEP_BYTES;
    // S = Q K^T, then dP = dO V^T as a second group, so P is formed while
    // dP runs. At D = 64 S issues before V lands, which ptxas answers by
    // serialising the kernel's products (C7520) and which costs less there
    // than the wait (chip A/B, PERF.md); above, both waits come first
    mbar_wait(k_full + 8 * s, parity);
    if constexpr (DP > 64) mbar_wait(v_full + 8 * s, parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(sc, desc_kmajor(q_rows + (kk / 4) * T::OWN_ATOM + off),
               desc_kmajor(k_tile + (kk / 4) * T::STEP_ATOM + off), kk > 0);
    }
    wg_commit();
    if constexpr (DP == 64) mbar_wait(v_full + 8 * s, parity);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(dp, desc_kmajor(g_rows + (kk / 4) * T::OWN_ATOM + off),
               desc_kmajor(v_tile + (kk / 4) * T::STEP_ATOM + off), kk > 0);
    }
    wg_commit();
    wg_wait<1>();
    pin(sc);
    // P = 0 on masked pairs and keys past Sk (their zero-filled K rows
    // would give P = exp(-lse))
    const bool edge = k0 + STEP > sk ||
                      (causal && k0 + STEP - 1 > q0 + wg * 64) ||
                      (window > 0 && k0 <= q0 + wg * 64 + 63 - window);
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int h = (e / 2) % 2;
      float p = ex2(fmaf(sc[e], scale_log2, -l2[h]));
      if (edge) {
        const int col = k0 + frag_col(e, lane), row = r0 + 8 * h;
        if (col >= sk || (causal && col > row) ||
            (window > 0 && col <= row - window))
          p = 0.f;
      }
      sc[e] = p;
    }
    wg_wait<0>();
    pin(dp);
  };

  // sweep 1: delta_i = sum_j P_ij dP_ij, the softmax's own row sum; from
  // the forward's rounded out instead (dO . out), its rounding error would
  // reach dQ times the keys' common component, which trained activations
  // carry (PERF.md)
  mbar_wait(own_full, 0);
  float dl[2] = {0.f, 0.f};
  for (int i = 0; i < nt; ++i) {
    scores(i, t_first + i);
#pragma unroll
    for (int e = 0; e < NS; ++e)
      dl[(e / 2) % 2] = fmaf(sc[e], dp[e], dl[(e / 2) % 2]);
    if (lane == 0) mbar_arrive(kv_empty + 8 * (i % kStages));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the four lanes of a row hold parts
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
    const int row = r0 + 8 * h;
    if (lane % 4 == 0 && row < sq)
      delta[((int64_t)b * n_heads + head) * sq + row] = dl[h];
  }

  // sweep 2: dS = P (dP - delta), dQ += dS K
  for (int i = nt; i < 2 * nt; ++i) {
    scores(i, t_first + i - nt);
#pragma unroll
    for (int e = 0; e < NS; ++e) sc[e] *= dp[e] - dl[(e / 2) % 2];
#pragma unroll
    for (int e = 0; e < NS / 2; ++e)
      split_bf16(sc[2 * e], sc[2 * e + 1], da[e], dlo[e]);
    // the K tile's rows run along K
    const uint32_t k_tile = sK + (i % kStages) * T::STEP_BYTES;
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < STEP / 16; ++kb) {
      const uint64_t k_desc =
          desc_nmajor(k_tile + kb * 16 * kSwizzleRow, T::STEP_ATOM);
      wgmma_rs(acc, da[4 * kb], da[4 * kb + 1], da[4 * kb + 2], da[4 * kb + 3],
               k_desc);
      wgmma_rs(acc, dlo[4 * kb], dlo[4 * kb + 1], dlo[4 * kb + 2],
               dlo[4 * kb + 3], k_desc);
    }
    wg_commit();
    wg_wait<0>();
    pin(acc);
    pin(da);
    pin(dlo);
    if (lane == 0) mbar_arrive(kv_empty + 8 * (i % kStages));
  }

  const int c = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + (((int64_t)b * sq + row) * n_heads + head) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + c;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
    }
  }
}

// ===========================================================================
// host side
// ===========================================================================

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int sq, int sk, int h, int kv,
               int d, const Strides* st, int causal, int window,
               cudaStream_t stream) {
  using C = Cfg<DMAX>;
  static bool set_dkdv[64] = {}, set_dq[64] = {};
  cudaError_t err =
      allow_smem(dkdv_kernel<float, DMAX>, (int)C::SMEM, set_dkdv);
  if (err == cudaSuccess)
    err = allow_smem(dq_kernel<float, DMAX>, (int)C::SMEM, set_dq);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)d);
  const long long rows = (long long)b * h * sq;
  delta_kernel<float><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>((const float*)out,
                                               (const float*)dout, delta, sq,
                                               h, d, rows, st[3], st[4]);
  dkdv_kernel<float, DMAX><<<dim3((sk + C::BK - 1) / C::BK, kv, b), kThreads,
                             C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, sq, sk, h, kv, d, st[0], st[1],
      st[2], st[4], causal, window, scale);
  dq_kernel<float, DMAX><<<dim3((sq + C::BQ - 1) / C::BQ, h, b), kThreads,
                           C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, sq, sk, h, kv, d, st[0], st[1], st[2], st[4],
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DP, int MODE>
cudaError_t launch_dkdv(const CUtensorMap& mq, const CUtensorMap& mk,
                        const CUtensorMap& mv, const CUtensorMap& mdo,
                        const float* lse, const float* delta, void* dk,
                        void* dv, int b, int sq, int sk, int h, int kv, int d,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  using T = BwdShape<DP>;
  static bool smem_set[64] = {};
  const cudaError_t err = allow_smem(dkdv_tc<DP, MODE>, T::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dkdv_tc<DP, MODE><<<dim3((sk + T::ROWS - 1) / T::ROWS, kv, b), T::THREADS,
                      T::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, sq,
      sk, h, kv, d, causal, window, scale, scale * kLog2e);
  return cudaSuccess;
}

// The CTA's own tiles take ROWS-row boxes, the streamed tiles STEP-row
// boxes: dK/dV owns K and V and streams Q and dO, dQ the other way round.
template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, float* delta, void* dq, void* dk, void* dv,
              int b, int sq, int sk, int h, int kv, int d, const long long* p,
              int causal, int window, cudaStream_t stream) {
  using T = BwdShape<DP>;
  static bool smem_dq[64] = {};
  cudaError_t err = allow_smem(dq_tc<DP>, T::SMEM, smem_dq);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_own, g_own, k_own, v_own, q_step, g_step, k_step, v_step;
  int bad = tensor_map(&q_own, q, d, sq, h, b, p, T::ROWS);
  if (!bad) bad = tensor_map(&g_own, dout, d, sq, h, b, p + 12, T::ROWS);
  if (!bad) bad = tensor_map(&k_own, k, d, sk, kv, b, p + 3, T::ROWS);
  if (!bad) bad = tensor_map(&v_own, v, d, sk, kv, b, p + 6, T::ROWS);
  if (!bad) bad = tensor_map(&q_step, q, d, sq, h, b, p, T::STEP);
  if (!bad) bad = tensor_map(&g_step, dout, d, sq, h, b, p + 12, T::STEP);
  if (!bad) bad = tensor_map(&k_step, k, d, sk, kv, b, p + 3, T::STEP);
  if (!bad) bad = tensor_map(&v_step, v, d, sk, kv, b, p + 6, T::STEP);
  if (bad) return bad;
  const float scale = 1.0f / sqrtf((float)d);
  // dQ first: its first sweep writes delta, which dK/dV reads
  dq_tc<DP><<<dim3((sq + T::ROWS - 1) / T::ROWS, h, b), T::THREADS, T::SMEM,
              stream>>>(q_own, k_step, v_step, g_own, lse, delta,
                        (__nv_bfloat16*)dq, sq, sk, h, kv, d, causal, window,
                        scale, scale * kLog2e);
  if constexpr (DP == 64) {
    err = launch_dkdv<DP, kBoth>(q_step, k_own, v_own, g_step, lse, delta, dk,
                                 dv, b, sq, sk, h, kv, d, causal, window,
                                 scale, stream);
  } else {
    err = launch_dkdv<DP, kDvOnly>(q_step, k_own, v_own, g_step, lse, delta,
                                   dk, dv, b, sq, sk, h, kv, d, causal, window,
                                   scale, stream);
    if (err == cudaSuccess)
      err = launch_dkdv<DP, kDkOnly>(q_step, k_own, v_own, g_step, lse, delta,
                                     dk, dv, b, sq, sk, h, kv, d, causal,
                                     window, scale, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout: b x sq x h x d; k, v: b x sk x kv x d; at the element
// strides in `strides` (batch, row, head of q, k, v, out, dout in that
// order; the last dimension contiguous; bf16: q, k, v and dout each
// TMA-readable, a 16-byte-aligned base and strides a multiple of 8
// elements, which the wrapper ensures; out is read by the f32 path only).
// lse: b x h x sq f32, the forward's (repro_flash_attention); delta: b x h
// x sq f32 scratch. dq (b x sq x h x d), dk and dv (b x sk x kv x d):
// contiguous outputs in the inputs' type. dtype 0 = f32 (CUDA cores), 1 =
// bf16 (tensor cores); d a multiple of 8 up to 256, h a multiple of kv, b,
// sq, sk >= 1 (the wrapper checks). Three launches on `stream` (bf16: two,
// three at d > 64), no atomics. Returns cudaGetLastError() after them, or
// kTensorMapError + the encoder's CUresult when a bf16 tensor map cannot be
// built.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int h, int kv, int d,
    const void* strides, int causal, int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kv <= 0 || h % kv ||
      d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  const long long* p = (const long long*)strides;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == 1) {
    if (d <= 64)
      return launch_tc<64>(q, k, v, dout, l, dl, dq, dk, dv, b, sq, sk, h, kv,
                           d, p, causal, window, s);
    if (d <= 128)
      return launch_tc<128>(q, k, v, dout, l, dl, dq, dk, dv, b, sq, sk, h,
                            kv, d, p, causal, window, s);
    return launch_tc<256>(q, k, v, dout, l, dl, dq, dk, dv, b, sq, sk, h, kv,
                          d, p, causal, window, s);
  }
  if (d <= 64)
    return launch_f32<64>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, h,
                          kv, d, st, causal, window, s);
  if (d <= 128)
    return launch_f32<128>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, h,
                           kv, d, st, causal, window, s);
  return launch_f32<256>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, h,
                         kv, d, st, causal, window, s);
}
