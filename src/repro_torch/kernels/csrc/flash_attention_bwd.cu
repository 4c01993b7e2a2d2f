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
// What it computes, all in f32 (FlashAttention-2's backward):
//   delta_i = sum_c dO_ic O_ic                        (pre-pass)
//   P_ij = exp(S_ij scale - lse_i), S = Q K^T          (recomputed)
//   dP = dO V^T,  dS_ij = P_ij (dP_ij - delta_i)
//   dV = P^T dO,  dK = dS^T Q scale,  dQ = dS K scale.
// What it leaves aside: the bf16 forward rounds P to bf16 before P V (as
// the TPU kernel's MXU does); the backward recomputes P in f32 and does not
// round it, so it differentiates the exact-softmax function that the
// forward approximates. delta is taken from the forward's rounded out, as
// FlashAttention does.
//
// Bound on this card: operations. A kept (q, k) pair of one head costs
// 10 D flops at the least (QK^T, dO V^T, P^T dO, dS^T Q, dS K); these
// kernels do 14 D, since the dQ kernel recomputes S and dP. At the
// training shape (stablelm-1.6b: B = 4, S = 2,048, 32 heads of 64, causal)
// that is 1.7e11 flops a layer, 0.17 ms at the bf16 tensor cores' 989
// TFLOP/s of an H100 SXM at its 700 W limit; the kernels take about 13 ms
// there (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 13a).
//
// Design, a simple kernel that is right first (no tensor cores, no TMA;
// both are work for a later change): three launches, no atomics, so the
// result is the same on every run.
//   1. delta: one warp per (batch, head, row).
//   2. dK/dV: one 256-thread block per (k tile, KV head, batch), the k
//      tiles with the most causal queries launched first. The block keeps
//      its K and V tile in shared memory (f32) and loops over the group's
//      heads and, for each, over the q tiles that the mask keeps for this
//      k tile; for each it stages Q, dO, lse and delta, computes a
//      (BQ x BK) block of S and dP per thread (4 x 4 or 2 x 2), stores P and
//      dS in shared memory, and adds P^T dO and dS^T Q into dV and dK held
//      in registers (4 x D/16 or 2 x D/16 values a thread each).
//   3. dQ: one block per (q tile, head, batch), the longest causal q tiles
//      first, looping over the k tiles the mask keeps (tiles wholly before
//      a q tile's window are skipped, as the forward skips them), and
//      adding dS K into dQ in registers.
// Tiles are 64 x 64 for D <= 128 (D padded to 64 or 128) and 32 x 32 at
// D <= 256, rows padded by one word in shared memory; ragged Sq and Sk
// and the masks are handled in the kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// delta (B, H, Sq) = rowsum(dO o O), one warp a row.
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

// Sets a kernel's dynamic shared memory once for each device it runs on.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int h, int kv, int d,
           const Strides* st, int causal, int window, cudaStream_t stream) {
  using C = Cfg<DMAX>;
  static bool set_dkdv[64] = {}, set_dq[64] = {};
  cudaError_t err = allow_smem(dkdv_kernel<T, DMAX>, (int)C::SMEM, set_dkdv);
  if (err == cudaSuccess)
    err = allow_smem(dq_kernel<T, DMAX>, (int)C::SMEM, set_dq);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)d);
  const long long rows = (long long)b * h * sq;
  const long long warps_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                    kThreads, 0, stream>>>((const T*)out, (const T*)dout,
                                           delta, sq, h, d, rows, st[3],
                                           st[4]);
  dkdv_kernel<T, DMAX><<<dim3((sk + C::BK - 1) / C::BK, kv, b), kThreads,
                         C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, sq, sk, h, kv, d, st[0], st[1], st[2], st[4], causal,
      window, scale);
  dq_kernel<T, DMAX><<<dim3((sq + C::BQ - 1) / C::BQ, h, b), kThreads,
                       C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, sq, sk, h, kv, d, st[0], st[1], st[2], st[4], causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int sq, int sk, int h, int kv, int d,
               const Strides* st, int causal, int w, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq,
                         sk, h, kv, d, st, causal, w, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq,
                          sk, h, kv, d, st, causal, w, s);
  return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk,
                        h, kv, d, st, causal, w, s);
}

}  // namespace

// q, out, dout: b x sq x h x d; k, v: b x sk x kv x d; at the element
// strides in `strides` (batch, row, head of q, k, v, out, dout in that
// order; the last dimension contiguous). lse: b x h x sq f32, the forward's
// (repro_flash_attention); delta: b x h x sq f32 scratch. dq (b x sq x h x
// d), dk and dv (b x sk x kv x d): contiguous outputs in the inputs' type.
// dtype 0 = f32, 1 = bf16; d a multiple of 8 up to 256, h a multiple of kv,
// b, sq, sk >= 1 (the wrapper checks). Three launches on `stream`, no
// atomics. Returns cudaGetLastError() after them.
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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse,
                                     (float*)delta, dq, dk, dv, b, sq, sk, h,
                                     kv, d, st, causal, window, s);
  return dispatch_d<float>(q, k, v, out, dout, (const float*)lse,
                           (float*)delta, dq, dk, dv, b, sq, sk, h, kv, d, st,
                           causal, window, s);
}
