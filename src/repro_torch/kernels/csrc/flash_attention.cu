// Causal (or full) attention with an online softmax, grouped-query heads:
//   q (B, Sq, H, D), k and v (B, Sk, KV, D), both bf16 or both f32, read at
//   their strides (the last dimension contiguous) -> out (B, Sq, H, D)
//   contiguous, in q's type. Head h reads KV head h / (H / KV). Scores,
//   running max, running sum and accumulator are f32; the scale is D^-1/2,
//   applied to q as it is loaded; the causal mask keeps key j for query i
//   when i >= j, both counted from 0 (start-aligned also when Sq != Sk).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_bhsd (_attn_kernel), which takes (B*H, S, D) with the KV
// heads already repeated (ops.py's jnp.repeat and transposes), asserts
// that Sq and Sk divide its 128-row blocks, and walks the KV blocks of one
// q block in a fori_loop on one core.
//
// Bound on this card: operations. A causal S x S head needs
// 4 * D * S * (S + 1) / 2 flops (QK^T and PV); at the forward's B = 4,
// S = 2,048, H = 40, D = 128 that is 1.72e11, 0.174 ms at the bf16 tensor
// cores' 989 TFLOP/s, against 0.060 ms for its 201 MB of q, k, v and out.
// This first kernel does its arithmetic on the f32 CUDA cores (67 TFLOP/s,
// no mma), so it cannot come near that bound; a tensor-core redesign
// (wgmma, TMA) is later work. Design: one 256-thread block per (q tile of
// 64 rows, head, batch), the q tiles of a head launched last-first so the
// longest causal tiles start first. The scaled q tile and each 64-row K
// and V tile are staged in shared memory as f32 (rows padded by one word,
// so the 16 rows a warp reads at once fall in 16 banks); each thread keeps
// a 4 x 4 block of scores and a 4 x D/16 block of the accumulator in
// registers. K/V tiles wholly above the diagonal are never loaded, ragged
// Sq and Sk are masked in the kernel, and the head dimension D (a multiple
// of 8 up to 256) is zero-padded to the next of 32, 64, 128, 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kLDS = kBK + 1;  // padded row of the score tile

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

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (DMAX + 1) + kBQ * kLDS + 2 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int n_heads, int n_kv, int d, int64_t qsb,
                       int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                       int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                       int causal, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int NC = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sS = sV + kBK * LD;
  float* sAlpha = sS + kBQ * kLDS;
  float* sL = sAlpha + kBQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (n_heads / n_kv);
  const T* qb = q + b * qsb + head * qsh;
  const T* kb = k + b * ksb + kv_head * ksh;
  const T* vb = v + b * vsb + kv_head * vsh;

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    float val = 0.f;
    if (q0 + r < sq && c < d) val = to_f(qb[(int64_t)(q0 + r) * qss + c]) * scale;
    sQ[r * LD + c] = val;
  }

  // score / accumulator role: rows rg*4 + i, columns cg + 16*j
  const int rg = tid >> 4, cg = tid & 15;
  // softmax role: 4 lanes per row, 16 columns each
  const int srow = tid >> 2, spart = tid & 3;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's PV pass is done with sK, sV, sS
    for (int i = tid; i < kBK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      float kval = 0.f, vval = 0.f;
      if (k0 + r < sk && c < d) {
        kval = to_f(kb[(int64_t)(k0 + r) * kss + c]);
        vval = to_f(vb[(int64_t)(k0 + r) * vss + c]);
      }
      sK[r * LD + c] = kval;
      sV[r * LD + c] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(rg * 4 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(cg + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg + 16 * j;
        const int kpos = k0 + col;
        const bool ok = kpos < sk && (!causal || kpos <= q0 + row);
        sS[row * kLDS + col] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    float* srow_p = sS + srow * kLDS + spart * 16;
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) mx = fmaxf(mx, srow_p[jj]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    // m_new is -inf only while every key so far is masked: keep acc (0)
    const float alpha = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float sv = srow_p[jj];
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
      srow_p[jj] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (spart == 0) sAlpha[srow] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= a;
    }
    const int kk_end = min(kBK, sk - k0);  // rows past Sk hold p = 0, v = 0
    for (int kk = 0; kk < kk_end; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(rg * 4 + i) * kLDS + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) sL[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg * 4 + i;
    const int qpos = q0 + row;
    if (qpos >= sq) continue;
    const float l = sL[row];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((int64_t)b * sq + qpos) * n_heads + head) * d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = cg + 16 * j;
      if (col < d) orow[col] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int kv, int d, const long long* st,
           int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, h, kv, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int h, int kv, int d, const long long* st,
               int causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, out, b, sq, sk, h, kv, d, st, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, out, b, sq, sk, h, kv, d, st, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, b, sq, sk, h, kv, d, st, causal, s);
  return launch<T, 256>(q, k, v, out, b, sq, sk, h, kv, d, st, causal, s);
}

}  // namespace

// q: b x sq x h x d; k, v: b x sk x kv x d, at the element strides in
// `strides` (q's batch, row, head, then k's, then v's; the last dimension
// contiguous); out: b x sq x h x d contiguous. dtype 0 = f32, 1 = bf16;
// d a multiple of 8 up to 256 and h a multiple of kv (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int sk, int h, int kv, int d,
                                     const void* strides, int causal,
                                     int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || d <= 0) return (int)cudaGetLastError();
  const long long* st = (const long long*)strides;
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kv, d, st,
                                     causal, (cudaStream_t)stream);
  }
  return dispatch_d<float>(q, k, v, out, b, sq, sk, h, kv, d, st, causal,
                           (cudaStream_t)stream);
}
