// Causal (or full) attention with an online softmax, grouped-query heads:
//   q (B, Sq, H, D), k and v (B, Sk, KV, D), both bf16 or both f32, read at
//   their strides (the last dimension contiguous) -> out (B, Sq, H, D)
//   contiguous, in q's type. Head h reads KV head h / (H / KV). The causal
//   mask keeps key j for query i when i >= j, both counted from 0
//   (start-aligned also when Sq != Sk); a window w > 0 also drops key j when
//   j <= i - w (the JAX model's _sdpa), and the key tiles that lie wholly
//   before a q tile's window are never loaded. Scores, running max, running sum and
//   accumulator are f32, and so is the scale D^-1/2 (bf16: on the scores;
//   f32: on q as it is loaded).
//
// Given an lse pointer, each row's log-sum-exp of its scaled scores (natural
// log, f32, (B, H, Sq)) is written at the epilogue, from the running max and
// the f32 row sum: the input of the backward (flash_attention_bwd.cu).
// Serving passes none and writes nothing more.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_bhsd (_attn_kernel), which takes (B*H, S, D) with the KV
// heads already repeated (ops.py's jnp.repeat and transposes), asserts
// that Sq and Sk divide its 128-row blocks, feeds the MXU one 128-row q
// block against each 128-row KV block in a fori_loop on one core.
//
// Bound on this card: operations. A causal S x S head needs
// 4 * D * S * (S + 1) / 2 flops (QK^T and PV); at the forward's B = 4,
// S = 2,048, H = 40, D = 128 that is 1.72e11, 0.174 ms at the bf16 tensor
// cores' 989 TFLOP/s, against 0.060 ms for its 201 MB of q, k, v and out.
//
// bf16 (the model's type): both products on the tensor cores, fed by TMA
// (the mbarrier, TMA, descriptor and wgmma helpers are hopper.cuh's,
// shared with the backward).
// One CTA per (128-row q tile, head, batch), the longest causal q tiles
// launched first; 288 threads: two consumer warpgroups of 64 q rows each
// and one producer warp. The producer's lane 0 loads the q tile once and
// then each K and V tile (128 rows; 64 at D = 256) into a two-stage ring in
// dynamic shared memory with cp.async.bulk.tensor, each stage's K and V on
// their own mbarrier (expect-tx), so S = Q K^T can start before V lands;
// the consumers release a stage on a third mbarrier. The tensor maps are
// built on the host for each launch over the real strides of q, k and v
// (4-d: D, S, heads, batch), so the model's fused-projection views need no
// copy; their out-of-bounds zero fill pads the ragged Sq and Sk rows and D
// up to the tile width (64, 128 or 256: a 128-byte swizzle row holds 64
// bf16), and their 128-byte swizzle is the layout wgmma reads. Each
// consumer warpgroup computes its 64 x BK score block with
// wgmma m64n{BK}k16 (Q and K from shared memory, K-major), masks only the
// diagonal tile and the ragged last tile (tiles wholly above the diagonal
// are never loaded), keeps the running max and sum in f32 (the scale and
// log2 e folded into one ex2), rounds P to bf16 as the A operand from
// registers (the score accumulator's fragment is already the A layout) and
// adds P V with wgmma m64n{D}k16, V read N-major from shared memory through
// the transpose bit. The epilogue divides by the row sum and rounds once to
// bf16. Rounding P to bf16 before PV is what the TPU kernel's MXU and the
// JAX model's _sdpa do; the two consumer warpgroups take turns on the
// tensor cores while the other runs its softmax. On an H100 SXM at 700 W it
// takes 0.39 ms at the forward's shape, 44 % of the bound (chip_smoke.py);
// what it leaves is the wait for each product inside a warpgroup (no
// overlap of the next QK^T with this tile's softmax) and one q tile a CTA.
//
// f32 (off the model's path): the first CUDA-core kernel, unchanged. One
// 256-thread block per (q tile of 64 rows, head, batch); the scaled q tile
// and each 64-row K and V tile staged in shared memory as f32 (rows padded
// by one word), a 4 x 4 block of scores and a 4 x D/16 block of the
// accumulator per thread in registers; D zero-padded to 32, 64, 128 or
// 256; ragged Sq and Sk masked in the kernel. It is bounded by the f32 CUDA
// cores (67 TFLOP/s).
#include "hopper.cuh"

namespace {

using namespace hopper;

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kLDS = kBK + 1;  // padded row of the score tile

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (DMAX + 1) + kBQ * kLDS + 2 * kBQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int sq,
                       int sk, int n_heads, int n_kv, int d, int64_t qsb,
                       int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                       int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                       int causal, int window, float scale) {
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
  // the first key row q0's window keeps
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int t = t_first; t < n_tiles; ++t) {
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
        const bool ok = kpos < sk && (!causal || kpos <= q0 + row) &&
                        (window <= 0 || kpos > q0 + row - window);
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
  // the row's log-sum-exp of its scaled scores (q was scaled on its load)
  if (lse != nullptr && spart == 0 && q0 + srow < sq)
    lse[((int64_t)b * n_heads + head) * sq + q0 + srow] =
        l_run > 0.f ? m_run + logf(l_run) : -INFINITY;
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


// ===========================================================================
// bf16: tensor cores (wgmma), copies by TMA
// ===========================================================================

constexpr int kTcBQ = 128;                // q rows per CTA
constexpr int kTcStages = 2;              // depth of the K/V ring
constexpr int kTcConsumers = 256;         // two warpgroups: warps 0-7
constexpr int kTcThreads = kTcConsumers + 32;  // and the producer, warp 8

template <int DP>  // D padded to the tile width: 64, 128 or 256
struct TcShape {
  static constexpr int BK = DP <= 128 ? 128 : 64;    // K/V rows per tile
  static constexpr int ATOMS = DP / 64;              // 64-column slabs
  static constexpr int Q_ATOM = kTcBQ * kSwizzleRow;
  static constexpr int KV_ATOM = BK * kSwizzleRow;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  // tiles, 1,024 bytes to align them (the swizzle's period), barriers
  static constexpr int SMEM = Q_BYTES + 2 * kTcStages * KV_BYTES + 1024 + 64;
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int sq, int sk,
                   int n_heads, int n_kv, int d, int causal, int window,
                   float scale_log2) {
  using T = TcShape<DP>;
  constexpr int BK = T::BK;
  constexpr int NS = BK / 2;   // score floats a thread
  constexpr int NO = DP / 2;   // accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;
  const uint32_t sV = sK + kTcStages * T::KV_BYTES;
  const uint32_t bars = sV + kTcStages * T::KV_BYTES;
  // barriers: q full, then K full, V full and K/V empty for each stage
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = k_full + 8 * kTcStages;
  const uint32_t kv_empty = v_full + 8 * kTcStages;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (n_heads / n_kv);
  const int q_last = min(q0 + kTcBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // tiles before the one holding the first key row q0's window keeps are
  // skipped; i = t - t_first counts the tiles a CTA loads (ring stage, parity)
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kTcConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // producer: lane 0 of warp 8 issues every copy
    if (tid == kTcConsumers) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load(sQ + a * T::Q_ATOM, &tmq, q_full, a * 64, q0, head, b);
      for (int t = t_first; t < n_tiles; ++t) {
        const int s = (t - t_first) % kTcStages, use = (t - t_first) / kTcStages;
        if (use > 0) mbar_wait(kv_empty + 8 * s, (use - 1) & 1);
        const uint32_t kf = k_full + 8 * s, vf = v_full + 8 * s;
        mbar_expect_tx(kf, T::KV_BYTES);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sK + s * T::KV_BYTES + a * T::KV_ATOM, &tmk, kf, a * 64,
                   t * BK, kv_head, b);
        mbar_expect_tx(vf, T::KV_BYTES);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load(sV + s * T::KV_BYTES + a * T::KV_ATOM, &tmv, vf, a * 64,
                   t * BK, kv_head, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread the
  // rows r0 and r0 + 8 and, of each 8-column block, columns c and c + 1
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  const uint32_t q_rows = sQ + wg * 64 * kSwizzleRow;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float sc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  uint32_t pa[NS / 2];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = t_first; t < n_tiles; ++t) {
    const int s = (t - t_first) % kTcStages;
    const uint32_t parity = ((t - t_first) / kTcStages) & 1;
    const int k0 = t * BK;

    // S = Q K^T
    mbar_wait(k_full + 8 * s, parity);
    const uint32_t k_tile = sK + s * T::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns, within a slab
      wgmma_ss(sc, desc_kmajor(q_rows + (kk / 4) * T::Q_ATOM + off),
               desc_kmajor(k_tile + (kk / 4) * T::KV_ATOM + off), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(sc);

    // the diagonal tile, the ragged last tile and the window's first tiles:
    // mask
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wg * 64) ||
        (window > 0 && k0 <= q0 + wg * 64 + 63 - window)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + (i / 4) * 8 + c + (i % 2);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (col >= sk || (causal && col > row) ||
            (window > 0 && col <= row - window))
          sc[i] = -INFINITY;
      }
    }

    // online softmax in f32, rows r0 (h = 0) and r0 + 8 (h = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i / 2) % 2;
      mx[h] = fmaxf(mx[h], sc[i]);
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      // -inf while every key so far is masked: nothing to keep or add
      alpha[h] = m_run[h] == -INFINITY ? 0.f
                                       : ex2((m_run[h] - m_new) * scale_log2);
      shift[h] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      m_run[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = ex2(fmaf(sc[i], scale_log2, -shift[h]));
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
    // P in bf16: the score fragment of columns 16 kb .. 16 kb + 15 is the
    // A fragment of k-step kb
#pragma unroll
    for (int i = 0; i < NS / 2; ++i)
      pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += P V
    mbar_wait(v_full + 8 * s, parity);
    const uint32_t v_tile = sV + s * T::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
      wgmma_rs(o, pa[4 * kb], pa[4 * kb + 1], pa[4 * kb + 2], pa[4 * kb + 3],
               desc_nmajor(v_tile + kb * 16 * kSwizzleRow, T::KV_ATOM));
    wg_commit();
    wg_wait<0>();
    pin(o);
    pin(pa);
    if (lane == 0) mbar_arrive(kv_empty + 8 * s);
  }

  // epilogue: the four lanes of a row hold parts of its sum
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = l > 0.f ? 1.f / l : 0.f;
    // the row's log-sum-exp of its scaled scores, natural log: m scale +
    // ln(l), from the running max (raw score units) and the f32 row sum
    const int row = r0 + 8 * h;
    if (lse != nullptr && lane % 4 == 0 && row < sq)
      lse[((int64_t)b * n_heads + head) * sq + row] =
          l > 0.f ? (m_run[h] * scale_log2 + log2f(l)) * 0.6931471805599453f
                  : -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (((int64_t)b * sq + row) * n_heads + head) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + c;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[4 * n + 2 * h] * inv[h], o[4 * n + 2 * h + 1] * inv[h]);
    }
  }
}

// ===========================================================================
// host side
// ===========================================================================

// lse of rows with no key (Sk = 0): -inf.
__global__ void fill_neg_inf(float* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = -INFINITY;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b,
           int sq, int sk, int h, int kv, int d, const long long* st,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX>;
  const size_t smem = smem_bytes<DMAX>();
  static bool smem_set[64] = {};
  cudaError_t err = allow_smem(kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, sq, sk, h, kv, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int b,
               int sq, int sk, int h, int kv, int d, const long long* st,
               int causal, int w, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, out, lse, b, sq, sk, h, kv, d, st, causal, w, s);
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, b, sq, sk, h, kv, d, st, causal, w, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, lse, b, sq, sk, h, kv, d, st, causal, w, s);
  return launch<T, 256>(q, k, v, out, lse, b, sq, sk, h, kv, d, st, causal, w, s);
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int b,
              int sq, int sk, int h, int kv, int d, const long long* st,
              int causal, int window, cudaStream_t stream) {
  using T = TcShape<DP>;
  static bool smem_set[64] = {};
  cudaError_t err = allow_smem(flash_attention_tc<DP>, T::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  int bad = tensor_map(&mq, q, d, sq, h, b, st, kTcBQ);
  if (!bad) bad = tensor_map(&mk, k, d, sk, kv, b, st + 3, T::BK);
  if (!bad) bad = tensor_map(&mv, v, d, sk, kv, b, st + 6, T::BK);
  if (bad) return bad;
  const dim3 grid((sq + kTcBQ - 1) / kTcBQ, h, b);
  flash_attention_tc<DP><<<grid, kTcThreads, T::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, sq, sk, h, kv, d, causal, window,
      1.4426950408889634f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

}  // namespace

// q: b x sq x h x d; k, v: b x sk x kv x d, at the element strides in
// `strides` (q's batch, row, head, then k's, then v's; the last dimension
// contiguous); out: b x sq x h x d contiguous. dtype 0 = f32 (CUDA cores),
// 1 = bf16 (tensor cores, TMA: each base 16-byte aligned and each stride a
// multiple of 8 elements, which the wrapper ensures); d a multiple of 8 up
// to 256 and h a multiple of kv (the wrapper checks). window > 0 keeps key j
// for query i only when j > i - window; 0 keeps every key. Sk = 0 gives zeros.
// lse: null, or b x h x sq f32 that takes each row's log-sum-exp of its
// scaled scores (natural log; -inf for a row with no key), which the
// backward (flash_attention_bwd.cu) reads.
// Returns cudaGetLastError() after the launch, or kTensorMapError + the
// encoder's CUresult when a bf16 tensor map cannot be built.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int b, int sq,
                                     int sk, int h, int kv, int d,
                                     const void* strides, int causal,
                                     int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || d <= 0) return (int)cudaGetLastError();
  const long long* st = (const long long*)strides;
  const cudaStream_t s = (cudaStream_t)stream;
  float* lse_f = (float*)lse;
  if (dtype == 1) {
    if (sk <= 0) {
      if (lse_f != nullptr) {
        const long long n = (long long)b * h * sq;
        fill_neg_inf<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(lse_f, n);
      }
      return (int)cudaMemsetAsync(out, 0, (size_t)b * sq * h * d * 2, s);
    }
    if (d <= 64)
      return launch_tc<64>(q, k, v, out, lse_f, b, sq, sk, h, kv, d, st, causal,
                           window, s);
    if (d <= 128)
      return launch_tc<128>(q, k, v, out, lse_f, b, sq, sk, h, kv, d, st, causal,
                            window, s);
    return launch_tc<256>(q, k, v, out, lse_f, b, sq, sk, h, kv, d, st, causal,
                          window, s);
  }
  return dispatch_d<float>(q, k, v, out, lse_f, b, sq, sk, h, kv, d, st, causal,
                           window, s);
}
