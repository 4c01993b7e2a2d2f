// RMSNorm over the last dimension: x (R, D) bf16 or f32 and scale (D,) bf16
// or f32, of either type whatever x's -> out (R, D) in x's type:
//   out = (x * rsqrt(mean(x^2) + eps)) * scale
// with the mean of squares, the normalisation and the scale all in f32 and
// one rounding at the store (the arithmetic of the TPU kernel's body, which
// casts any scale to f32).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py:rmsnorm_pallas (_kernel),
// which normalises a (256, D) block of rows per grid step in VMEM; its
// wrapper (ops.py) pads R up to a multiple of the block.
//
// Bound on this card: bytes. It reads R * D values and D scales and writes
// R * D values, with about four f32 operations per value: at the forward's
// (8,192, 5,120) bf16 that is 168 MB, 0.050 ms at 3.35 TB/s, against
// 0.0026 ms of f32 arithmetic. So each value must cross device memory once
// each way. Design: one block of 128 threads per row, the grid one block
// per row (many short blocks that the hardware hands out as others finish,
// so the last wave is at most one row long). A thread reads its share of
// the row in 16-byte vectors when D and the pointers allow it (D % 8 == 0
// for bf16, D % 4 == 0 for f32), neighbouring threads on neighbouring
// vectors, issues all its loads before it adds, and keeps them in
// registers through the reduction, so the row is read from device memory
// once: at D = 5,120 that is 5 vectors a thread in bf16 and 10 in f32. The
// sum of squares is a warp-shuffle reduction, then one across the four
// warps through shared memory, in a fixed order. Rows longer than the
// register budget (kMaxUnits units a thread: bf16 D > 12,288, f32
// D > 6,144) take the two-pass form of the same kernel, which reads the
// row again for the output.
//
// Backward (rmsnorm_bwd_kernel, rmsnorm_bwd_reduce): replaces no TPU kernel.
// The JAX package differentiates its jnp norm through XLA and has no
// backward kernel; the port's training path needs one because its forward
// is this kernel. It differentiates this forward (f32 statistics and scale,
// one rounding): with r = rsqrt(mean(x^2) + eps), x^ = x r and g = dy s,
//   dx = r (g - x^ mean(g x^))      (in x's type)
//   dscale = sum over rows of dy x^  (f32, cast once to scale's type).
// Bound: bytes. It reads x and dy and writes dx (3 R D values) plus the
// partial sums below, with ~10 f32 operations a value. Design: a grid of
// at most kBwdCtas blocks of 256 threads, block c taking rows c, c + grid,
// ...; per row one pass for the two sums (sum x^2, sum g x, one
// two-value block reduction in a fixed order), one pass that writes dx
// and adds dy x^ into the block's own f32 column sums in shared memory
// (each thread owns its columns, so no atomics). The block writes its
// column sums as one row of an f32 partial array (grid, D); a second
// kernel sums each column over those rows in a fixed order (8 row slices,
// then the 8 slice sums in order). No float atomics anywhere, so the sum
// order, and the result, is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// units (16-byte vectors, or single values when D is not a vector
// multiple) a thread holds in registers; wider rows take two passes
constexpr int kMaxUnits = 12;
// at most this many blocks; each strides over the rows past it
constexpr long long kMaxGrid = 1 << 30;

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// A load of B bytes in one instruction.
template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// One unit of N values of T: a 16-byte vector, or one value (N = 1).
template <typename T, int N>
struct Unit {
  using W = typename Word<N * sizeof(T)>::type;
  W w;
  __device__ __forceinline__ float get(int j) const {
    return to_f(reinterpret_cast<const T*>(&w)[j]);
  }
  __device__ __forceinline__ void set(int j, float v) {
    reinterpret_cast<T*>(&w)[j] = from_f<T>(v);
  }
};

// The N scale values from p as f32, in loads of up to 16 bytes (p is
// aligned to the smaller of 16 and N * sizeof(S) bytes).
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* __restrict__ p,
                                           float (&g)[N]) {
  constexpr int kBytes = N * sizeof(S) < 16 ? N * sizeof(S) : 16;
  constexpr int kPer = kBytes / sizeof(S);
  using W = typename Word<kBytes>::type;
#pragma unroll
  for (int w = 0; w < N / kPer; ++w) {
    const W u = __ldg(reinterpret_cast<const W*>(p) + w);
    const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) g[w * kPer + j] = to_f(e[j]);
  }
}

// The block's sum of v, on every thread, in the same order everywhere.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();  // red is written again by the next row
  return t;
}

template <typename T, typename S, int N>
__device__ __forceinline__ void store_unit(const Unit<T, N>& u,
                                           const S* __restrict__ scale,
                                           Unit<T, N>* __restrict__ orow,
                                           int i, float inv) {
  float g[N];
  load_scale<S, N>(scale + (int64_t)i * N, g);
  Unit<T, N> o;
#pragma unroll
  for (int j = 0; j < N; ++j) o.set(j, (u.get(j) * inv) * g[j]);
  orow[i] = o;
}

// U > 0: each thread holds up to U units of the row in registers (units
// i = threadIdx.x + k * kThreads); U == 0: two passes over the row.
template <typename T, typename S, int N, int U>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int d, float eps) {
  using V = Unit<T, N>;
  __shared__ float red[kWarps];
  const int units = d / N;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    V* orow = reinterpret_cast<V*>(out + row * d);
    float ss = 0.f;
    if constexpr (U > 0) {
      V buf[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < units) buf[k] = xr[i];
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (threadIdx.x + k * kThreads < units) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float f = buf[k].get(j);
            ss += f * f;
          }
        }
      }
      const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < units) store_unit<T, S, N>(buf[k], scale, orow, i, inv);
      }
    } else {
      for (int i = threadIdx.x; i < units; i += kThreads) {
        const V u = xr[i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = u.get(j);
          ss += f * f;
        }
      }
      const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
      for (int i = threadIdx.x; i < units; i += kThreads) {
        const V u = xr[i];
        store_unit<T, S, N>(u, scale, orow, i, inv);
      }
    }
  }
}

template <typename T, typename S, int N>
void launch_units(const void* x, const void* scale, void* out,
                  long long rows, int d, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)(rows < kMaxGrid ? rows : kMaxGrid);
  const long long per_thread = ((long long)(d / N) + kThreads - 1) / kThreads;
  const T* xp = (const T*)x;
  const S* sp = (const S*)scale;
  T* op = (T*)out;
#define REPRO_RMSNORM(U) \
  rmsnorm_kernel<T, S, N, U><<<grid, kThreads, 0, stream>>>(xp, sp, op, rows, d, eps)
  if (per_thread <= 4) {
    REPRO_RMSNORM(4);
  } else if (per_thread <= 8) {
    REPRO_RMSNORM(8);
  } else if (per_thread <= kMaxUnits) {
    REPRO_RMSNORM(kMaxUnits);
  } else {
    REPRO_RMSNORM(0);
  }
#undef REPRO_RMSNORM
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, long long rows,
            int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // scale's loads per unit are min(16, kVec * sizeof(S)) bytes
  constexpr uintptr_t kScaleAlign =
      kVec * sizeof(S) < 16 ? kVec * sizeof(S) : 16;
  const bool vec = d % kVec == 0 &&
                   (((uintptr_t)x | (uintptr_t)out) & 15u) == 0 &&
                   ((uintptr_t)scale & (kScaleAlign - 1)) == 0;
  if (vec) {
    launch_units<T, S, kVec>(x, scale, out, rows, d, eps, stream);
  } else {
    launch_units<T, S, 1>(x, scale, out, rows, d, eps, stream);
  }
}

// ===========================================================================
// Backward
// ===========================================================================

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
// most blocks of the backward, so most rows of its partial column sums
constexpr int kBwdCtas = 512;
// widest row the backward's shared-memory column sums take (192 KB)
constexpr int kBwdMaxD = 49152;

// The block's sums of a and b, on every thread, in the same order
// everywhere.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  __syncthreads();  // red is written again by the next row
  return t;
}

// Units i = threadIdx.x + k * kBwdThreads of each row belong to this
// thread, and so do their column sums acc[j * units + i] (j < N), laid out
// so that neighbouring threads use neighbouring banks.
template <typename T, typename S, int N>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int64_t rows, int d,
                   float eps) {
  using V = Unit<T, N>;
  extern __shared__ float acc[];
  __shared__ float2 red[kBwdWarps];
  const int units = d / N;
  for (int i = threadIdx.x; i < units; i += kBwdThreads) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j * units + i] = 0.f;
  }
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    const V* gr = reinterpret_cast<const V*>(dy + row * d);
    float ss = 0.f, t = 0.f;
    for (int i = threadIdx.x; i < units; i += kBwdThreads) {
      const V u = xr[i], g = gr[i];
      float s[N];
      load_scale<S, N>(scale + (int64_t)i * N, s);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xv = u.get(j);
        ss += xv * xv;
        t += (g.get(j) * s[j]) * xv;
      }
    }
    const float2 tot = block_sum2(ss, t, red);
    const float r = rsqrtf(tot.x / (float)d + eps);
    const float mean = r * (tot.y / (float)d);  // mean(g x^)
    V* dxr = reinterpret_cast<V*>(dx + row * d);
    for (int i = threadIdx.x; i < units; i += kBwdThreads) {
      const V u = xr[i], g = gr[i];
      float s[N];
      load_scale<S, N>(scale + (int64_t)i * N, s);
      V o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = u.get(j) * r, gv = g.get(j);
        o.set(j, r * (gv * s[j] - xh * mean));
        acc[j * units + i] += gv * xh;
      }
      dxr[i] = o;
    }
  }
  float* prow = partial + (int64_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < units; i += kBwdThreads) {
#pragma unroll
    for (int j = 0; j < N; ++j) prow[i * N + j] = acc[j * units + i];
  }
}

// dscale[c] = sum over the n partial rows of column c: 32 columns a block,
// 8 row slices (row j in slice j % 8), then the slices in order.
template <typename S>
__global__ void __launch_bounds__(256)
rmsnorm_bwd_reduce(const float* __restrict__ partial, S* __restrict__ dscale,
                   int n, int d) {
  __shared__ float part[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < d) {
    for (int j = threadIdx.y; j < n; j += 8) s += partial[(int64_t)j * d + col];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += part[y][threadIdx.x];
    dscale[col] = from_f<S>(t);
  }
}

template <typename T, typename S, int N>
int launch_bwd_units(const void* x, const void* scale, const void* dy,
                     void* dx, void* dscale, void* partial, long long rows,
                     int d, float eps, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_kernel<T, S, N>;
  const int smem = d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (int)(rows < kBwdCtas ? rows : kBwdCtas);
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      (const T*)x, (const S*)scale, (const T*)dy, (T*)dx, (float*)partial,
      rows, d, eps);
  rmsnorm_bwd_reduce<S><<<(d + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)partial, (S*)dscale, grid, d);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* partial, long long rows, int d, float eps,
               cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr uintptr_t kScaleAlign =
      kVec * sizeof(S) < 16 ? kVec * sizeof(S) : 16;
  const bool vec = d % kVec == 0 &&
                   (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) & 15u) == 0 &&
                   ((uintptr_t)scale & (kScaleAlign - 1)) == 0;
  if (vec)
    return launch_bwd_units<T, S, kVec>(x, scale, dy, dx, dscale, partial,
                                        rows, d, eps, stream);
  return launch_bwd_units<T, S, 1>(x, scale, dy, dx, dscale, partial, rows, d,
                                   eps, stream);
}

}  // namespace

// Rows of the backward's partial column sums for `rows` rows: the caller
// allocates min(rows, this) x d f32 values of scratch.
extern "C" int repro_rmsnorm_bwd_ctas() { return kBwdCtas; }

// The gradient of repro_rmsnorm. x, dy, dx: rows x d, contiguous, in x's
// type; scale, dscale: d, contiguous, in scale's type; partial:
// min(rows, repro_rmsnorm_bwd_ctas()) x d f32 scratch. rows >= 1 and
// 1 <= d <= 49,152 (the wrapper checks). Two launches on `stream`, no
// atomics. Returns cudaGetLastError() after them.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* partial, long long rows, int d,
                                 float eps, int x_bf16, int scale_bf16,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || d <= 0 || d > kBwdMaxD)
    return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    if (scale_bf16)
      return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale,
                                                      partial, rows, d, eps, s);
    return launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, partial,
                                            rows, d, eps, s);
  }
  if (scale_bf16)
    return launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial,
                                            rows, d, eps, s);
  return launch_bwd<float, float>(x, scale, dy, dx, dscale, partial, rows, d,
                                  eps, s);
}

// x, out: rows x d, contiguous; scale: d, contiguous. x_bf16 / scale_bf16:
// 1 = bf16, 0 = f32. The 16-byte vector route is taken when d and every
// pointer allow it. Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, float eps, int x_bf16,
                             int scale_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0 && d > 0) {
    if (x_bf16) {
      if (scale_bf16) {
        launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
      } else {
        launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
      }
    } else if (scale_bf16) {
      launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
    } else {
      launch<float, float>(x, scale, out, rows, d, eps, s);
    }
  }
  return (int)cudaGetLastError();
}
