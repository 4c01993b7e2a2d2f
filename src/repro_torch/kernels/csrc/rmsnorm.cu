// RMSNorm over the last dimension: x (R, D) and scale (D,), both bf16 or
// both f32 -> out (R, D) in x's type:
//   out = (x * rsqrt(mean(x^2) + eps)) * scale
// with the mean of squares, the normalisation and the scale all in f32 and
// one rounding at the store (the arithmetic of the TPU kernel's body).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py:rmsnorm_pallas (_kernel),
// which normalises a (256, D) block of rows per grid step in VMEM; its
// wrapper (ops.py) pads R up to a multiple of the block.
//
// Bound on this card: bytes. It reads R * D values and D scales and writes
// R * D values, with about four f32 operations per value: at the forward's
// (8,192, 5,120) bf16 that is 168 MB, 0.050 ms at 3.35 TB/s, against
// 0.0026 ms of f32 arithmetic. Design: one warp per row, eight rows per
// 256-thread block, so any R launches ceil(R / 8) blocks and nothing is
// padded. The warp reads its row in 16-byte vectors when D and every
// pointer allow it (D % 8 == 0 for bf16, D % 4 == 0 for f32; 5,120 is),
// so neighbouring lanes read neighbouring 16 bytes; the sum of squares is
// a warp-shuffle reduction in f32. The second pass re-reads the row, which
// the first pass has just brought into L1 (a 10 KB row), so device memory
// sees each value about once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

template <typename T, bool kVec>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ scale,
                               T* __restrict__ out, int64_t rows, int d,
                               float eps) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / V; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = lane; i < d / V; i += 32) {
      const uint4 u = xv[i];
      const uint4 s = __ldg(sv + i);
      const T* e = reinterpret_cast<const T*>(&u);
      const T* g = reinterpret_cast<const T*>(&s);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f<T>((to_f(e[j]) * inv) * to_f(g[j]));
      ov[i] = w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      orow[i] = from_f<T>((to_f(xr[i]) * inv) * to_f(__ldg(scale + i)));
    }
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* out, long long rows,
            int d, float eps, int vec, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (vec) {
    rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)scale, (T*)out, rows, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)scale, (T*)out, rows, d, eps);
  }
}

}  // namespace

// x, out: rows x d, contiguous; scale: d. dtype 0 = f32, 1 = bf16. vec = 1
// only when d is a multiple of the 16-byte vector and every pointer is
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             long long rows, int d, float eps, int dtype,
                             int vec, void* stream) {
  if (rows > 0 && d > 0) {
    if (dtype == 1) {
      launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vec,
                            (cudaStream_t)stream);
    } else {
      launch<float>(x, scale, out, rows, d, eps, vec, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
