// Fused RMS norm over rows for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rms_norm.py:rms_norm_pallas.
// Bound on an H100: memory bytes at large row counts, the launch itself at the
// serving shapes ((<=32) x 4096 bf16 is ~0.5 MB, ~0.2 us at 3.35 TB/s).
// Design: one block per row, 16-byte vector loads (8 bf16 or 4 f32 per load),
// a warp-shuffle then shared-memory fp32 sum of squares, rsqrtf, and a second
// pass over the row (still in L1/L2) that scales and writes in x's dtype. Row
// data never round-trips through device memory twice.
//
// Plain C interface (loaded with ctypes): rms_norm_launch returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

constexpr int kThreads = 256;

// VEC elements of T per load: 16 bytes when the row allows it, else 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * d);
  Pack<T, VEC>* orow = reinterpret_cast<Pack<T, VEC>*>(out + row * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T, VEC> p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(p.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T, VEC> p = xr[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      from_float(to_float(p.v[j]) * inv * scale[i * VEC + j], &o.v[j]);
    }
    orow[i] = o;
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* out, int rows, int d,
            float eps, int vectorized, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vectorized) {
    rms_norm_kernel<T, kVec><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
  } else {
    rms_norm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vectorized: the caller checked that d is
// a multiple of the 16-byte pack and that x/out are 16-byte aligned.
extern "C" int rms_norm_launch(const void* x, const void* scale, void* out,
                               int rows, int d, float eps, int dtype,
                               int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (dtype == 0) {
    launch<float>(x, scale, out, rows, d, eps, vectorized, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vectorized, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
