// RMS norm over rows for Hopper (sm_90a), with an optional residual add in
// front of it:
//   s   = x + r                      (in x's dtype, rounded as PyTorch's add)
//   out = s * rsqrt(mean(s^2) + eps) * scale
//
// Replaces the Pallas TPU kernel repro/kernels/rms_norm.py:rms_norm_pallas.
// The residual add is the neighbour that XLA fuses into the reference's jnp
// norm (repro/models/layers.py:rms_norm); here it rides in the same launch.
//
// Bound on an H100: memory bytes.  At the serving shapes ((<=32) x 4096
// bf16, a quarter of a MB each way) that bound is about 0.2 us and one
// launch's chain of dependent steps is the cost, so the design shortens it:
//  * one read of the row: each thread loads its 16-byte packs of x (and r)
//    into registers once; the sum of squares, the normalisation and the
//    scaling all come from those registers;
//  * the thread's slice of the scale is loaded (float4) first, so that its
//    latency hides behind the loads of x and the reduction;
//  * one barrier: a warp shuffle, one shared-memory exchange, then every
//    warp reduces the warp sums itself (no serial tail, no second barrier);
//  * one CTA a row.  Splitting a decode batch's rows over thread block
//    clusters of 2-8 CTAs (partial sums through distributed shared memory)
//    was measured slower at every decode shape: the cluster barrier costs
//    more than the ~0.5 us the whole kernel takes above an empty launch.
// Rows whose width does not divide the 16-byte pack, that are not 16-byte
// aligned, or that are too wide for the registers take a scalar kernel that
// reads the row twice.
//
// The residual sum s is rounded to x's dtype before it is squared, so the
// fused call is bit-identical to an add followed by the plain norm on the
// same path (packed or scalar).
//
// Plain C interface (loaded with ctypes): rms_norm_launch returns the
// launch's cudaError_t; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// PyTorch's add in T: the sum in fp32, rounded to nearest even
template <typename T>
__device__ __forceinline__ T add_round(T a, T b) {
  return from_float<T>(to_float(a) + to_float(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's total in every thread, behind one barrier: each warp reduces
// the warp sums itself.  blockDim.x is a multiple of 32.  The butterfly
// gives every lane the same bits, so every thread holds the same total.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane]
                                                           : 0.f);
}

// values of T in one 16-byte pack, moved as a uint4 (one 128-bit access)
template <typename T>
constexpr int kPack = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ T* elems(uint4& p) {
  return reinterpret_cast<T*>(&p);
}

// One CTA per row.  The row's `packs` 16-byte packs are held NP to a
// thread, thread t taking packs t, t + blockDim.x, ...
template <typename T, int NP, bool RESID>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_packed(const T* __restrict__ x, const T* __restrict__ r,
                const float* __restrict__ scale, T* __restrict__ out,
                T* __restrict__ s_out, int d, float eps) {
  constexpr int N = kPack<T>;
  const int packs = d / N;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * packs;

  float sc[NP][N];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < packs) {
      const float4* sp =
          reinterpret_cast<const float4*>(scale) + i * (N / 4);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 t = __ldg(sp + q);
        sc[k][4 * q] = t.x;
        sc[k][4 * q + 1] = t.y;
        sc[k][4 * q + 2] = t.z;
        sc[k][4 * q + 3] = t.w;
      }
    }
  }
  uint4 v[NP];
  uint4 rv[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < packs) {
      v[k] = reinterpret_cast<const uint4*>(x)[first + i];
      if (RESID) rv[k] = reinterpret_cast<const uint4*>(r)[first + i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < packs) {
      T* e = elems<T>(v[k]);
      if (RESID) {
        const T* re = elems<T>(rv[k]);
#pragma unroll
        for (int j = 0; j < N; ++j) e[j] = add_round(e[j], re[j]);
        reinterpret_cast<uint4*>(s_out)[first + i] = v[k];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_float(e[j]);
        ss += f * f;
      }
    }
  }

  __shared__ float warp_sums[32];
  const float inv =
      rsqrtf(block_sum(ss, warp_sums) / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < packs) {
      const T* e = elems<T>(v[k]);
      uint4 o;
      T* oe = elems<T>(o);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        oe[j] = from_float<T>(to_float(e[j]) * inv * sc[k][j]);
      }
      reinterpret_cast<uint4*>(out)[first + i] = o;
    }
  }
}

// Any width and alignment: one CTA per row, scalar loads, the row read
// twice (the sum s is recomputed, with the same rounding, in the second).
template <typename T, bool RESID>
__global__ void __launch_bounds__(kScalarThreads)
rms_norm_scalar(const T* __restrict__ x, const T* __restrict__ r,
                const float* __restrict__ scale, T* __restrict__ out,
                T* __restrict__ s_out, int d, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    T v = x[base + i];
    if (RESID) {
      v = add_round(v, r[base + i]);
      s_out[base + i] = v;
    }
    const float f = to_float(v);
    ss += f * f;
  }
  __shared__ float warp_sums[32];
  const float inv =
      rsqrtf(block_sum(ss, warp_sums) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    T v = x[base + i];
    if (RESID) v = add_round(v, r[base + i]);
    out[base + i] = from_float<T>(to_float(v) * inv * scale[i]);
  }
}

template <typename T, int NP, bool RESID>
cudaError_t launch_packed(const T* x, const T* r, const float* scale, T* out,
                          T* s_out, int rows, int d, float eps,
                          cudaStream_t stream) {
  const int packs = d / kPack<T>;
  const int threads = ((packs + NP - 1) / NP + 31) / 32 * 32;
  rms_norm_packed<T, NP, RESID><<<rows, threads, 0, stream>>>(
      x, r, scale, out, s_out, d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The packed kernel when the row divides into 16-byte packs, at most
// 8 * kMaxThreads of them, and every pointer is 16-byte aligned; NP packs a
// thread, the fewest that keep a CTA at <= kMaxThreads threads.  Any other
// row takes the scalar kernel.
template <typename T, bool RESID>
cudaError_t launch(const void* x, const void* r, const void* scale,
                   void* out, void* s_out, int rows, int d, float eps,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  T* so = static_cast<T*>(s_out);
  const int packs = d / kPack<T>;
  const bool packed = d % kPack<T> == 0 && packs <= 8 * kMaxThreads &&
                      aligned16(x) && aligned16(scale) && aligned16(out) &&
                      (!RESID || (aligned16(r) && aligned16(s_out)));
  if (!packed) {
    rms_norm_scalar<T, RESID><<<rows, kScalarThreads, 0, stream>>>(
        xt, rt, st, ot, so, d, eps);
    return cudaGetLastError();
  }
  if (packs <= kMaxThreads) {
    return launch_packed<T, 1, RESID>(xt, rt, st, ot, so, rows, d, eps,
                                      stream);
  }
  if (packs <= 2 * kMaxThreads) {
    return launch_packed<T, 2, RESID>(xt, rt, st, ot, so, rows, d, eps,
                                      stream);
  }
  if (packs <= 4 * kMaxThreads) {
    return launch_packed<T, 4, RESID>(xt, rt, st, ot, so, rows, d, eps,
                                      stream);
  }
  return launch_packed<T, 8, RESID>(xt, rt, st, ot, so, rows, d, eps,
                                    stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* r, const void* scale,
                     void* out, void* s_out, int rows, int d, float eps,
                     cudaStream_t stream) {
  if (r != nullptr) {
    return launch<T, true>(x, r, scale, out, s_out, rows, d, eps, stream);
  }
  return launch<T, false>(x, r, scale, out, s_out, rows, d, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r and s_out: the residual and the sum
// x + r, both null for a plain norm.  Every tensor is contiguous; scale has
// d entries.
extern "C" int rms_norm_launch(const void* x, const void* r,
                               const void* scale, void* out, void* s_out,
                               int rows, int d, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if ((r == nullptr) != (s_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(x, r, scale, out, s_out, rows, d, eps, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, r, scale, out, s_out, rows, d, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
