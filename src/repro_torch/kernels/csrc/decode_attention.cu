// One-token GQA decode attention over a contiguous per-slot KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:decode_attention_pallas, with the
// sliding-window and rolling masks of the model function it serves
// (repro/models/attention.py:decode_attention).
// Bound on an H100: memory bytes. Per call it must read each live K/V row of
// every (row, kv-head) once (2 * sum(span) * Hkv * hd elements) plus q and
// the output; the arithmetic (4 * G * hd flops per K/V row pair) is far
// below the card's ratio of ~295 flops per byte.
//
// Design: one block of four warps per (row b, kv head h). The block keeps its
// G query rows in shared memory, pre-scaled by 1/sqrt(hd) in fp32 and rounded
// to the cache dtype (as the plain version rounds them), and walks only the
// row's live span [lo, hi): hi = min(len, L); lo = max(0, len - window) for
// a non-rolling sliding window, else 0 (the Pallas grid walks every tile of
// L). Each 32-token tile of K and V is staged in shared memory with 16-byte
// loads. Scores: one warp per token, the lanes splitting hd, a shuffle sum
// per query head. Online softmax: one warp per query head, one lane per
// token of the tile. The G x hd accumulator lives in fp32 registers. A row
// whose span is empty writes zeros. Split-KV, wgmma and TMA are later work.
//
// Plain C interface (loaded with ctypes): decode_attention_launch returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // tokens per tile: one per lane
constexpr int kMaxG = 8;
constexpr int kMaxAccPerThread = 16;  // G * hd <= 2048
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }
// round an fp32 value to T and back (the plain version's .to(cache dtype))
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory layout (floats):
//   q_s  [G][hd]        pre-scaled, rounded queries
//   k_s  [kTile][hd]    K tile
//   v_s  [kTile][hd]    V tile
//   p_s  [G][kTile]     scores, then probabilities
//   alpha_s, m_s, l_s [G]  rescale, running max and running sum per query
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int Hq, int Hkv, int hd, int L,
                        int window, int rolling, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  float* q_s = smem;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + kTile * hd;
  float* p_s = v_s + kTile * hd;
  float* alpha_s = p_s + G * kTile;
  float* m_s = alpha_s + G;
  float* l_s = m_s + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads)
    q_s[i] = round_to(to_float(qb[i]) * scale, q);
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[kMaxAccPerThread];
#pragma unroll
  for (int j = 0; j < kMaxAccPerThread; ++j) acc[j] = 0.f;

  const int len = lengths[b];
  const int hi = len < L ? (len > 0 ? len : 0) : L;
  int lo = 0;
  if (!rolling && window > 0 && len - window > 0) lo = len - window;
  const int packs_per_row = hd / Pack<T>::kN;
  const int64_t row_stride = (int64_t)Hkv * hd;  // elements between tokens
  const int64_t base = ((int64_t)b * L * Hkv + h) * hd;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = hi - t0 < kTile ? hi - t0 : kTile;

    // stage K and V tiles: n rows of hd contiguous elements each
    for (int idx = tid; idx < n * packs_per_row; idx += kThreads) {
      const int t = idx / packs_per_row;
      const int c = idx - t * packs_per_row;
      const int64_t off = base + (int64_t)(t0 + t) * row_stride;
      const Pack<T> kp = reinterpret_cast<const Pack<T>*>(k + off)[c];
      const Pack<T> vp = reinterpret_cast<const Pack<T>*>(v + off)[c];
#pragma unroll
      for (int e = 0; e < Pack<T>::kN; ++e) {
        const int col = c * Pack<T>::kN + e;
        k_s[t * hd + col] = to_float(kp.v[e]);
        v_s[t * hd + col] = to_float(vp.v[e]);
      }
    }
    __syncthreads();

    // scores (G x kTile): one warp per token, lanes split hd
    for (int t = warp; t < kTile; t += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (t < n) {
        for (int d = lane; d < hd; d += 32) {
          const float kd = k_s[t * hd + d];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] += q_s[g * hd + d] * kd;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) p_s[g * kTile + t] = t < n ? s : kNeg;
        }
      }
    }
    __syncthreads();

    // online softmax statistics: one warp per query head, one lane a token
    for (int g = warp; g < G; g += kWarps) {
      const float m_old = m_s[g];
      const float s = p_s[g * kTile + lane];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kMaxAccPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < G * hd) {
        const int g = idx / hd;
        const int dd = idx - g * hd;
        const float* pr = p_s + g * kTile;
        float a = acc[j] * alpha_s[g];
        for (int t = 0; t < n; ++t) a += pr[t] * v_s[t * hd + dd];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((int64_t)b * Hq + (int64_t)h * G) * hd;
  const bool live = hi > lo;
#pragma unroll
  for (int j = 0; j < kMaxAccPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * hd) {
      const int g = idx / hd;
      from_float(live ? acc[j] / fmaxf(l_s[g], 1e-30f) : 0.f, &ob[idx]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const int32_t* lengths, void* out, int B, int Hq, int Hkv, int hd,
           int L, int window, int rolling, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + 2 * (size_t)kTile * hd + (size_t)G * kTile +
       3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(Hkv, B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), Hq, Hkv, hd,
      L, window, rolling, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, hd); k/v: (B, L, Hkv, hd); lengths: (B,) int32; out: (B, Hq,
// hd). window: sliding window (0 = none, ignored when rolling); rolling: 1
// for a ring-buffer cache. dtype: 0 = float32, 1 = bfloat16. The caller
// checked Hq % Hkv == 0, G <= 8, hd % 8 == 0, G * hd <= 2048 and 16-byte
// alignment of k and v.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int Hq, int Hkv,
                                       int hd, int L, int window, int rolling,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const int32_t* l = static_cast<const int32_t*>(lengths);
  if (dtype == 0) {
    return launch<float>(q, k, v, l, out, B, Hq, Hkv, hd, L, window, rolling,
                         s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, l, out, B, Hq, Hkv, hd, L, window,
                                 rolling, s);
  }
  return (int)cudaErrorInvalidValue;
}
