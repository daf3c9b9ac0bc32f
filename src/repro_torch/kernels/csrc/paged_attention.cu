// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py:paged_decode_attention_pallas.
// Bound on an H100: memory bytes. Per call it must read each live K/V row of
// every (row, kv-head) once (2 * sum(len) * Hkv * hd elements) plus q and the
// output; the arithmetic (4 * G * hd flops per K/V row pair) is far below the
// card's ratio of ~295 flops per byte.
//
// Design: one block per (row b, kv head h). The block keeps its G query rows
// in shared memory, pre-scaled by 1/sqrt(hd) in fp32, and walks ONLY the
// ceil(len / bs) live entries of its row's block table (the Pallas grid walks
// every max_blocks entry). For each live block it stages the (bs x hd) K and V
// tiles of physical block tables[b, i] in shared memory with 16-byte loads,
// forms the G x bs scores with fp32 accumulation, applies the online softmax,
// and accumulates G x hd in fp32 registers. Table entries of -1 are skipped
// (masked, as in the Pallas kernel). A row with lengths == 0 writes zeros.
// Split-KV, wgmma and TMA are left for later work.
//
// Plain C interface (loaded with ctypes): paged_decode_attention_launch
// returns cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAccPerThread = 16;  // G * hd <= 2048
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// Shared memory layout (floats):
//   q_s  [G][hd]        pre-scaled queries
//   k_s  [bs][hd + 1]   K tile (padded row: conflict-free column reads)
//   v_s  [bs][hd]       V tile
//   p_s  [G][bs]        scores, then probabilities
//   alpha_s, m_s, l_s [G]  rescale, running max and running sum per query
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    int Hq, int Hkv, int hd, int bs, int max_blocks,
                    int n_pool_blocks, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int hdp = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + bs * hdp;
  float* p_s = v_s + bs * hd;
  float* alpha_s = p_s + G * bs;
  float* m_s = alpha_s + G;
  float* l_s = m_s + G;

  const int tid = threadIdx.x;
  const T* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_float(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[kMaxAccPerThread];
#pragma unroll
  for (int j = 0; j < kMaxAccPerThread; ++j) acc[j] = 0.f;

  const int len = lengths[b];
  int n_live = (len + bs - 1) / bs;
  if (n_live > max_blocks) n_live = max_blocks;
  const int packs_per_row = hd / Pack<T>::kN;
  const int64_t row_stride = (int64_t)Hkv * hd;  // elements between tokens
  __syncthreads();

  for (int i = 0; i < n_live; ++i) {
    int phys = tables[(int64_t)b * max_blocks + i];
    if (phys < 0) continue;  // unallocated entry: masked
    if (phys >= n_pool_blocks) phys = n_pool_blocks - 1;
    const int64_t base = ((int64_t)phys * bs * Hkv + h) * hd;

    // stage K and V tiles: bs rows of hd contiguous elements each
    for (int idx = tid; idx < bs * packs_per_row; idx += kThreads) {
      const int t = idx / packs_per_row;
      const int c = idx - t * packs_per_row;
      const int64_t off = base + t * row_stride;
      const Pack<T> kp = reinterpret_cast<const Pack<T>*>(k_pool + off)[c];
      const Pack<T> vp = reinterpret_cast<const Pack<T>*>(v_pool + off)[c];
#pragma unroll
      for (int e = 0; e < Pack<T>::kN; ++e) {
        const int col = c * Pack<T>::kN + e;
        k_s[t * hdp + col] = to_float(kp.v[e]);
        v_s[t * hd + col] = to_float(vp.v[e]);
      }
    }
    __syncthreads();

    // scores (G x bs), masked past the row's length
    for (int idx = tid; idx < G * bs; idx += kThreads) {
      const int g = idx / bs;
      const int t = idx - g * bs;
      float s = kNeg;
      if (i * bs + t < len) {
        s = 0.f;
        const float* qr = q_s + g * hd;
        const float* kr = k_s + t * hdp;
        for (int dd = 0; dd < hd; ++dd) s += qr[dd] * kr[dd];
      }
      p_s[idx] = s;
    }
    __syncthreads();

    // online softmax statistics, one thread per query head
    if (tid < G) {
      float* pr = p_s + tid * bs;
      float mx = m_s[tid];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, pr[t]);
      const float alpha = expf(m_s[tid] - mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(pr[t] - mx);
        pr[t] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mx;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kMaxAccPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < G * hd) {
        const int g = idx / hd;
        const int dd = idx - g * hd;
        const float* pr = p_s + g * bs;
        float a = acc[j] * alpha_s[g];
        for (int t = 0; t < bs; ++t) a += pr[t] * v_s[t * hd + dd];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((int64_t)b * Hq + (int64_t)h * G) * hd;
#pragma unroll
  for (int j = 0; j < kMaxAccPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * hd) {
      const int g = idx / hd;
      from_float(acc[j] / fmaxf(l_s[g], 1e-30f), &ob[idx]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int32_t* tables, const int32_t* lengths, void* out, int B,
           int Hq, int Hkv, int hd, int bs, int max_blocks, int n_pool_blocks,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + (size_t)bs * (hd + 1) + (size_t)bs * hd +
       (size_t)G * bs + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out),
      Hq, Hkv, hd, bs, max_blocks, n_pool_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, hd); k_pool/v_pool: (n_pool_blocks, bs, Hkv, hd) of ONE layer;
// tables: (B, max_blocks) int32; lengths: (B,) int32; out: (B, Hq, hd).
// dtype: 0 = float32, 1 = bfloat16. The caller checked Hq % Hkv == 0,
// hd % 8 == 0 and G * hd <= 2048.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int Hq, int Hkv, int hd, int bs,
    int max_blocks, int n_pool_blocks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  if (dtype == 0) {
    return launch<float>(q, k_pool, v_pool, t, l, out, B, Hq, Hkv, hd, bs,
                         max_blocks, n_pool_blocks, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, t, l, out, B, Hq, Hkv,
                                 hd, bs, max_blocks, n_pool_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
