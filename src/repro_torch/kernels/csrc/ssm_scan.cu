// Chunked gated linear-attention scan (Mamba2 SSD / mLSTM), for Hopper
// (sm_90a).
//
//   S_t = exp(a_t) S_{t-1} + g_t k_t v_t^T      (state dk x dv, fp32)
//   y_t = q_t . S_t
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py:
// ssm_chunk_scan_pallas, with an optional initial state.
// Bound on an H100: float32 operations at the model's shapes. Per (b, h) and
// chunk of C steps the chunked form does C*C*dk (scores) + C*C*dv (intra y)
// + 2*C*dk*dv (inter y, state update) multiply-adds; at xlstm's dk = 512,
// dv = 513 that outweighs the bytes of q, k, v, y and the state.
//
// Design: the TPU kernel walks the chunks on a sequential grid axis and
// keeps the whole (dk, dv) state in VMEM. Here each dv column evolves on
// its own, so the grid is (B*H, ceil(dv/32)) and each block of 256 threads
// keeps its (dk x 32) fp32 state slice in shared memory and loops over the
// chunks in order. Per chunk:
//   A. load a, g and the v tile (C x 32); thread 0 forms A = cumsum(a);
//   B. stream q and k through shared memory in 32-wide dk slabs: each
//      thread accumulates an R x R micro-tile of the C x C scores q k^T in
//      registers (R = ceil(C/16)), and C/8 entries of q . S_prev;
//   C. W[t][s] = (s <= t) ? score * exp(clip(A_t - A_s)) * g_s : 0;
//   D. y[t][j] = sum_s W[t][s] v[s][j] + exp(clip(A_t)) * (q . S_prev)[t][j];
//   E. S[d][j] = exp(clip(A_C)) S[d][j] + sum_s (k[s][d] wk[s]) v[s][j],
//      wk[s] = exp(clip(A_C - A_s)) g_s, with k streamed again in slabs.
// The scores are recomputed for every dv tile. Operation order follows the
// reference (cumsum along C, clip before exp). wgmma and a shared score pass
// are later work.
//
// Plain C interface (loaded with ctypes): ssm_chunk_scan_launch returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTV = 32;     // dv columns per block
constexpr int kSlab = 32;   // dk rows per slab
constexpr int kLd = kSlab + 1;
constexpr float kClip = 60.f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }
__device__ __forceinline__ float exp_clip(float x) {
  return expf(fminf(fmaxf(x, -kClip), kClip));
}

// Shared memory layout (floats):
//   w_s  [C][C]         masked decay-weighted scores
//   q_s  [C][kLd]       q slab
//   k_s  [C][kLd]       k slab (phase E: k * wk)
//   st_s [dk][kTV]      the state slice
//   v_s  [C][kTV]       the v tile
//   a_s, g_s, wk_s [C]  cumulative log decay, gate, state-update weight
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ a,
                const float* __restrict__ g,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int dk, int dv,
                int C) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* q_s = w_s + C * C;
  float* k_s = q_s + C * kLd;
  float* st_s = k_s + C * kLd;
  float* v_s = st_s + dk * kTV;
  float* a_s = v_s + C * kTV;
  float* g_s = a_s + C;
  float* wk_s = g_s + C;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * kTV;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;   // score micro-tile coordinates
  const int jj = tid & 31, grp = tid >> 5;  // (column, row group) of y / S
  const int jcol = j0 + jj;
  const bool jvalid = jcol < dv;

  // the state slice: initial state or zeros
  for (int i = tid; i < dk * kTV; i += kThreads) {
    const int d = i / kTV, j = j0 + (i - d * kTV);
    float s0 = 0.f;
    if (init != nullptr && j < dv)
      s0 = init[(((int64_t)b * H + h) * dk + d) * dv + j];
    st_s[i] = s0;
  }

  const int n_chunks = S / C;
  const int n_slabs = (dk + kSlab - 1) / kSlab;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t_base = ci * C;
    // A. a, g, v tile
    for (int t = tid; t < C; t += kThreads) {
      const int64_t o = ((int64_t)b * S + t_base + t) * H + h;
      a_s[t] = a[o];
      g_s[t] = g[o];
    }
    for (int i = tid; i < C * kTV; i += kThreads) {
      const int t = i / kTV, j = j0 + (i - t * kTV);
      float val = 0.f;
      if (j < dv) val = to_float(v[(((int64_t)b * S + t_base + t) * H + h) * dv + j]);
      v_s[i] = val;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += a_s[t];
        a_s[t] = run;
      }
    }

    // B. scores and q . S_prev over dk slabs
    float acc[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int l = 0; l < R; ++l) acc[i][l] = 0.f;
    float qs[2 * R];
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) qs[i] = 0.f;

    for (int sl = 0; sl < n_slabs; ++sl) {
      const int d0 = sl * kSlab;
      __syncthreads();  // the previous slab is consumed
      for (int i = tid; i < C * kSlab; i += kThreads) {
        const int t = i / kSlab, dd = i - t * kSlab;
        float qv = 0.f, kv = 0.f;
        if (d0 + dd < dk) {
          const int64_t o = (((int64_t)b * S + t_base + t) * H + h) * dk + d0 + dd;
          qv = to_float(q[o]);
          kv = to_float(k[o]);
        }
        q_s[t * kLd + dd] = qv;
        k_s[t * kLd + dd] = kv;
      }
      __syncthreads();
      const int dn = dk - d0 < kSlab ? dk - d0 : kSlab;
      for (int dd = 0; dd < dn; ++dd) {
        float qr[R], kr[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = ty + 16 * i;
          qr[i] = t < C ? q_s[t * kLd + dd] : 0.f;
          const int s = tx + 16 * i;
          kr[i] = s < C ? k_s[s * kLd + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int l = 0; l < R; ++l) acc[i][l] += qr[i] * kr[l];
        const float sv = st_s[(d0 + dd) * kTV + jj];
#pragma unroll
        for (int i = 0; i < 2 * R; ++i) {
          const int t = grp + 8 * i;
          if (t < C) qs[i] += q_s[t * kLd + dd] * sv;
        }
      }
    }

    // C. masked, decay-weighted, gated scores
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int l = 0; l < R; ++l) {
        const int s = tx + 16 * l;
        if (t < C && s < C) {
          float wv = 0.f;
          if (s <= t) wv = acc[i][l] * exp_clip(a_s[t] - a_s[s]) * g_s[s];
          w_s[t * C + s] = wv;
        }
      }
    }
    __syncthreads();

    // D. y = W v + exp(clip(A_t)) * (q . S_prev)
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      const int t = grp + 8 * i;
      if (t < C) {
        float yv = 0.f;
        for (int s = 0; s <= t; ++s) yv += w_s[t * C + s] * v_s[s * kTV + jj];
        yv += exp_clip(a_s[t]) * qs[i];
        if (jvalid)
          from_float(yv, &y[(((int64_t)b * S + t_base + t) * H + h) * dv + jcol]);
      }
    }

    // E. state update, k streamed again in slabs
    const float a_tot = a_s[C - 1];
    for (int t = tid; t < C; t += kThreads)
      wk_s[t] = exp_clip(a_tot - a_s[t]) * g_s[t];
    const float decay = exp_clip(a_tot);
    for (int sl = 0; sl < n_slabs; ++sl) {
      const int d0 = sl * kSlab;
      __syncthreads();  // wk_s written; the previous slab is consumed
      for (int i = tid; i < C * kSlab; i += kThreads) {
        const int t = i / kSlab, dd = i - t * kSlab;
        float kv = 0.f;
        if (d0 + dd < dk)
          kv = to_float(k[(((int64_t)b * S + t_base + t) * H + h) * dk + d0 + dd]);
        k_s[t * kLd + dd] = kv * wk_s[t];
      }
      __syncthreads();
      for (int dd = grp; dd < kSlab; dd += kThreads / 32) {
        if (d0 + dd < dk) {
          float u = 0.f;
          for (int s = 0; s < C; ++s) u += k_s[s * kLd + dd] * v_s[s * kTV + jj];
          float* sp = st_s + (d0 + dd) * kTV + jj;
          *sp = decay * *sp + u;
        }
      }
    }
    __syncthreads();  // the state slice is updated before the next chunk
  }

  if (jvalid) {
    for (int d = grp; d < dk; d += kThreads / 32)
      state_out[(((int64_t)b * H + h) * dk + d) * dv + jcol] = st_s[d * kTV + jj];
  }
}

template <typename T, int R>
int launch_r(const void* q, const void* k, const void* v, const float* a,
             const float* g, const float* init, void* y, float* state,
             int B, int S, int H, int dk, int dv, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)C * C + 2 * (size_t)C * kLd + (size_t)dk * kTV +
       (size_t)C * kTV + 3 * (size_t)C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * H, (dv + kTV - 1) / kTV);
  ssm_scan_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), a, g, init, static_cast<T*>(y), state, S, H,
      dk, dv, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* a,
           const float* g, const float* init, void* y, float* state, int B,
           int S, int H, int dk, int dv, int C, cudaStream_t stream) {
  if (C <= 16)
    return launch_r<T, 1>(q, k, v, a, g, init, y, state, B, S, H, dk, dv, C, stream);
  if (C <= 32)
    return launch_r<T, 2>(q, k, v, a, g, init, y, state, B, S, H, dk, dv, C, stream);
  if (C <= 64)
    return launch_r<T, 4>(q, k, v, a, g, init, y, state, B, S, H, dk, dv, C, stream);
  if (C <= 128)
    return launch_r<T, 8>(q, k, v, a, g, init, y, state, B, S, H, dk, dv, C, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k: (B, S, H, dk); v, y: (B, S, H, dv); a (log decay), g (gate):
// (B, S, H) float32; init (may be null) and state: (B, H, dk, dv) float32.
// S is a multiple of C <= 128. dtype (of q, k, v, y): 0 = float32,
// 1 = bfloat16. The caller checked shapes, contiguity and shared memory.
extern "C" int ssm_chunk_scan_launch(const void* q, const void* k,
                                     const void* v, const void* a,
                                     const void* g, const void* init,
                                     void* y, void* state, int B, int S,
                                     int H, int dk, int dv, int C,
                                     int has_init, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  const float* in = has_init ? static_cast<const float*>(init) : nullptr;
  float* st = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(q, k, v, af, gf, in, y, st, B, S, H, dk, dv, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, af, gf, in, y, st, B, S, H, dk, dv,
                                 C, s);
  return (int)cudaErrorInvalidValue;
}
