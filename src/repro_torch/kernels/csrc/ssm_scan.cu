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
// dv = 513 that outweighs the bytes of q, k, v, y and the state. The model
// calls the scan in float32, so every product is an fp32 FMA (TF32 tensor
// cores would break the 1e-3 gate).
//
// Design: the TPU kernel walks the chunks on a sequential grid axis and
// keeps the whole (dk, dv) state in VMEM. Here the work is split in two
// passes, both launched by ssm_chunk_scan_launch on the caller's stream:
//
// 1. Scores pass, grid (B*H*n_chunks), every chunk in parallel. Lane 0
//    forms A = cumsum(a) left to right, as the plain version does, while
//    the first slab is in flight; q and k stream through shared
//    memory in 32-wide dk slabs, two in flight, and each of 256 threads
//    accumulates an R x R micro-tile of q k^T (R = CP/16, CP the chunk
//    rounded up to 16, 32, 64 or 128) from float4 reads. It writes one
//    record per chunk to a workspace the wrapper allocates:
//      W[t][s] = (s <= t) ? (q_t . k_s) exp(clip(A_t - A_s)) g_s : 0
//      eA[t]   = exp(clip(A_t)),  wk[s] = exp(clip(A_C - A_s)) g_s
//    (CP x CP + 2 CP floats, zero past C). The scores are formed once per
//    chunk, not once per dv tile.
// 2. Scan pass, grid (B*H, ceil(dv/TV)), TV = 64 (32 where 64 does not fit
//    shared memory). Each block keeps its (dk x TV) fp32 state slice in
//    shared memory and walks the chunks in order. Per chunk:
//      y = W v + eA * (q . S_prev)            (C x TV)
//      S = exp(clip(A_C)) S + k^T (wk * v)    (dk x TV, in 64-row slabs)
//    q and k stream through two stages of 64-wide dk slabs, the next slab
//    in flight while the current one is multiplied. The products are
//    register-tiled: for y a thread owns R rows x 4 columns (mma_rows),
//    for S 4 (or 2) consecutive dk rows x 4 columns (mma_cols), and both
//    read their operands from shared memory as float4. After the last
//    chunk each slab's state rows are stored as soon as they are final.
//    With no initial state (a null pointer; values are never inspected)
//    chunk 0 skips q . S_prev and the decay of S, which are exactly zero.
//
// Loads are cp.async copies (16 bytes where the rows allow it), so they
// hold no registers while in flight; at 256 threads the scan pass keeps
// 2 blocks an SM at zamba2's dk = 64 and 1 at xlstm's dk = 512, where the
// state slice takes 128 KB of shared memory.
//
// The backward (ssm_chunk_scan_bwd_launch, below the forward) replaces
// no TPU kernel: the reference differentiates its jnp chunked form.
//
// Plain C interface (loaded with ctypes): each launcher returns
// cudaGetLastError() after its launches; none synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab1 = 32;          // dk columns a scores-pass slab
constexpr int kLd1 = kSlab1 + 4;    // its row stride (float4-aligned)
constexpr int kSlab2 = 64;          // dk columns a scan-pass slab
constexpr int kLd2 = kSlab2 + 4;
constexpr float kClip = 60.f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }
__device__ __forceinline__ float exp_clip(float x) {
  return expf(fminf(fmaxf(x, -kClip), kClip));
}

// Global -> shared copies. float32 goes through cp.async (no registers,
// the copy in flight while the block computes; src_size 0 zero-fills an
// element past the edge), bfloat16 through a converting load and store.
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          const float* safe, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(valid ? src : safe), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_elem(float* dst, const __nv_bfloat16* src,
                                          const __nv_bfloat16*, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 consecutive elements: one 16-byte copy where the caller knows them
// aligned and float32 (vec), else one copy each
template <typename T>
__device__ __forceinline__ void copy4(float* dst, const T* src, const T* safe,
                                      int n_valid, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      copy16(dst, n_valid > 0 ? src : safe, n_valid > 0);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) copy_elem(dst + e, src + e, safe, e < n_valid);
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// one chunk's workspace record: W [CP][CP], eA [CP], wk [CP]
__host__ __device__ constexpr int64_t record_floats(int cp) {
  return (int64_t)cp * cp + 2 * cp;
}
// the backward's record: Z [CP][CP], eA [CP], ec [CP], A [CP]
__host__ __device__ constexpr int64_t bwd_record_floats(int cp) {
  return (int64_t)cp * cp + 3 * cp;
}
size_t scores_smem(int cp) {
  return sizeof(float) * ((size_t)2 * 2 * cp * kLd1 + 2 * cp);
}
size_t scan_smem(int cp, int dk, int tv) {
  return sizeof(float) * ((size_t)round_up(dk, kSlab2) * tv + (size_t)cp * tv +
                          (size_t)cp * (cp + 4) + (size_t)2 * cp * kLd2 +
                          2 * cp);
}

// ---------------------------------------------------------------- pass 1

// Shared memory (floats): two stages of q_s [CP][kLd1] and k_s [CP][kLd1],
// then A_s [CP], g_s [CP]. Up to CP = 64 the micro-tile fits 64 registers,
// so four blocks share an SM. kBwd writes the backward's record instead:
//   Z[t][s] = (s <= t) ? (q_t . k_s) exp(clip(A_t - A_s)) : 0   (W without
//   the gate, so that W = Z g_s rounds as the forward's W does),
//   eA[t], ec[s] = exp(clip(A_C - A_s)) and A[t]   (bwd_record_floats).
template <typename T, int CP, bool kBwd = false>
__global__ void __launch_bounds__(kThreads, CP <= 64 ? 4 : 1)
ssm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const float* __restrict__ a, const float* __restrict__ g,
                  float* __restrict__ ws, int S, int H, int dk, int C,
                  bool vec) {
  constexpr int R = CP / 16;
  constexpr int kStage = 2 * CP * kLd1;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* A_s = stages + 2 * kStage;
  float* g_s = A_s + CP;

  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t tb = (int64_t)b * S + (int64_t)ci * C;  // first step
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  auto fetch = [&](int d0, float* st) {
    for (int i = tid; i < CP * kSlab1 / 4; i += kThreads) {
      const int t = i / (kSlab1 / 4), dd = 4 * (i % (kSlab1 / 4));
      const int nv = t < C ? min(4, dk - d0 - dd) : 0;
      const int64_t o = ((tb + t) * H + h) * dk + d0 + dd;
      copy4(st + t * kLd1 + dd, q + o, q, nv, vec);
      copy4(st + CP * kLd1 + t * kLd1 + dd, k + o, k, nv, vec);
    }
  };
  const int n_slabs = (dk + kSlab1 - 1) / kSlab1;
  fetch(0, stages);
  copy_commit();

  // A = cumsum(a): warp 0 loads a, then lane 0 adds it up left to right,
  // in the plain version's order, while the first slab is in flight. A
  // parallel scan rounds A differently, and at chunk 128 (|A| ~ 100) the
  // difference in exp(A_t - A_s) is ~1e-3 of a score, past the gate where
  // a row of y cancels. Steps past C add zero, so A holds A_{C-1} there.
  if (tid < 32) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = 4 * tid + u;
      if (t < CP) A_s[t] = t < C ? a[(tb + t) * H + h] : 0.f;
    }
    __syncwarp();
    if (tid == 0) {
      float run = 0.f;
#pragma unroll 1
      for (int t0 = 0; t0 < CP; t0 += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = A_s[t0 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          run += x[u];
          A_s[t0 + u] = run;
        }
      }
    }
  }
  for (int t = tid; t < CP; t += kThreads)
    g_s[t] = t < C ? g[(tb + t) * H + h] : 0.f;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int l = 0; l < R; ++l) acc[i][l] = 0.f;

  for (int n = 0; n < n_slabs; ++n) {
    copy_wait();
    __syncthreads();  // slab n landed; slab n - 1 is consumed
    if (n + 1 < n_slabs) {
      fetch((n + 1) * kSlab1, stages + ((n + 1) & 1) * kStage);
      copy_commit();
    }
    const float* q_s = stages + (n & 1) * kStage;
    const float* k_s = q_s + CP * kLd1;
#pragma unroll 1
    for (int dd = 0; dd < kSlab1; dd += 4) {
      float4 kr[R];
#pragma unroll
      for (int l = 0; l < R; ++l)
        kr[l] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * l) * kLd1 + dd);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qr =
            *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * kLd1 + dd);
#pragma unroll
        for (int l = 0; l < R; ++l) {
          float s = acc[i][l];
          s = fmaf(qr.x, kr[l].x, s);
          s = fmaf(qr.y, kr[l].y, s);
          s = fmaf(qr.z, kr[l].z, s);
          s = fmaf(qr.w, kr[l].w, s);
          acc[i][l] = s;
        }
      }
    }
  }
  __syncthreads();  // A_s, g_s visible (dk >= 1 gives one barrier above too)

  float* rec = ws + (int64_t)blockIdx.x *
                        (kBwd ? bwd_record_floats(CP) : record_floats(CP));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int l = 0; l < R; ++l) {
      const int s = tx + 16 * l;
      float w = 0.f;
      if (s <= t && t < C) {
        w = acc[i][l] * exp_clip(A_s[t] - A_s[s]);
        if constexpr (!kBwd) w *= g_s[s];
      }
      rec[t * CP + s] = w;
    }
  }
  const float a_tot = A_s[C - 1];
  for (int t = tid; t < CP; t += kThreads) {
    rec[CP * CP + t] = t < C ? exp_clip(A_s[t]) : 0.f;
    if constexpr (kBwd) {
      rec[CP * CP + CP + t] = t < C ? exp_clip(a_tot - A_s[t]) : 0.f;
      rec[CP * CP + 2 * CP + t] = A_s[t];
    } else {
      rec[CP * CP + CP + t] = t < C ? exp_clip(a_tot - A_s[t]) * g_s[t] : 0.f;
    }
  }
}

// ---------------------------------------------------------------- pass 2

// acc[i][c] += sum_{kk < K} A[r_i][kk] * B[kk][j + c], r_i = rg + NRG * i
// (clamped to rmax: a clamped row's sums are never stored). A, B row-major
// in shared memory with float4-aligned strides; K a multiple of 4.
template <int R, int NRG>
__device__ __forceinline__ void mma_rows(float (&acc)[R][4],
                                         const float* __restrict__ A, int lda,
                                         const float* __restrict__ Bm, int ldb,
                                         int K, int rg, int rmax, int j) {
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(Bm + (kk + 0) * ldb + j);
    const float4 b1 = *reinterpret_cast<const float4*>(Bm + (kk + 1) * ldb + j);
    const float4 b2 = *reinterpret_cast<const float4*>(Bm + (kk + 2) * ldb + j);
    const float4 b3 = *reinterpret_cast<const float4*>(Bm + (kk + 3) * ldb + j);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = min(rg + NRG * i, rmax);
      const float4 av = *reinterpret_cast<const float4*>(A + r * lda + kk);
      acc[i][0] = fmaf(av.x, b0.x, acc[i][0]);
      acc[i][1] = fmaf(av.x, b0.y, acc[i][1]);
      acc[i][2] = fmaf(av.x, b0.z, acc[i][2]);
      acc[i][3] = fmaf(av.x, b0.w, acc[i][3]);
      acc[i][0] = fmaf(av.y, b1.x, acc[i][0]);
      acc[i][1] = fmaf(av.y, b1.y, acc[i][1]);
      acc[i][2] = fmaf(av.y, b1.z, acc[i][2]);
      acc[i][3] = fmaf(av.y, b1.w, acc[i][3]);
      acc[i][0] = fmaf(av.z, b2.x, acc[i][0]);
      acc[i][1] = fmaf(av.z, b2.y, acc[i][1]);
      acc[i][2] = fmaf(av.z, b2.z, acc[i][2]);
      acc[i][3] = fmaf(av.z, b2.w, acc[i][3]);
      acc[i][0] = fmaf(av.w, b3.x, acc[i][0]);
      acc[i][1] = fmaf(av.w, b3.y, acc[i][1]);
      acc[i][2] = fmaf(av.w, b3.z, acc[i][2]);
      acc[i][3] = fmaf(av.w, b3.w, acc[i][3]);
    }
  }
}

// u[i][c] += sum_{s < K} Kt[s][dl + i] * B[s][j + c]: the state update's
// product, a thread owning RU consecutive rows (dk) of the slab, read as
// one float4 (RU = 4) or float2 (RU = 2) a step.
template <int RU>
__device__ __forceinline__ void mma_cols(float (&u)[RU][4],
                                         const float* __restrict__ Kt, int ldk,
                                         const float* __restrict__ Bm, int ldb,
                                         int K, int dl, int j) {
#pragma unroll 4
  for (int s = 0; s < K; ++s) {
    const float4 bv = *reinterpret_cast<const float4*>(Bm + s * ldb + j);
    float kv[RU];
    if constexpr (RU == 4) {
      const float4 t = *reinterpret_cast<const float4*>(Kt + s * ldk + dl);
      kv[0] = t.x; kv[1] = t.y; kv[2] = t.z; kv[3] = t.w;
    } else {
      static_assert(RU == 2, "RU is 2 or 4");
      const float2 t = *reinterpret_cast<const float2*>(Kt + s * ldk + dl);
      kv[0] = t.x; kv[1] = t.y;
    }
#pragma unroll
    for (int i = 0; i < RU; ++i) {
      u[i][0] = fmaf(kv[i], bv.x, u[i][0]);
      u[i][1] = fmaf(kv[i], bv.y, u[i][1]);
      u[i][2] = fmaf(kv[i], bv.z, u[i][2]);
      u[i][3] = fmaf(kv[i], bv.w, u[i][3]);
    }
  }
}

// Shared memory (floats):
//   st_s  [dk_pad][TV]   the state slice (dk_pad = dk rounded up to 64;
//                        rows past dk stay zero)
//   v_s   [CP][TV]       the v tile (zero past C and dv), scaled by wk
//                        in place once y is written
//   x_s   2 x [CP][kLd2] two stages of a 64-wide dk slab of q or k
//   ea_s, wk_s [CP]
// (the explicit minimum of one block lets ptxas use up to 255 registers;
// with it no instantiation spills). kRecord is the backward's recompute:
// it writes the state entering each chunk to states [B*H][n_chunks][dk][dv]
// and skips y, the last chunk's update and the final state.
template <typename T, int CP, int TV, bool kRecord = false>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ws,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ state_out, float* __restrict__ states,
                int S, int H, int dk, int dv, int C, bool vec_qk,
                bool vec_v) {
  constexpr int NCG = TV / 4;             // column groups of 4
  constexpr int NRG = kThreads / NCG;     // row groups
  constexpr int R = CP >= NRG ? CP / NRG : 1;
  constexpr int RU = kSlab2 / NRG;
  constexpr int kStage = CP * kLd2;
  constexpr int LDW = CP + 4;
  extern __shared__ float4 smem4[];
  const int dk_pad = round_up(dk, kSlab2);
  float* st_s = reinterpret_cast<float*>(smem4);
  float* v_s = st_s + dk_pad * TV;
  float* w_s = v_s + CP * TV;
  float* x_s = w_s + CP * LDW;
  float* ea_s = x_s + 2 * kStage;
  float* wk_s = ea_s + CP;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * TV;
  const int tid = threadIdx.x;
  const int jl = (tid % NCG) * 4;
  const int rg = tid / NCG;
  const int n_chunks = S / C;
  const int n_slabs = dk_pad / kSlab2;
  const int C4 = round_up(C, 4);
  const bool has_init = init != nullptr;

  if (has_init) {
    for (int i = tid; i < dk_pad * TV; i += kThreads) {
      const int d = i / TV, j = j0 + i % TV;
      copy_elem(st_s + i, init + ((int64_t)bh * dk + d) * dv + j, init,
                d < dk && j < dv);
    }
  }
  // one 64-wide dk slab of q or k, rows t < CP, into a stage
  auto fetch = [&](const T* src, int64_t tb, int d0, float* stage) {
    for (int i = tid; i < CP * kSlab2 / 4; i += kThreads) {
      const int t = i / (kSlab2 / 4), dd = 4 * (i % (kSlab2 / 4));
      copy4(stage + t * kLd2 + dd, src + ((tb + t) * H + h) * dk + d0 + dd,
            src, t < C ? min(4, dk - d0 - dd) : 0, vec_qk);
    }
    copy_commit();
  };

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int64_t tb = (int64_t)b * S + (int64_t)ci * C;
    const float* rec = ws + ((int64_t)bh * n_chunks + ci) * record_floats(CP);
    const bool carry = has_init || ci > 0;
    for (int i = tid; i < CP * TV / 4; i += kThreads) {
      const int t = i / (TV / 4), c = 4 * (i % (TV / 4));
      copy4(v_s + 4 * i, v + ((tb + t) * H + h) * dv + j0 + c, v,
            t < C ? min(4, dv - j0 - c) : 0, vec_v);
    }
    if constexpr (!kRecord) {
      for (int i = tid; i < CP * CP / 4; i += kThreads) {
        const int r = i / (CP / 4), c = 4 * (i % (CP / 4));
        copy16(w_s + r * LDW + c, rec + r * CP + c);
      }
    }
    if (tid < CP / 2) copy16(ea_s + 4 * tid, rec + CP * CP + 4 * tid);
    fetch(carry && !kRecord ? q : k, tb, 0, x_s);
    copy_wait();
    __syncthreads();  // also: the previous chunk's state update is done
    int stage = 0;

    if constexpr (kRecord) {
      float* sp = states + ((int64_t)bh * n_chunks + ci) * dk * dv;
      for (int i = tid; i < dk * TV; i += kThreads) {
        const int d = i / TV, j = j0 + i % TV;
        if (j < dv) sp[(int64_t)d * dv + j] = carry ? st_s[i] : 0.f;
      }
      if (ci == n_chunks - 1) break;
    } else {
    // y = eA * (q . S_prev) + W v
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    if (carry) {
      for (int n = 0; n < n_slabs; ++n) {
        // the next q slab, or k's first after the last
        if (n + 1 < n_slabs)
          fetch(q, tb, (n + 1) * kSlab2, x_s + (stage ^ 1) * kStage);
        else
          fetch(k, tb, 0, x_s + (stage ^ 1) * kStage);
        mma_rows<R, NRG>(acc, x_s + stage * kStage, kLd2,
                         st_s + n * kSlab2 * TV, TV, kSlab2, rg, CP - 1, jl);
        copy_wait();
        __syncthreads();  // the next slab landed; this one is consumed
        stage ^= 1;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float e = ea_s[min(rg + NRG * i, CP - 1)];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= e;
      }
    }
    mma_rows<R, NRG>(acc, w_s, LDW, v_s, TV, C4, rg, CP - 1, jl);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = rg + NRG * i;
      if (t < C) {
        T* yp = y + ((tb + t) * H + h) * dv + j0 + jl;
        if (sizeof(T) == 4 && vec_v && j0 + jl < dv) {
          *reinterpret_cast<float4*>(yp) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j0 + jl + c < dv) from_float(acc[i][c], yp + c);
        }
      }
    }
    __syncthreads();  // every read of v_s for y is done
    }
    for (int i = tid; i < CP * TV; i += kThreads) v_s[i] *= wk_s[i / TV];
    __syncthreads();

    // S = exp(clip(A_C)) S + k^T (wk * v), in slabs of 64 dk rows; after
    // the last chunk each slab's rows go straight out, their stores
    // overlapping the next slab's products
    const float decay = ea_s[C - 1];
    const int dl = rg * RU;
    const bool last = ci == n_chunks - 1;
    for (int n = 0; n < n_slabs; ++n) {
      if (n + 1 < n_slabs)
        fetch(k, tb, (n + 1) * kSlab2, x_s + (stage ^ 1) * kStage);
      float u[RU][4];
#pragma unroll
      for (int i = 0; i < RU; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[i][c] = 0.f;
      mma_cols<RU>(u, x_s + stage * kStage, kLd2, v_s, TV, C, dl, jl);
#pragma unroll
      for (int i = 0; i < RU; ++i) {
        float4* sp = reinterpret_cast<float4*>(st_s + (n * kSlab2 + dl + i) * TV + jl);
        float4 s = make_float4(u[i][0], u[i][1], u[i][2], u[i][3]);
        if (carry) {
          const float4 o = *sp;
          s.x = fmaf(decay, o.x, s.x);
          s.y = fmaf(decay, o.y, s.y);
          s.z = fmaf(decay, o.z, s.z);
          s.w = fmaf(decay, o.w, s.w);
        }
        const int d = n * kSlab2 + dl + i;
        if (!last) {
          *sp = s;
        } else if (d < dk) {
          float* op = state_out + ((int64_t)bh * dk + d) * dv + j0 + jl;
          if (vec_v && j0 + jl < dv) {
            *reinterpret_cast<float4*>(op) = s;
          } else {
            const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (j0 + jl + c < dv) op[c] = sv[c];
          }
        }
      }
      copy_wait();
      __syncthreads();  // the next slab landed; this one is consumed
      stage ^= 1;
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int CP, bool kBwd = false>
int launch_scores(const void* q, const void* k, const float* a,
                  const float* g, float* ws, int B, int S, int H, int dk,
                  int C, int vec, cudaStream_t stream) {
  const size_t smem = scores_smem(CP);
  int e = allow_smem(ssm_scores_kernel<T, CP, kBwd>, smem);
  if (e) return e;
  ssm_scores_kernel<T, CP, kBwd><<<B * H * (S / C), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), a, g, ws, S, H, dk,
      C, (vec & 1) != 0);
  return (int)cudaGetLastError();
}

template <typename T, int CP, int TV, bool kRecord = false>
int launch_scan(const void* v, const void* q, const void* k, const float* ws,
                const float* init, void* y, float* state, int B, int S, int H,
                int dk, int dv, int C, int vec, cudaStream_t stream,
                float* states = nullptr) {
  const size_t smem = scan_smem(CP, dk, TV);
  int e = allow_smem(ssm_scan_kernel<T, CP, TV, kRecord>, smem);
  if (e) return e;
  dim3 grid(B * H, (dv + TV - 1) / TV);
  ssm_scan_kernel<T, CP, TV, kRecord><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws, init, static_cast<T*>(y), state, states,
      S, H, dk, dv, C, (vec & 1) != 0, (vec & 2) != 0);
  return (int)cudaGetLastError();
}

template <typename T, int CP>
int launch_cp(const void* q, const void* k, const void* v, const float* a,
              const float* g, const float* init, void* y, float* state,
              float* ws, int B, int S, int H, int dk, int dv, int C, int tv,
              int vec, int scores_only, cudaStream_t stream) {
  int e = launch_scores<T, CP>(q, k, a, g, ws, B, S, H, dk, C, vec, stream);
  if (e || scores_only) return e;
  if (tv == 64)
    return launch_scan<T, CP, 64>(v, q, k, ws, init, y, state, B, S, H, dk,
                                  dv, C, vec, stream);
  if (tv == 32)
    return launch_scan<T, CP, 32>(v, q, k, ws, init, y, state, B, S, H, dk,
                                  dv, C, vec, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* a,
           const float* g, const float* init, void* y, float* state,
           float* ws, int B, int S, int H, int dk, int dv, int C, int tv,
           int vec, int scores_only, cudaStream_t s) {
  if (C <= 16)
    return launch_cp<T, 16>(q, k, v, a, g, init, y, state, ws, B, S, H, dk,
                            dv, C, tv, vec, scores_only, s);
  if (C <= 32)
    return launch_cp<T, 32>(q, k, v, a, g, init, y, state, ws, B, S, H, dk,
                            dv, C, tv, vec, scores_only, s);
  if (C <= 64)
    return launch_cp<T, 64>(q, k, v, a, g, init, y, state, ws, B, S, H, dk,
                            dv, C, tv, vec, scores_only, s);
  if (C <= 128)
    return launch_cp<T, 128>(q, k, v, a, g, init, y, state, ws, B, S, H, dk,
                             dv, C, tv, vec, scores_only, s);
  return (int)cudaErrorInvalidValue;
}

int padded_chunk(int C) {
  return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 0;
}

// ---------------------------------------------------------------- backward
//
// The exact gradient of the chunked form above (float32 only). Per chunk,
// with Z the backward record's scores, D[t][s] = dy_t . v_s, W = Z g_s,
// Dm = D exp(clip(A_t - A_s)) g_s (s <= t), dS the gradient of the state
// leaving the chunk and S_prev the state entering it:
//   dq_t  = sum_s Dm[t][s] k_s + eA_t S_prev dy_t
//   dk_s  = sum_t Dm[t][s] q_t + wk_s dS v_s            (wk = ec g)
//   dv_s  = sum_t W[t][s] dy_t + wk_s dS^T k_s
//   dg_s  = sum_t D[t][s] Z[t][s] + ec_s (k_s . dS v_s)
//   dA    from P = D W (row sums minus column sums), eA_t q_t . S_prev dy_t,
//         and the carry's exp(clip(A_C)) <dS, S_prev> and wk_s k_s . dS v_s,
//         each only where its exponent lies inside the clip
//   dS_prev = exp(clip(A_C)) dS + sum_t eA_t q_t dy_t^T
// One call runs five launches on the caller's stream: the forward's scores
// pass and its scan pass in kRecord mode (the state entering every chunk,
// into a workspace), the scores pass again in kBwd mode (its record over
// the forward's, which the scan has read), the backward pass, and the sums.
//
// The backward pass: grid (B*H, ceil(dv/TV)), one block per dv tile walks
// the chunks in reverse, carrying its (dk x TV) slice of dS in shared
// memory. dv and d(initial_state) of its tile it writes whole; dq, dk and
// the per-step dA, dg sum over dv, so each tile writes its part and a
// second pass adds the parts in tile order (no atomics: a run repeats bit
// for bit). q and k stream through 16-wide dk slabs. Every product is a
// block-wide loop over small register tiles read from shared memory
// (block_mm), float32 FMAs throughout.

constexpr int kSlabB = 16;          // dk rows a backward slab
constexpr int kLdB = kSlabB + 1;    // the slab's row stride

size_t bwd_smem(int cp, int dk, int tv) {
  const size_t lv = tv + 1, lx = cp + 1;
  return sizeof(float) *
         ((size_t)round_up(dk, kSlabB) * lv + 2 * (size_t)cp * lv +
          2 * (size_t)cp * lx + 3 * (size_t)cp * kLdB + kSlabB * lv +
          8 * (size_t)cp + kSlabB + 2);
}

__device__ __forceinline__ bool clip_live(float x) {
  return x >= -kClip && x <= kClip;
}

// out[m][n] = sum_{kk < K1} a1(m, kk) b1(kk, n), and a second product over
// K2 beside it, for m < M, n < N (multiples of RM, RN), each handed once to
// epi(m, n, first, second). A thread takes RM x RN tiles in turn: rows m0
// .. m0 + RM - 1 and columns nc + j * (N / RN), so that neighbouring
// threads read neighbouring columns of b and the same rows of a.
template <int RM, int RN, class FA1, class FB1, class FA2, class FB2,
          class FE>
__device__ __forceinline__ void block_mm2(int M, int N, int K1, FA1 a1,
                                          FB1 b1, int K2, FA2 a2, FB2 b2,
                                          FE epi) {
  const int ncol = N / RN;
  const int tiles = (M / RM) * ncol;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int m0 = RM * (tile / ncol), nc = tile % ncol;
    float c1[RM][RN], c2[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) c1[i][j] = c2[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K1; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a1(m0 + i, kk);
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = b1(kk, nc + j * ncol);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) c1[i][j] = fmaf(av[i], bv[j], c1[i][j]);
    }
#pragma unroll 4
    for (int kk = 0; kk < K2; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a2(m0 + i, kk);
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = b2(kk, nc + j * ncol);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) c2[i][j] = fmaf(av[i], bv[j], c2[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        epi(m0 + i, nc + j * ncol, c1[i][j], c2[i][j]);
  }
}

template <int RM, int RN, class FA, class FB, class FE>
__device__ __forceinline__ void block_mm(int M, int N, int K, FA a, FB b,
                                         FE epi) {
  block_mm2<RM, RN>(M, N, K, a, b, 0, a, b,
                    [&](int m, int n, float c, float) { epi(m, n, c); });
}

// Shared memory (floats; row strides padded by one against bank conflicts):
//   dS_s [dk16][TV+1]  the tile's dS (dk16 = dk rounded up to 16)
//   v_s, dy_s [CP][TV+1]
//   X_s [CP][CP+1]     Z, then W, then k dS (CP x TV)
//   Y_s [CP][CP+1]     D, then Dm
//   q_s, k_s, r_s [CP][17]  a dk slab of q and k; dA's inter-chunk terms
//   sp_s [16][TV+1]    a slab of S_prev
//   eA, ec, A, g, dAr (+ row sums of P), dAc (- column sums of P and the
//   carry's terms), dg, dAi (q_t . S_prev dy_t) [CP]; dsd [16]; two sums
template <int CP, int TV>
__global__ void __launch_bounds__(kThreads, 1)
ssm_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ dy, const float* __restrict__ dstate,
               const float* __restrict__ rec_ws,
               const float* __restrict__ states, float* __restrict__ dv_out,
               float* __restrict__ dq_part, float* __restrict__ dk_part,
               float* __restrict__ da_part, float* __restrict__ dg_part,
               float* __restrict__ dinit, int B, int S, int H, int dk,
               int dv, int C) {
  constexpr int LV = TV + 1, LX = CP + 1, KS = kSlabB, LK = kLdB;
  extern __shared__ float4 smem4[];
  const int dk_pad = round_up(dk, KS);
  float* dS_s = reinterpret_cast<float*>(smem4);
  float* v_s = dS_s + dk_pad * LV;
  float* dy_s = v_s + CP * LV;
  float* X_s = dy_s + CP * LV;
  float* Y_s = X_s + CP * LX;
  float* q_s = Y_s + CP * LX;
  float* k_s = q_s + CP * LK;
  float* r_s = k_s + CP * LK;
  float* sp_s = r_s + CP * LK;
  float* eA_s = sp_s + KS * LV;
  float* ec_s = eA_s + CP;
  float* A_s = ec_s + CP;
  float* g_s = A_s + CP;
  float* dAr = g_s + CP;
  float* dAc = dAr + CP;
  float* dgs = dAc + CP;
  float* dAi = dgs + CP;
  float* dsd = dAi + CP;
  float* sums = dsd + KS;  // <dS, S_prev>, sum of the carry's dA terms

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int64_t part = (int64_t)blockIdx.y * B * S * H;  // this tile's rows
  const int j0 = blockIdx.y * TV;
  const int tid = threadIdx.x;
  const int n_chunks = S / C;

  for (int i = tid; i < dk_pad * TV; i += kThreads) {
    const int d = i / TV, j = i % TV;
    dS_s[d * LV + j] = (dstate != nullptr && d < dk && j0 + j < dv)
                           ? dstate[((int64_t)bh * dk + d) * dv + j0 + j]
                           : 0.f;
  }

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int64_t tb = (int64_t)b * S + (int64_t)ci * C;  // step 0's row / H
    const float* rec =
        rec_ws + ((int64_t)bh * n_chunks + ci) * bwd_record_floats(CP);
    const float* sprev = states + ((int64_t)bh * n_chunks + ci) * dk * dv;
    for (int i = tid; i < CP * TV; i += kThreads) {
      const int t = i / TV, j = i % TV;
      const bool ok = t < C && j0 + j < dv;
      const int64_t o = ((tb + t) * H + h) * dv + j0 + j;
      v_s[t * LV + j] = ok ? v[o] : 0.f;
      dy_s[t * LV + j] = ok ? dy[o] : 0.f;
    }
    for (int i = tid; i < CP * CP; i += kThreads)
      X_s[(i / CP) * LX + i % CP] = rec[i];
    for (int t = tid; t < CP; t += kThreads) {
      eA_s[t] = rec[CP * CP + t];
      ec_s[t] = rec[CP * CP + CP + t];
      A_s[t] = rec[CP * CP + 2 * CP + t];
      g_s[t] = t < C ? g[(tb + t) * H + h] : 0.f;
      dAi[t] = 0.f;
    }
    if (tid == 0) sums[0] = 0.f;
    __syncthreads();

    // D = dy v^T over this tile's columns
    block_mm<4, 4>(
        CP, CP, TV, [&](int t, int j) { return dy_s[t * LV + j]; },
        [&](int j, int s) { return v_s[s * LV + j]; },
        [&](int t, int s, float x) { Y_s[t * LX + s] = x; });
    __syncthreads();

    // P = D Z g, where the clip passes A_t - A_s: its row sums (dAr) and
    // column sums (dAc); dg's intra-chunk part, the column sums of D Z
    for (int i = tid; i < 2 * CP; i += kThreads) {
      if (i < CP) {
        const int t = i;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) {
          const float p = Y_s[t * LX + s] * X_s[t * LX + s] * g_s[s];
          if (clip_live(A_s[t] - A_s[s])) acc += p;
        }
        dAr[t] = acc;
      } else {
        const int s = i - CP;
        float pc = 0.f, dz = 0.f;
        for (int t = s; t < CP; ++t) {
          const float z = Y_s[t * LX + s] * X_s[t * LX + s];
          dz += z;
          if (clip_live(A_s[t] - A_s[s])) pc += z * g_s[s];
        }
        dAc[s] = pc;
        dgs[s] = dz;
      }
    }
    __syncthreads();

    // W = Z g into X, Dm into Y
    for (int i = tid; i < CP * CP; i += kThreads) {
      const int t = i / CP, s = i % CP;
      X_s[t * LX + s] *= g_s[s];
      Y_s[t * LX + s] = (s <= t && t < C)
                            ? Y_s[t * LX + s] * exp_clip(A_s[t] - A_s[s]) *
                                  g_s[s]
                            : 0.f;
    }
    __syncthreads();

    // dv = W^T dy, its intra-chunk part; the carry's part is added below
    block_mm<4, 4>(
        CP, TV, CP, [&](int s, int t) { return X_s[t * LX + s]; },
        [&](int t, int j) { return dy_s[t * LV + j]; },
        [&](int s, int j, float x) {
          if (s < C && j0 + j < dv)
            dv_out[((tb + s) * H + h) * dv + j0 + j] = x;
        });
    __syncthreads();  // X is free: it takes k dS from here

    const float decay = eA_s[C - 1];  // exp(clip(A_C))
    for (int n = 0; n < dk_pad / KS; ++n) {
      const int d0 = n * KS;
      for (int i = tid; i < CP * KS; i += kThreads) {
        const int t = i / KS, d = i % KS;
        const bool ok = t < C && d0 + d < dk;
        const int64_t o = ((tb + t) * H + h) * dk + d0 + d;
        q_s[t * LK + d] = ok ? q[o] : 0.f;
        k_s[t * LK + d] = ok ? k[o] : 0.f;
      }
      for (int i = tid; i < KS * TV; i += kThreads) {
        const int d = i / TV, j = i % TV;
        sp_s[d * LV + j] = (d0 + d < dk && j0 + j < dv)
                               ? sprev[(int64_t)(d0 + d) * dv + j0 + j]
                               : 0.f;
      }
      __syncthreads();
      // k dS, summed over the slabs in X
      block_mm<4, 4>(
          CP, TV, KS, [&](int s, int d) { return k_s[s * LK + d]; },
          [&](int d, int j) { return dS_s[(d0 + d) * LV + j]; },
          [&](int s, int j, float x) {
            X_s[s * LX + j] = n ? X_s[s * LX + j] + x : x;
          });
      // dq = Dm k + eA (S_prev dy); r = q * (S_prev dy) for dA
      block_mm2<2, 4>(
          CP, KS, CP, [&](int t, int s) { return Y_s[t * LX + s]; },
          [&](int s, int d) { return k_s[s * LK + d]; }, TV,
          [&](int t, int j) { return dy_s[t * LV + j]; },
          [&](int j, int d) { return sp_s[d * LV + j]; },
          [&](int t, int d, float intra, float inter) {
            r_s[t * LK + d] = inter * q_s[t * LK + d];
            if (t < C && d0 + d < dk)
              dq_part[(part + (tb + t) * H + h) * dk + d0 + d] =
                  fmaf(eA_s[t], inter, intra);
          });
      // dk = Dm^T q + wk (dS v)
      block_mm2<2, 4>(
          CP, KS, CP, [&](int s, int t) { return Y_s[t * LX + s]; },
          [&](int t, int d) { return q_s[t * LK + d]; }, TV,
          [&](int s, int j) { return v_s[s * LV + j]; },
          [&](int j, int d) { return dS_s[(d0 + d) * LV + j]; },
          [&](int s, int d, float intra, float carry) {
            if (s < C && d0 + d < dk)
              dk_part[(part + (tb + s) * H + h) * dk + d0 + d] =
                  fmaf(ec_s[s] * g_s[s], carry, intra);
          });
      for (int d = tid; d < KS; d += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < TV; ++j)
          acc = fmaf(dS_s[(d0 + d) * LV + j], sp_s[d * LV + j], acc);
        dsd[d] = acc;
      }
      __syncthreads();
      // dS_prev = exp(clip(A_C)) dS + sum_t eA_t q_t dy_t^T, this slab
      block_mm<1, 2>(
          KS, TV, CP, [&](int d, int t) { return eA_s[t] * q_s[t * LK + d]; },
          [&](int t, int j) { return dy_s[t * LV + j]; },
          [&](int d, int j, float x) {
            float* p = dS_s + (d0 + d) * LV + j;
            *p = fmaf(decay, *p, x);
          });
      for (int t = tid; t < CP; t += kThreads) {
        float acc = dAi[t];
        for (int d = 0; d < KS; ++d) acc += r_s[t * LK + d];
        dAi[t] = acc;
      }
      if (tid == 0) {
        float acc = sums[0];
        for (int d = 0; d < KS; ++d) acc += dsd[d];
        sums[0] = acc;
      }
      __syncthreads();
    }

    // the carry's terms: dv += wk (k dS); r_s = k_s . dS v_s = (k dS)_s . v_s
    for (int s = tid; s < CP; s += kThreads) {
      float r = 0.f;
      for (int j = 0; j < TV; ++j) r = fmaf(X_s[s * LX + j], v_s[s * LV + j], r);
      const float wk = ec_s[s] * g_s[s];
      const float qs = clip_live(A_s[C - 1] - A_s[s]) ? wk * r : 0.f;
      dgs[s] += ec_s[s] * r;
      dAc[s] += qs;
      r_s[s * LK] = s < C ? qs : 0.f;
    }
    for (int i = tid; i < CP * TV; i += kThreads) {
      const int s = i / TV, j = i % TV;
      if (s < C && j0 + j < dv)
        dv_out[((tb + s) * H + h) * dv + j0 + j] +=
            ec_s[s] * g_s[s] * X_s[s * LX + j];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += r_s[s * LK];
      if (clip_live(A_s[C - 1])) acc += decay * sums[0];
      sums[1] = acc;
    }
    __syncthreads();
    for (int t = tid; t < C; t += kThreads) {
      float a = dAr[t] - dAc[t];
      if (clip_live(A_s[t])) a += eA_s[t] * dAi[t];
      if (t == C - 1) a += sums[1];
      da_part[part + (tb + t) * H + h] = a;
      dg_part[part + (tb + t) * H + h] = dgs[t];
    }
    __syncthreads();  // before the next chunk's loads
  }
  if (dinit != nullptr) {
    for (int i = tid; i < dk * TV; i += kThreads) {
      const int d = i / TV, j = i % TV;
      if (j0 + j < dv) dinit[((int64_t)bh * dk + d) * dv + j0 + j] = dS_s[d * LV + j];
    }
  }
}

// out = the sum of nt parts of n floats each, in part order
__global__ void ssm_bwd_sum_kernel(const float* __restrict__ parts,
                                   float* __restrict__ out, int64_t n,
                                   int nt) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = parts[i];
    for (int p = 1; p < nt; ++p) acc += parts[p * n + i];
    out[i] = acc;
  }
}

// d(log_decay) and d(gate), one (b, h, chunk) a thread: each step's parts
// summed in tile order, then dA summed from the chunk's end (A = cumsum(a))
__global__ void ssm_bwd_decay_kernel(const float* __restrict__ da_part,
                                     const float* __restrict__ dg_part,
                                     float* __restrict__ da,
                                     float* __restrict__ dg, int B, int S,
                                     int H, int C, int nt) {
  const int n_chunks = S / C;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * H * n_chunks) return;
  const int64_t rows = (int64_t)B * S * H;
  const int ci = (int)(i % n_chunks);
  const int64_t bh = i / n_chunks;
  const int64_t b = bh / H, h = bh % H;
  float run = 0.f;
  for (int t = C - 1; t >= 0; --t) {
    const int64_t r = (b * S + (int64_t)ci * C + t) * H + h;
    float a = da_part[r], gg = dg_part[r];
    for (int p = 1; p < nt; ++p) {
      a += da_part[p * rows + r];
      gg += dg_part[p * rows + r];
    }
    run += a;
    da[r] = run;
    dg[r] = gg;
  }
}

template <int CP, int TV>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* g, const float* dy, const float* dstate,
               const float* rec, const float* states, float* dv_out,
               float* dq_part, float* dk_part, float* da_part,
               float* dg_part, float* dinit, int B, int S, int H, int dk,
               int dv, int C, cudaStream_t stream) {
  const size_t smem = bwd_smem(CP, dk, TV);
  int e = allow_smem(ssm_bwd_kernel<CP, TV>, smem);
  if (e) return e;
  dim3 grid(B * H, (dv + TV - 1) / TV);
  ssm_bwd_kernel<CP, TV><<<grid, kThreads, smem, stream>>>(
      q, k, v, g, dy, dstate, rec, states, dv_out, dq_part, dk_part,
      da_part, dg_part, dinit, B, S, H, dk, dv, C);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_bwd_cp(const float* q, const float* k, const float* v,
                  const float* a, const float* g, const float* init,
                  const float* dy, const float* dstate, float* rec,
                  float* states, float* dv_out, float* dq_part,
                  float* dk_part, float* da_part, float* dg_part,
                  float* dinit, int B, int S, int H, int dk, int dv, int C,
                  int tv, int tb, int vec, cudaStream_t s) {
  int e = launch_scores<float, CP>(q, k, a, g, rec, B, S, H, dk, C, vec, s);
  if (e) return e;
  if (tv == 64)
    e = launch_scan<float, CP, 64, true>(v, q, k, rec, init, nullptr,
                                         nullptr, B, S, H, dk, dv, C, vec, s,
                                         states);
  else if (tv == 32)
    e = launch_scan<float, CP, 32, true>(v, q, k, rec, init, nullptr,
                                         nullptr, B, S, H, dk, dv, C, vec, s,
                                         states);
  else
    e = (int)cudaErrorInvalidValue;
  if (e) return e;
  e = launch_scores<float, CP, true>(q, k, a, g, rec, B, S, H, dk, C, vec, s);
  if (e) return e;
  if (tb == 64 && CP >= 64)
    return launch_bwd<CP, CP >= 64 ? 64 : 16>(
        q, k, v, g, dy, dstate, rec, states, dv_out, dq_part, dk_part,
        da_part, dg_part, dinit, B, S, H, dk, dv, C, s);
  if (tb == 32 && CP >= 32)
    return launch_bwd<CP, CP >= 32 ? 32 : 16>(
        q, k, v, g, dy, dstate, rec, states, dv_out, dq_part, dk_part,
        da_part, dg_part, dinit, B, S, H, dk, dv, C, s);
  if (tb == 16)
    return launch_bwd<CP, 16>(q, k, v, g, dy, dstate, rec, states, dv_out,
                              dq_part, dk_part, da_part, dg_part, dinit, B,
                              S, H, dk, dv, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k: (B, S, H, dk); v, y: (B, S, H, dv); a (log decay), g (gate):
// (B, S, H) float32; init (may be null) and state: (B, H, dk, dv) float32;
// ws: the workspace, B*H*(S/C) records of ssm_scan_plan_bytes(C, dk, tv, 2)
// floats. S is a multiple of C <= 128; tv (64 or 32) is the scan pass's dv
// tile. dtype (of q, k, v, y): 0 = float32, 1 = bfloat16. vec: bit 0 says
// q and k rows may be copied 16 bytes at a time (float32, dk % 4 == 0,
// 16-byte aligned), bit 1 the same of v, y and the state (dv % 4 == 0).
// scores_only launches the scores pass alone (its time is measured on its
// own); v, y and state may then be null. The caller checked shapes, contiguity and shared memory.
extern "C" int ssm_chunk_scan_launch(const void* q, const void* k,
                                     const void* v, const void* a,
                                     const void* g, const void* init,
                                     void* y, void* state, void* ws, int B,
                                     int S, int H, int dk, int dv, int C,
                                     int tv, int has_init, int dtype, int vec,
                                     int scores_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  const float* in = has_init ? static_cast<const float*>(init) : nullptr;
  float* st = static_cast<float*>(state);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(q, k, v, af, gf, in, y, st, w, B, S, H, dk, dv, C,
                         tv, vec, scores_only, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, af, gf, in, y, st, w, B, S, H, dk,
                                 dv, C, tv, vec, scores_only, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of each pass (which = 0: scores, 1: scan) and
// the floats of one chunk's workspace record, as the launcher computes
// them, for the wrapper's launch plan to be held against.
extern "C" long long ssm_scan_plan_bytes(int C, int dk, int tv, int which) {
  const int cp = padded_chunk(C);
  if (cp == 0) return -1;
  if (which == 0) return (long long)scores_smem(cp);
  if (which == 1) return (long long)scan_smem(cp, dk, tv);
  return (long long)record_floats(cp);
}

// The backward of ssm_chunk_scan_launch, float32 only. dy: y's gradient;
// dstate: the final state's gradient or null (zero); init and dinit: the
// initial state and its gradient, or null. Outputs dq, dk (B, S, H, dk), dv
// (B, S, H, dv), da, dg (B, S, H). Workspaces, from ssm_scan_bwd_plan_bytes:
// rec (B*H*(S/C) backward records), states (B*H*(S/C)*dk*dv floats), and
// the tiles' parts dq_part, dk_part (nt*B*S*H*dk) and da_part, dg_part
// (nt*B*S*H), nt = ceil(dv / tb). tv (64 or 32) is the forward scan's dv
// tile, tb (64, 32 or 16, at most the padded chunk) the backward's.
extern "C" int ssm_chunk_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* a,
    const void* g, const void* init, const void* dy, const void* dstate,
    void* dq, void* dk_out, void* dv_out, void* da, void* dg, void* dinit,
    void* rec, void* states, void* dq_part, void* dk_part, void* da_part,
    void* dg_part, int B, int S, int H, int dk, int dv, int C, int tv,
    int tb, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  const float* in = static_cast<const float*>(init);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(dstate);
  float* recf = static_cast<float*>(rec);
  float* stf = static_cast<float*>(states);
  float* dqp = static_cast<float*>(dq_part);
  float* dkp = static_cast<float*>(dk_part);
  float* dap = static_cast<float*>(da_part);
  float* dgp = static_cast<float*>(dg_part);
  float* dvo = static_cast<float*>(dv_out);
  float* dio = static_cast<float*>(dinit);
  int e;
  if (C <= 16)
    e = launch_bwd_cp<16>(qf, kf, vf, af, gf, in, dyf, dsf, recf, stf, dvo,
                          dqp, dkp, dap, dgp, dio, B, S, H, dk, dv, C, tv, tb,
                          vec, s);
  else if (C <= 32)
    e = launch_bwd_cp<32>(qf, kf, vf, af, gf, in, dyf, dsf, recf, stf, dvo,
                          dqp, dkp, dap, dgp, dio, B, S, H, dk, dv, C, tv, tb,
                          vec, s);
  else if (C <= 64)
    e = launch_bwd_cp<64>(qf, kf, vf, af, gf, in, dyf, dsf, recf, stf, dvo,
                          dqp, dkp, dap, dgp, dio, B, S, H, dk, dv, C, tv, tb,
                          vec, s);
  else if (C <= 128)
    e = launch_bwd_cp<128>(qf, kf, vf, af, gf, in, dyf, dsf, recf, stf, dvo,
                           dqp, dkp, dap, dgp, dio, B, S, H, dk, dv, C, tv,
                           tb, vec, s);
  else
    e = (int)cudaErrorInvalidValue;
  if (e) return e;
  const int nt = (dv + tb - 1) / tb;
  const int64_t n = (int64_t)B * S * H * dk;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ssm_bwd_sum_kernel<<<blocks, 256, 0, s>>>(dqp, static_cast<float*>(dq), n,
                                            nt);
  ssm_bwd_sum_kernel<<<blocks, 256, 0, s>>>(dkp, static_cast<float*>(dk_out),
                                            n, nt);
  const int64_t chunks = (int64_t)B * H * (S / C);
  ssm_bwd_decay_kernel<<<(int)((chunks + 127) / 128), 128, 0, s>>>(
      dap, dgp, static_cast<float*>(da), static_cast<float*>(dg), B, S, H, C,
      nt);
  return (int)cudaGetLastError();
}

// The backward's sizes, as its launcher computes them: which = 0 the
// backward pass's shared memory a block at dv tile tb, 1 the floats of one
// chunk's backward record.
extern "C" long long ssm_scan_bwd_plan_bytes(int C, int dk, int tb,
                                             int which) {
  const int cp = padded_chunk(C);
  if (cp == 0) return -1;
  if (which == 0) return (long long)bwd_smem(cp, dk, tb);
  return (long long)bwd_record_floats(cp);
}
