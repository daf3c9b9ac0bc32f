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
// so four blocks share an SM.
template <typename T, int CP>
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

  float* rec = ws + (int64_t)blockIdx.x * record_floats(CP);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int l = 0; l < R; ++l) {
      const int s = tx + 16 * l;
      float w = 0.f;
      if (s <= t && t < C) w = acc[i][l] * exp_clip(A_s[t] - A_s[s]) * g_s[s];
      rec[t * CP + s] = w;
    }
  }
  const float a_tot = A_s[C - 1];
  for (int t = tid; t < CP; t += kThreads) {
    rec[CP * CP + t] = t < C ? exp_clip(A_s[t]) : 0.f;
    rec[CP * CP + CP + t] = t < C ? exp_clip(a_tot - A_s[t]) * g_s[t] : 0.f;
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
// with it no instantiation spills)
template <typename T, int CP, int TV>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ws,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int dk, int dv,
                int C, bool vec_qk, bool vec_v) {
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
    for (int i = tid; i < CP * CP / 4; i += kThreads) {
      const int r = i / (CP / 4), c = 4 * (i % (CP / 4));
      copy16(w_s + r * LDW + c, rec + r * CP + c);
    }
    if (tid < CP / 2) copy16(ea_s + 4 * tid, rec + CP * CP + 4 * tid);
    fetch(carry ? q : k, tb, 0, x_s);
    copy_wait();
    __syncthreads();  // also: the previous chunk's state update is done
    int stage = 0;

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

template <typename T, int CP>
int launch_scores(const void* q, const void* k, const float* a,
                  const float* g, float* ws, int B, int S, int H, int dk,
                  int C, int vec, cudaStream_t stream) {
  const size_t smem = scores_smem(CP);
  int e = allow_smem(ssm_scores_kernel<T, CP>, smem);
  if (e) return e;
  ssm_scores_kernel<T, CP><<<B * H * (S / C), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), a, g, ws, S, H, dk,
      C, (vec & 1) != 0);
  return (int)cudaGetLastError();
}

template <typename T, int CP, int TV>
int launch_scan(const void* v, const void* q, const void* k, const float* ws,
                const float* init, void* y, float* state, int B, int S, int H,
                int dk, int dv, int C, int vec, cudaStream_t stream) {
  const size_t smem = scan_smem(CP, dk, TV);
  int e = allow_smem(ssm_scan_kernel<T, CP, TV>, smem);
  if (e) return e;
  dim3 grid(B * H, (dv + TV - 1) / TV);
  ssm_scan_kernel<T, CP, TV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws, init, static_cast<T*>(y), state, S, H,
      dk, dv, C, (vec & 1) != 0, (vec & 2) != 0);
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
// with Z[t][s] = (s <= t) (q_t . k_s) exp(clip(A_t - A_s)), W = Z g_s (the
// forward's scores, rounded as the forward rounds them), D[t][s] = dy_t .
// v_s, Dm = D exp(clip(A_t - A_s)) g_s (s <= t), wk_s = ec_s g_s with ec_s =
// exp(clip(A_C - A_s)), dS the gradient of the state leaving the chunk and
// S_prev the state entering it:
//   dq_t  = sum_s Dm[t][s] k_s + eA_t S_prev dy_t
//   dk_s  = sum_t Dm[t][s] q_t + wk_s dS v_s
//   dv_s  = sum_t W[t][s] dy_t + wk_s dS^T k_s
//   dg_s  = sum_t D[t][s] Z[t][s] + ec_s (k_s . dS v_s)
//   dA    from P = D W (row sums minus column sums), eA_t q_t . S_prev dy_t,
//         and the carry's exp(clip(A_C)) <dS, S_prev> and wk_s k_s . dS v_s,
//         each only where its exponent lies inside the clip
//   S_next  = exp(clip(A_C)) S_prev + U,  U = sum_s wk_s k_s v_s^T
//   dS_prev = exp(clip(A_C)) dS + V,      V = sum_t eA_t q_t dy_t^T
// Bound by float32 operations: per (b, h) and chunk the lower triangles of
// q k^T and dy v^T and of the three C x C products of dq, dk and dv, and
// five (dk x dv) state products (~51.5 GFLOP at zamba2's train shape).
//
// Design: every pass but the recurrences runs over the chunks in parallel,
// and only the recurrences walk them in order, element by element. Each C x
// C product is formed once a chunk; each output element is written by one
// block with its whole sum inside it, so a call uses no atomics and repeats
// bit for bit. ssm_chunk_scan_bwd_launch runs six launches on the caller's
// stream:
// 1. Record pass, a block a (b, h, chunk): A = cumsum(a) as the scores pass
//    forms it, D over dv and Z over dk in 32-wide slabs (the scores pass's
//    register tiles, only the 16 x 16 blocks on or below the diagonal),
//    then W, Dm, P's row sums minus its column sums, D Z's column sums,
//    eA, wk, ec and A into the chunk's record (bwd_record_floats).
// 2. State products, a block a (b, h, chunk, 64 x 64 tile): U^T (into the
//    states workspace, [dv][dk] a chunk) and V (into the gradients
//    workspace, [dk][dv]), each thread 4 x 4 of each (mma_cols). U is not
//    needed for the last chunk, nor V for the first without an initial
//    state.
// 3. Recurrences, a thread four elements of a (b, h) state: S over the
//    chunks in order from the initial state or zero, dS in reverse from the
//    final state's gradient or zero, each written over its U or V; then
//    d(initial_state).
// 4. dq or dk, a block a (b, h, chunk, 64-wide dk tile, which of the two),
//    its C rows in registers: first eA (dy S_prev^T) or wk (v dS^T) over
//    dv in 16-wide slabs (then each row's dot with q or k, the dA and dg
//    terms, as this tile's parts, and its part of <dS, S_prev>), then Dm k
//    or Dm^T q over the chunk in 16-wide slabs, skipping the row groups a
//    slab's triangle leaves at zero.
// 5. dv, a block a (b, h, chunk, 64-wide dv tile): wk (k dS) over dk, then
//    W^T dy over the chunk, likewise.
// 6. The per-step scalars, a warp a (b, h, chunk): the dk tiles' parts
//    summed in tile order, the carry's terms, then dA summed from the
//    chunk's end into d(log_decay) (A = cumsum(a)), and d(gate).
// Every product of passes 4 and 5 is one register-tiled form (mma_tri:
// each thread R rows strided by 16 x 4 columns, float4 reads from shared
// memory); the operands that form reads transposed (dS^T in pass 4, Dm^T
// and W^T in passes 4 and 5) are loaded into registers a slab ahead and
// stored transposed, the others come by cp.async, two stages in flight.

constexpr int kSlabG = 16;          // the contraction slab of passes 2, 4, 5
constexpr int kLdG = kSlabG + 4;    // row stride of a [rows][16] slab
constexpr int kTile = 64;           // dk, dv tile of passes 2, 4, 5
constexpr int kLdT = kTile + 4;     // row stride of a [16][64] slab

// one chunk's backward record: W [CP][CP], Dm [CP][CP], then six vectors
// of CP: eA, wk, ec, A, dAi (P's row sums minus its column sums: the
// intra-chunk dA), dgi (D Z's column sums: the intra-chunk d(gate))
__host__ __device__ constexpr int64_t bwd_record_floats(int cp) {
  return 2 * (int64_t)cp * cp + 6 * cp;
}
enum { kVecEA = 0, kVecWK, kVecEC, kVecA, kVecDAI, kVecDGI };

size_t bwd_record_smem(int cp) {
  const size_t r = cp / 16;
  return sizeof(float) *
         ((size_t)2 * 2 * cp * kLd1 + r * (r + 1) / 2 * kThreads + 3 * cp);
}
size_t bwd_state_smem(int cp) {
  return sizeof(float) * ((size_t)2 * 4 * kSlabG * kLdT + 2 * cp);
}
size_t bwd_qk_smem(int cp) {
  return sizeof(float) *
         ((size_t)2 * (cp * kLdG + 2 * kSlabG * kLdT) + cp + 8);
}
size_t bwd_v_smem(int cp) {
  return sizeof(float) * ((size_t)2 * (cp * kLdG + kSlabG * kLdT) + cp);
}

__device__ __forceinline__ bool clip_live(float x) {
  return x >= -kClip && x <= kClip;
}

// acc[i][c] += sum_{kk < 16} A[rg + 16 i][kk] B[kk][j + c] for the row
// groups ilo <= i <= ihi: outside them a slab's triangle gives zero. A
// [rows][kLdG] and B [16][kLdT] in shared memory, read as float4.
template <int R>
__device__ __forceinline__ void mma_tri(float (&acc)[R][4],
                                        const float* __restrict__ A,
                                        const float* __restrict__ Bm, int rg,
                                        int j, int ilo, int ihi) {
#pragma unroll
  for (int kk = 0; kk < kSlabG; kk += 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(Bm + (kk + 0) * kLdT + j);
    const float4 b1 = *reinterpret_cast<const float4*>(Bm + (kk + 1) * kLdT + j);
    const float4 b2 = *reinterpret_cast<const float4*>(Bm + (kk + 2) * kLdT + j);
    const float4 b3 = *reinterpret_cast<const float4*>(Bm + (kk + 3) * kLdT + j);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < ilo || i > ihi) continue;
      const float4 av =
          *reinterpret_cast<const float4*>(A + (rg + 16 * i) * kLdG + kk);
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

// 4 consecutive floats of global memory (n_valid of them, zero past it):
// one float4 load where the caller knows them aligned (vec), else scalars
__device__ __forceinline__ float4 load4(const float* src, int n_valid,
                                        bool vec) {
  if (vec && n_valid >= 4) return *reinterpret_cast<const float4*>(src);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n_valid ? src[e] : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(float* dst, float4 x, int n_valid,
                                       bool vec) {
  if (vec && n_valid >= 4) {
    *reinterpret_cast<float4*>(dst) = x;
    return;
  }
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n_valid) dst[e] = v[e];
}

// Pass 1's products: one 32-wide slab (columns d0 ..) of the chunk's rows
// of x and y, into a stage; then acc[i][l] (l <= i: the 16 x 16 blocks on
// or below the diagonal) += row ty + 16 i of x . row tx + 16 l of y over
// K, slab 0 already in flight, in the scores pass's slabs, tiles and order
template <int CP>
__device__ __forceinline__ void tri_fetch(const float* x, const float* y,
                                          int K, bool vec, int64_t tb, int H,
                                          int h, int C, int d0, float* st) {
  for (int i = threadIdx.x; i < CP * kSlab1 / 4; i += kThreads) {
    const int t = i / (kSlab1 / 4), dd = 4 * (i % (kSlab1 / 4));
    const int nv = t < C ? min(4, K - d0 - dd) : 0;
    const int64_t o = ((tb + t) * H + h) * K + d0 + dd;
    copy4(st + t * kLd1 + dd, x + o, x, nv, vec);
    copy4(st + CP * kLd1 + t * kLd1 + dd, y + o, y, nv, vec);
  }
  copy_commit();
}
template <int CP>
__device__ __forceinline__ void tri_product(float (&acc)[CP / 16][CP / 16],
                                            const float* x, const float* y,
                                            int K, bool vec, int64_t tb,
                                            int H, int h, int C,
                                            float* stages) {
  constexpr int R = CP / 16;
  constexpr int kStage = 2 * CP * kLd1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_slabs = (K + kSlab1 - 1) / kSlab1;
  for (int n = 0; n < n_slabs; ++n) {
    copy_wait();
    __syncthreads();  // slab n landed; slab n - 1 is consumed
    if (n + 1 < n_slabs)
      tri_fetch<CP>(x, y, K, vec, tb, H, h, C, (n + 1) * kSlab1,
                    stages + ((n + 1) & 1) * kStage);
    const float* x_s = stages + (n & 1) * kStage;
    const float* y_s = x_s + CP * kLd1;
#pragma unroll 1
    for (int dd = 0; dd < kSlab1; dd += 4) {
      float4 yr[R];
#pragma unroll
      for (int l = 0; l < R; ++l)
        yr[l] = *reinterpret_cast<const float4*>(y_s + (tx + 16 * l) * kLd1 + dd);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 xr =
            *reinterpret_cast<const float4*>(x_s + (ty + 16 * i) * kLd1 + dd);
#pragma unroll
        for (int l = 0; l <= i; ++l) {
          float s = acc[i][l];
          s = fmaf(xr.x, yr[l].x, s);
          s = fmaf(xr.y, yr[l].y, s);
          s = fmaf(xr.z, yr[l].z, s);
          s = fmaf(xr.w, yr[l].w, s);
          acc[i][l] = s;
        }
      }
    }
  }
  __syncthreads();  // every stage consumed
}

// Pass 1. Shared memory (floats): two stages of x_s, y_s [CP][kLd1] (a
// slab of dy and v, then of q and k), each thread's D kept while Z is
// formed (R (R + 1) / 2 floats a thread, thread-major), A_s, g_s, rows_s
// [CP]; after the products the stages hold the warps' column sums
// [8][2][CP].
template <int CP>
__global__ void __launch_bounds__(kThreads, CP <= 64 ? 4 : 2)
ssm_bwd_record_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dy,
                      const float* __restrict__ a, const float* __restrict__ g,
                      float* __restrict__ rec_ws, int S, int H, int dk, int dv,
                      int C, int vec) {
  constexpr int R = CP / 16;
  constexpr int kStage = 2 * CP * kLd1;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* d_s = stages + 2 * kStage;
  float* A_s = d_s + R * (R + 1) / 2 * kThreads;
  float* g_s = A_s + CP;
  float* rows_s = g_s + CP;

  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const int64_t tb = (int64_t)b * S + (int64_t)ci * C;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  tri_fetch<CP>(dy, v, dv, (vec & 2) != 0, tb, H, h, C, 0, stages);
  // A = cumsum(a) and g, as the scores pass forms them (lane 0, left to
  // right), while dy and v's first slab is in flight
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

  // D first, kept in shared memory (each thread its own), then Z
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int l = 0; l < R; ++l) acc[i][l] = 0.f;
  tri_product<CP>(acc, dy, v, dv, (vec & 2) != 0, tb, H, h, C, stages);
  tri_fetch<CP>(q, k, dk, (vec & 1) != 0, tb, H, h, C, 0, stages);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int l = 0; l <= i; ++l) {
      d_s[(i * (i + 1) / 2 + l) * kThreads + tid] = acc[i][l];
      acc[i][l] = 0.f;
    }
  tri_product<CP>(acc, q, k, dk, (vec & 1) != 0, tb, H, h, C, stages);

  float* rec = rec_ws + (int64_t)blockIdx.x * bwd_record_floats(CP);
  float* vecs = rec + 2 * CP * CP;
  float rowp[R], colp[R], coldz[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rowp[i] = colp[i] = coldz[i] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int l = 0; l < R; ++l) {
      const int s = tx + 16 * l;
      float w = 0.f, dm = 0.f;
      if (l <= i && s <= t && t < C) {
        const float x = A_s[t] - A_s[s];
        const float e = exp_clip(x);
        const float z = acc[i][l] * e;
        const float d = d_s[(i * (i + 1) / 2 + l) * kThreads + tid];
        w = z * g_s[s];
        dm = d * e * g_s[s];
        coldz[l] += d * z;
        if (clip_live(x)) {
          const float p = d * w;
          rowp[i] += p;
          colp[l] += p;
        }
      }
      rec[t * CP + s] = w;
      rec[CP * CP + t * CP + s] = dm;
    }
  }
  // row sums over the 16 lanes of a row (tx), column sums over the two rows
  // of a warp and then the 8 warps, each in a fixed order
  const int warp = tid >> 5;
  float* red = stages;  // [8][2][CP]
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float r = rowp[i];
    r += __shfl_down_sync(0xffffffffu, r, 8, 16);
    r += __shfl_down_sync(0xffffffffu, r, 4, 16);
    r += __shfl_down_sync(0xffffffffu, r, 2, 16);
    r += __shfl_down_sync(0xffffffffu, r, 1, 16);
    if (tx == 0) rows_s[ty + 16 * i] = r;
  }
#pragma unroll
  for (int l = 0; l < R; ++l) {
    const float c0 = colp[l] + __shfl_down_sync(0xffffffffu, colp[l], 16);
    const float c1 = coldz[l] + __shfl_down_sync(0xffffffffu, coldz[l], 16);
    if ((tid & 31) < 16) {
      red[(warp * 2) * CP + tx + 16 * l] = c0;
      red[(warp * 2 + 1) * CP + tx + 16 * l] = c1;
    }
  }
  __syncthreads();
  const float a_tot = A_s[C - 1];
  for (int t = tid; t < CP; t += kThreads) {
    float cp_ = 0.f, cz = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kThreads / 32; ++w8) {
      cp_ += red[(w8 * 2) * CP + t];
      cz += red[(w8 * 2 + 1) * CP + t];
    }
    const bool in = t < C;
    const float ec = in ? exp_clip(a_tot - A_s[t]) : 0.f;
    vecs[kVecEA * CP + t] = in ? exp_clip(A_s[t]) : 0.f;
    vecs[kVecWK * CP + t] = ec * g_s[t];
    vecs[kVecEC * CP + t] = ec;
    vecs[kVecA * CP + t] = A_s[t];
    vecs[kVecDAI * CP + t] = in ? rows_s[t] - cp_ : 0.f;
    vecs[kVecDGI * CP + t] = in ? cz : 0.f;
  }
}

// Pass 2. Shared memory (floats): two stages of k_s, q_s, v_s, dy_s
// [16][kLdT] (k scaled by wk and q by eA once landed), wk_s, eA_s [CP].
// U^T's rows are this tile's dv columns, V's its dk rows; a thread owns 4
// consecutive rows x 4 consecutive columns of each.
template <int CP>
__global__ void __launch_bounds__(kThreads, 3)
ssm_bwd_state_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dy,
                     const float* __restrict__ rec_ws, float* __restrict__ sp,
                     float* __restrict__ ds, int S, int H, int dk, int dv,
                     int C, int has_init, int vec) {
  constexpr int kArr = kSlabG * kLdT;
  constexpr int kStage = 4 * kArr;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* wk_s = stages + 2 * kStage;
  float* eA_s = wk_s + CP;

  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const bool doU = ci + 1 < n_chunks;
  const bool doV = ci > 0 || has_init;
  if (!doU && !doV) return;
  const int b = bh / H, h = bh - b * H;
  const int ntd = (dk + kTile - 1) / kTile;
  const int d0 = kTile * (blockIdx.y % ntd), j0 = kTile * (blockIdx.y / ntd);
  const int64_t tb = (int64_t)b * S + (int64_t)ci * C;
  const int tid = threadIdx.x;
  const int rl = 4 * (tid >> 4), cl = 4 * (tid & 15);
  const bool vqk = (vec & 1) != 0, vv = (vec & 2) != 0;
  const float* rec = rec_ws + (int64_t)blockIdx.x * bwd_record_floats(CP);
  for (int t = tid; t < CP; t += kThreads) {
    wk_s[t] = rec[2 * CP * CP + kVecWK * CP + t];
    eA_s[t] = rec[2 * CP * CP + kVecEA * CP + t];
  }

  auto fetch = [&](int s0, float* st) {
    for (int i = tid; i < kSlabG * kTile / 4; i += kThreads) {
      const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
      const int64_t row = (tb + s0 + r) * H + h;
      const bool in = s0 + r < C;
      const int nd = in ? min(4, dk - d0 - c) : 0;
      const int nj = in ? min(4, dv - j0 - c) : 0;
      copy4(st + r * kLdT + c, k + row * dk + d0 + c, k, nd, vqk);
      copy4(st + kArr + r * kLdT + c, q + row * dk + d0 + c, q, nd, vqk);
      copy4(st + 2 * kArr + r * kLdT + c, v + row * dv + j0 + c, v, nj, vv);
      copy4(st + 3 * kArr + r * kLdT + c, dy + row * dv + j0 + c, dy, nj, vv);
    }
    copy_commit();
  };
  float uacc[4][4], vacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) uacc[i][c] = vacc[i][c] = 0.f;
  const int n_slabs = (C + kSlabG - 1) / kSlabG;
  fetch(0, stages);
  for (int n = 0; n < n_slabs; ++n) {
    copy_wait();
    __syncthreads();  // slab n landed; slab n - 1 consumed
    if (n + 1 < n_slabs) fetch((n + 1) * kSlabG, stages + ((n + 1) & 1) * kStage);
    float* st = stages + (n & 1) * kStage;
    for (int i = tid; i < kSlabG * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      st[r * kLdT + c] *= wk_s[n * kSlabG + r];
      st[kArr + r * kLdT + c] *= eA_s[n * kSlabG + r];
    }
    __syncthreads();
    if (doU) mma_cols<4>(uacc, st + 2 * kArr, kLdT, st, kLdT, kSlabG, rl, cl);
    if (doV) mma_cols<4>(vacc, st + kArr, kLdT, st + 3 * kArr, kLdT, kSlabG, rl, cl);
  }
  const int64_t chunk = (int64_t)blockIdx.x * dk * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (doU && j0 + rl + i < dv)
      store4(sp + chunk + (int64_t)(j0 + rl + i) * dk + d0 + cl,
             make_float4(uacc[i][0], uacc[i][1], uacc[i][2], uacc[i][3]),
             dk - d0 - cl, dk % 4 == 0);
    if (doV && d0 + rl + i < dk)
      store4(ds + chunk + (int64_t)(d0 + rl + i) * dv + j0 + cl,
             make_float4(vacc[i][0], vacc[i][1], vacc[i][2], vacc[i][3]),
             dv - j0 - cl, dv % 4 == 0);
  }
}

// Pass 3: four consecutive elements of a (b, h) state a thread (p the
// first's index in a chunk's dk * dv floats); blockIdx.y 0 walks S over sp
// ([dv][dk] a chunk), 1 walks dS over ds ([dk][dv]). Each chunk's U or V
// is read before the value entering or leaving the chunk is written over
// it; 8 chunks' loads are in flight at a time.
__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}
__global__ void ssm_bwd_carry_kernel(const float* __restrict__ rec_ws,
                                     const float* __restrict__ init,
                                     const float* __restrict__ dstate,
                                     float* __restrict__ sp,
                                     float* __restrict__ ds,
                                     float* __restrict__ dinit, int64_t BH,
                                     int n, int dk, int dv, int CP, int C) {
  constexpr int kAhead = 8;
  const int64_t per = (int64_t)dk * dv, quads = (per + 3) / 4;
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= BH * quads) return;
  const int64_t bh = idx / quads, p = 4 * (idx - bh * quads);
  const int nv = (int)(per - p < 4 ? per - p : 4);
  const bool vec = per % 4 == 0;  // every chunk's quads 16-byte aligned
  const int64_t recf = bwd_record_floats(CP);
  const float* decay = rec_ws + bh * n * recf + 2 * (int64_t)CP * CP +
                       kVecEA * CP + C - 1;  // chunk ci's at decay[ci * recf]
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.y == 0) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (init != nullptr)
      for (int e = 0; e < nv; ++e)
        x[e] = init[bh * per + ((p + e) % dk) * dv + (p + e) / dk];
    float4 st = make_float4(x[0], x[1], x[2], x[3]);
    float* sc = sp + bh * n * per + p;
    for (int c0 = 0; c0 < n; c0 += kAhead) {
      float4 u[kAhead];
      float f[kAhead];
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int ci = c0 + c;
        u[c] = ci + 1 < n ? load4(sc + ci * per, nv, vec) : zero;
        f[c] = ci + 1 < n ? decay[ci * recf] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int ci = c0 + c;
        if (ci < n) {
          store4(sc + ci * per, st, nv, vec);
          st = fma4(f[c], st, u[c]);
        }
      }
    }
  } else {
    float4 d = dstate != nullptr ? load4(dstate + bh * per + p, nv, vec)
                                 : zero;
    float* sc = ds + bh * n * per + p;
    const int lo = dinit != nullptr ? 0 : 1;  // V of chunk 0 only feeds dinit
    for (int c0 = n - 1; c0 >= 0; c0 -= kAhead) {
      float4 w[kAhead];
      float f[kAhead];
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int ci = c0 - c;
        w[c] = ci >= lo ? load4(sc + ci * per, nv, vec) : zero;
        f[c] = ci >= lo ? decay[ci * recf] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        const int ci = c0 - c;
        if (ci >= 0) {
          store4(sc + ci * per, d, nv, vec);
          d = fma4(f[c], d, w[c]);
        }
      }
    }
    if (dinit != nullptr) store4(dinit + bh * per + p, d, nv, vec);
  }
}

// Pass 4, a block a (b, h, chunk, 64-wide dk tile, role): role 0 writes
// dq, role 1 dk. Shared memory (floats): two stages of X_s [CP][kLdG] and
// P_s, Q_s [16][kLdT]. Over dv, role 0 takes dy into X_s and S_prev^T into
// P_s; role 1 v into X_s, S_prev^T into P_s (for <dS, S_prev>) and dS^T
// into Q_s, stored transposed from registers. Over the chunk, role 0 takes
// a column slab of Dm into X_s and k rows into P_s; role 1 a row slab of
// Dm, stored transposed into X_s, and q rows into P_s. Then eA or wk [CP]
// and red [8]. A thread owns rows rg + 16 i (i < CP / 16) and 4 columns.
template <int CP, int ROLE>
__device__ __forceinline__ void bwd_qk_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dy,
    const float* __restrict__ rec_ws, const float* __restrict__ sp,
    const float* __restrict__ ds, float* __restrict__ out,
    float* __restrict__ part, float* __restrict__ dsd_part, int B, int S,
    int H, int dk, int dv, int C, bool live, int vec) {
  constexpr int R = CP / 16;
  constexpr int kLong = CP * kLdG, kShort = kSlabG * kLdT;
  constexpr int kStage = kLong + 2 * kShort;
  constexpr int NQ = (kSlabG * CP / 4 + kThreads - 1) / kThreads;  // Dm^T
  constexpr int NA = kSlabG * kTile / 4 / kThreads;  // dS^T float4s a thread
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* scale_s = stages + 2 * kStage;  // eA (role 0) or wk (role 1)
  float* red = scale_s + CP;

  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const int b = bh / H, h = bh - b * H;
  const int d0 = kTile * blockIdx.y;
  const int64_t tb = (int64_t)b * S + (int64_t)ci * C;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, jl = 4 * (tid & 15);
  const bool vqk = (vec & 1) != 0, vv = (vec & 2) != 0;
  // live: role 0's S_prev, role 1's dS is not zero
  const int nA = live ? (dv + kSlabG - 1) / kSlabG : 0;
  const int nB = (C + kSlabG - 1) / kSlabG;
  const int64_t chunk = (int64_t)blockIdx.x * dk * dv;
  const float* rec = rec_ws + (int64_t)blockIdx.x * bwd_record_floats(CP);
  for (int t = tid; t < CP; t += kThreads)
    scale_s[t] = rec[2 * CP * CP + (ROLE ? kVecWK : kVecEA) * CP + t];

  // slab m: m < nA the dv columns 16 m .., else the chunk's steps
  // 16 (m - nA) ..; fetch() starts its cp.async copies, gather() loads
  // role 1's transposed operand into registers, scatter() stores it
  auto fetch = [&](int m, float* st) {
    if (m < nA) {
      const int j0 = kSlabG * m;
      const float* x = ROLE ? v : dy;
      for (int i = tid; i < CP * kSlabG / 4; i += kThreads) {
        const int t = i / (kSlabG / 4), c = 4 * (i % (kSlabG / 4));
        copy4(st + t * kLdG + c, x + ((tb + t) * H + h) * dv + j0 + c, x,
              t < C ? min(4, dv - j0 - c) : 0, vv);
      }
      for (int i = tid; i < kSlabG * kTile / 4; i += kThreads) {
        const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
        copy4(st + kLong + r * kLdT + c,
              sp + chunk + (int64_t)(j0 + r) * dk + d0 + c, sp,
              j0 + r < dv ? min(4, dk - d0 - c) : 0, dk % 4 == 0);
      }
    } else {
      const int s0 = kSlabG * (m - nA);
      if (ROLE == 0) {
        for (int i = tid; i < CP * kSlabG / 4; i += kThreads) {
          const int t = i / (kSlabG / 4), c = 4 * (i % (kSlabG / 4));
          copy16(st + t * kLdG + c, rec + CP * CP + t * CP + s0 + c);
        }
      }
      const float* x = ROLE ? q : k;
      for (int i = tid; i < kSlabG * kTile / 4; i += kThreads) {
        const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
        copy4(st + kLong + r * kLdT + c,
              x + ((tb + s0 + r) * H + h) * dk + d0 + c, x,
              s0 + r < C ? min(4, dk - d0 - c) : 0, vqk);
      }
    }
    copy_commit();
  };
  float4 reg[NQ > NA ? NQ : NA];
  auto gather = [&](int m) {
    if (ROLE == 0) return;
    if (m < nA) {  // dS rows d0 + (i % 64), columns kSlabG m + 4 (i / 64) ..
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const int i = tid + kThreads * u;
        const int d = i % kTile, j = kSlabG * m + 4 * (i / kTile);
        reg[u] = d0 + d < dk
                     ? load4(ds + chunk + (int64_t)(d0 + d) * dv + j,
                             min(4, dv - j), dv % 4 == 0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {  // Dm rows 16 (m - nA) + (i % 16), columns 4 (i / 16) ..
      const int t0 = kSlabG * (m - nA);
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const int i = tid + kThreads * u;
        if (i < kSlabG * CP / 4)
          reg[u] = *reinterpret_cast<const float4*>(
              rec + CP * CP + (t0 + i % kSlabG) * CP + 4 * (i / kSlabG));
      }
    }
  };
  auto scatter = [&](int m, float* st) {
    if (ROLE == 0) return;
    if (m < nA) {
      float* Q_s = st + kLong + kShort;
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const int i = tid + kThreads * u;
        const int d = i % kTile, c = 4 * (i / kTile);
        Q_s[(c + 0) * kLdT + d] = reg[u].x;
        Q_s[(c + 1) * kLdT + d] = reg[u].y;
        Q_s[(c + 2) * kLdT + d] = reg[u].z;
        Q_s[(c + 3) * kLdT + d] = reg[u].w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const int i = tid + kThreads * u;
        if (i < kSlabG * CP / 4) {
          const int t = i % kSlabG, s = 4 * (i / kSlabG);
          st[(s + 0) * kLdG + t] = reg[u].x;
          st[(s + 1) * kLdG + t] = reg[u].y;
          st[(s + 2) * kLdG + t] = reg[u].z;
          st[(s + 3) * kLdG + t] = reg[u].w;
        }
      }
    }
  };

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  float dsd = 0.f;
  const int M = nA + nB;
  fetch(0, stages);
  gather(0);
  scatter(0, stages);
  for (int m = 0; m < M; ++m) {
    float* st = stages + (m & 1) * kStage;
    copy_wait();
    __syncthreads();  // slab m landed; slab m - 1 consumed
    if (m + 1 < M) {
      fetch(m + 1, stages + ((m + 1) & 1) * kStage);
      gather(m + 1);
    }
    if (m == nA) {
      // the carry's term is complete: this tile's part of q_t . (S_prev
      // dy_t) (role 0) or k_s . (dS v_s) and <dS, S_prev> (role 1); then
      // the scale by eA or wk
      const float* x = ROLE ? k : q;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = rg + 16 * i;
        float y = 0.f;
        if (t < C && d0 + jl < dk) {
          const float4 xv = load4(x + ((tb + t) * H + h) * dk + d0 + jl,
                                  dk - d0 - jl, vqk);
          y = xv.x * acc[i][0] + xv.y * acc[i][1] + xv.z * acc[i][2] +
              xv.w * acc[i][3];
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          y += __shfl_down_sync(0xffffffffu, y, o, 16);
        if (jl == 0 && t < C)
          part[(int64_t)blockIdx.y * B * S * H + (tb + t) * H + h] = y;
        const float e = scale_s[t];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= e;
      }
      if (ROLE == 1) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dsd += __shfl_down_sync(0xffffffffu, dsd, o);
        if ((tid & 31) == 0) red[tid >> 5] = dsd;
        __syncthreads();
        if (tid == 0) {
          float y = 0.f;
          for (int w8 = 0; w8 < kThreads / 32; ++w8) y += red[w8];
          dsd_part[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = y;
        }
      }
    }
    if (m < nA) {
      mma_tri<R>(acc, st, st + kLong + ROLE * kShort, rg, jl, 0, R - 1);
      if (ROLE == 1) {
        const float* P_s = st + kLong;
#pragma unroll
        for (int e = 0; e < kSlabG * kTile / kThreads; ++e) {
          const int i = tid + kThreads * e;
          const int o = (i / kTile) * kLdT + i % kTile;
          dsd = fmaf(P_s[o], P_s[kShort + o], dsd);
        }
      }
    } else if (ROLE == 0) {  // Dm k over slab n's columns s: rows t >= s
      mma_tri<R>(acc, st, st + kLong, rg, jl, m - nA, R - 1);
    } else {  // Dm^T q over slab n's rows t: rows s <= t
      mma_tri<R>(acc, st, st + kLong, rg, jl, 0, m - nA);
    }
    if (m + 1 < M) scatter(m + 1, stages + ((m + 1) & 1) * kStage);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = rg + 16 * i;
    if (t < C && d0 + jl < dk)
      store4(out + ((tb + t) * H + h) * dk + d0 + jl,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
             dk - d0 - jl, vqk);
  }
}

template <int CP>
__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_qk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dy,
                  const float* __restrict__ rec_ws,
                  const float* __restrict__ sp, const float* __restrict__ ds,
                  float* __restrict__ dq, float* __restrict__ dk_out,
                  float* __restrict__ qs_part, float* __restrict__ r_part,
                  float* __restrict__ dsd_part, int B, int S, int H, int dk,
                  int dv, int C, int has_init, int has_dstate, int vec) {
  const int ci = blockIdx.x % (S / C);
  if (blockIdx.z == 0)
    bwd_qk_block<CP, 0>(q, k, v, dy, rec_ws, sp, ds, dq, qs_part, dsd_part,
                        B, S, H, dk, dv, C, ci > 0 || has_init, vec);
  else
    bwd_qk_block<CP, 1>(q, k, v, dy, rec_ws, sp, ds, dk_out, r_part,
                        dsd_part, B, S, H, dk, dv, C,
                        ci + 1 < S / C || has_dstate, vec);
}

// Pass 5. Shared memory (floats): two stages of X_s [CP][kLdG] (a 16-wide
// column slab of k, then a row slab of W stored transposed) and P_s
// [16][kLdT] (dS rows, then dy rows), then wk_s [CP]. A thread owns rows
// rg + 16 i of the tile's dv and 4 of its columns.
template <int CP>
__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_v_kernel(const float* __restrict__ k, const float* __restrict__ dy,
                 const float* __restrict__ rec_ws,
                 const float* __restrict__ ds, float* __restrict__ dv_out,
                 int S, int H, int dk, int dv, int C, int has_dstate,
                 int vec) {
  constexpr int R = CP / 16;
  constexpr int kLong = CP * kLdG, kShort = kSlabG * kLdT;
  constexpr int kStage = kLong + kShort;
  constexpr int NQ = (kSlabG * CP / 4 + kThreads - 1) / kThreads;  // W^T
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* wk_s = stages + 2 * kStage;

  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const int b = bh / H, h = bh - b * H;
  const int j0 = kTile * blockIdx.y;
  const int64_t tb = (int64_t)b * S + (int64_t)ci * C;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, jl = 4 * (tid & 15);
  const bool vqk = (vec & 1) != 0, vv = (vec & 2) != 0;
  const bool doC = ci + 1 < n_chunks || has_dstate;  // dS is not zero
  const int nA = doC ? (dk + kSlabG - 1) / kSlabG : 0;
  const int nB = (C + kSlabG - 1) / kSlabG;
  const int64_t chunk = (int64_t)blockIdx.x * dk * dv;
  const float* rec = rec_ws + (int64_t)blockIdx.x * bwd_record_floats(CP);
  for (int t = tid; t < CP; t += kThreads)
    wk_s[t] = rec[2 * CP * CP + kVecWK * CP + t];

  // slab m: m < nA the dk rows 16 m .., else the chunk's steps 16 (m - nA) ..
  auto fetch = [&](int m, float* st) {
    if (m < nA) {
      const int d0 = kSlabG * m;
      for (int i = tid; i < CP * kSlabG / 4; i += kThreads) {
        const int s = i / (kSlabG / 4), c = 4 * (i % (kSlabG / 4));
        copy4(st + s * kLdG + c, k + ((tb + s) * H + h) * dk + d0 + c, k,
              s < C ? min(4, dk - d0 - c) : 0, vqk);
      }
      for (int i = tid; i < kSlabG * kTile / 4; i += kThreads) {
        const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
        copy4(st + kLong + r * kLdT + c,
              ds + chunk + (int64_t)(d0 + r) * dv + j0 + c, ds,
              d0 + r < dk ? min(4, dv - j0 - c) : 0, dv % 4 == 0);
      }
    } else {
      const int t0 = kSlabG * (m - nA);
      for (int i = tid; i < kSlabG * kTile / 4; i += kThreads) {
        const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
        copy4(st + kLong + r * kLdT + c,
              dy + ((tb + t0 + r) * H + h) * dv + j0 + c, dy,
              t0 + r < C ? min(4, dv - j0 - c) : 0, vv);
      }
    }
    copy_commit();
  };
  float4 reg[NQ];
  // W rows 16 (m - nA) + (i % 16), columns 4 (i / 16) ..
  auto gather = [&](int m) {
    if (m < nA) return;
    const int t0 = kSlabG * (m - nA);
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = tid + kThreads * u;
      if (i < kSlabG * CP / 4)
        reg[u] = *reinterpret_cast<const float4*>(
            rec + (t0 + i % kSlabG) * CP + 4 * (i / kSlabG));
    }
  };
  auto scatter = [&](int m, float* st) {
    if (m < nA) return;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = tid + kThreads * u;
      if (i < kSlabG * CP / 4) {
        const int t = i % kSlabG, s = 4 * (i / kSlabG);
        st[(s + 0) * kLdG + t] = reg[u].x;
        st[(s + 1) * kLdG + t] = reg[u].y;
        st[(s + 2) * kLdG + t] = reg[u].z;
        st[(s + 3) * kLdG + t] = reg[u].w;
      }
    }
  };

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  const int M = nA + nB;
  fetch(0, stages);
  gather(0);
  scatter(0, stages);
  for (int m = 0; m < M; ++m) {
    float* st = stages + (m & 1) * kStage;
    copy_wait();
    __syncthreads();  // slab m landed; slab m - 1 consumed
    if (m + 1 < M) {
      fetch(m + 1, stages + ((m + 1) & 1) * kStage);
      gather(m + 1);
    }
    if (m == nA) {  // k dS is complete: scale it by wk
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float w = wk_s[rg + 16 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= w;
      }
    }
    if (m < nA)
      mma_tri<R>(acc, st, st + kLong, rg, jl, 0, R - 1);
    else  // W^T dy over slab n's steps t: rows s <= t
      mma_tri<R>(acc, st, st + kLong, rg, jl, 0, m - nA);
    if (m + 1 < M) scatter(m + 1, stages + ((m + 1) & 1) * kStage);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = rg + 16 * i;
    if (s < C && j0 + jl < dv)
      store4(dv_out + ((tb + s) * H + h) * dv + j0 + jl,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
             dv - j0 - jl, vv);
  }
}

// Pass 6: a warp a (b, h, chunk), lane l the steps 4 l .. 4 l + 3. Every
// sum runs in a fixed order: the dk tiles' parts in tile order, the
// chunk's sum of the carry's dA terms down to lane 0, the suffix sums
// within a lane and then over the lanes above it.
__global__ void ssm_bwd_scalars_kernel(const float* __restrict__ rec_ws,
                                       const float* __restrict__ qs_part,
                                       const float* __restrict__ r_part,
                                       const float* __restrict__ dsd_part,
                                       float* __restrict__ da,
                                       float* __restrict__ dg, int B, int S,
                                       int H, int C, int CP, int ntd) {
  const int n = S / C;
  const int64_t chunks = (int64_t)B * H * n;
  const int64_t w = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= chunks) return;
  const int64_t bh = w / n;
  const int ci = (int)(w - bh * n);
  const int64_t b = bh / H, h = bh % H;
  const float* vecs = rec_ws + w * bwd_record_floats(CP) + 2 * (int64_t)CP * CP;
  const int64_t rows = (int64_t)B * S * H;
  const float a_c = vecs[kVecA * CP + C - 1];
  const float decay = vecs[kVecEA * CP + C - 1];
  float x[4], qsum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * lane + e;
    x[e] = 0.f;
    if (t < C) {
      const int64_t row = (b * S + (int64_t)ci * C + t) * H + h;
      float qs = 0.f, r = 0.f;
      for (int p = 0; p < ntd; ++p) {
        qs += qs_part[p * rows + row];
        r += r_part[p * rows + row];
      }
      const float At = vecs[kVecA * CP + t];
      const float Q = clip_live(a_c - At) ? vecs[kVecWK * CP + t] * r : 0.f;
      float a = vecs[kVecDAI * CP + t] - Q;
      if (clip_live(At)) a += vecs[kVecEA * CP + t] * qs;
      x[e] = a;
      qsum += Q;
      dg[row] = vecs[kVecDGI * CP + t] + vecs[kVecEC * CP + t] * r;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qsum += __shfl_down_sync(0xffffffffu, qsum, o);
  qsum = __shfl_sync(0xffffffffu, qsum, 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (4 * lane + e == C - 1) {  // the chunk's last step takes the carry's terms
      float dsd = 0.f;
      for (int p = 0; p < ntd; ++p) dsd += dsd_part[p * chunks + w];
      float c = qsum;
      if (clip_live(a_c)) c += decay * dsd;
      x[e] += c;
    }
  }
  x[2] += x[3];
  x[1] += x[2];
  x[0] += x[1];
  float above = x[0];  // becomes the sum over this lane and the lanes above
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, above, o);
    if (lane + o < 32) above += y;
  }
  above = __shfl_down_sync(0xffffffffu, above, 1);
  if (lane == 31) above = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * lane + e;
    if (t < C) da[(b * S + (int64_t)ci * C + t) * H + h] = x[e] + above;
  }
}

// the backward's kernels ask for the largest shared-memory carveout, so
// that two blocks of the record pass fit an SM
template <typename K>
int allow_smem_bwd(K kernel, size_t bytes) {
  const int e = allow_smem(kernel, bytes);
  if (e) return e;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

template <int CP>
int launch_bwd_cp(const float* q, const float* k, const float* v,
                  const float* a, const float* g, const float* init,
                  const float* dy, const float* dstate, float* dq,
                  float* dk_out, float* dv_out, float* da, float* dg,
                  float* dinit, float* rec, float* sp, float* ds,
                  float* qs_part, float* r_part, float* dsd_part, int B,
                  int S, int H, int dk, int dv, int C, int vec, int only,
                  cudaStream_t s) {
  const int n = S / C;
  const int64_t chunks = (int64_t)B * H * n;
  const int ntd = (dk + kTile - 1) / kTile, ntj = (dv + kTile - 1) / kTile;
  const int has_init = init != nullptr, has_dstate = dstate != nullptr;
  int e = 0;
  if (only < 0 || only == 0) {
    const size_t sm = bwd_record_smem(CP);
    if ((e = allow_smem_bwd(ssm_bwd_record_kernel<CP>, sm))) return e;
    ssm_bwd_record_kernel<CP><<<(unsigned)chunks, kThreads, sm, s>>>(
        q, k, v, dy, a, g, rec, S, H, dk, dv, C, vec);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (only < 0 || only == 1) {
    const size_t sm = bwd_state_smem(CP);
    if ((e = allow_smem_bwd(ssm_bwd_state_kernel<CP>, sm))) return e;
    ssm_bwd_state_kernel<CP><<<dim3((unsigned)chunks, ntd * ntj), kThreads,
                               sm, s>>>(q, k, v, dy, rec, sp, ds, S, H, dk,
                                        dv, C, has_init, vec);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (only < 0 || only == 2) {
    const int64_t total = (int64_t)B * H * (((int64_t)dk * dv + 3) / 4);
    ssm_bwd_carry_kernel<<<dim3((unsigned)((total + 255) / 256), 2), 256, 0,
                           s>>>(rec, init, dstate, sp, ds, dinit, (int64_t)B * H,
                                n, dk, dv, CP, C);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (only < 0 || only == 3) {
    const size_t sm = bwd_qk_smem(CP);
    if ((e = allow_smem_bwd(ssm_bwd_qk_kernel<CP>, sm))) return e;
    ssm_bwd_qk_kernel<CP><<<dim3((unsigned)chunks, ntd, 2), kThreads, sm, s>>>(
        q, k, v, dy, rec, sp, ds, dq, dk_out, qs_part, r_part, dsd_part, B, S,
        H, dk, dv, C, has_init, has_dstate, vec);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (only < 0 || only == 4) {
    const size_t sm = bwd_v_smem(CP);
    if ((e = allow_smem_bwd(ssm_bwd_v_kernel<CP>, sm))) return e;
    ssm_bwd_v_kernel<CP><<<dim3((unsigned)chunks, ntj), kThreads, sm, s>>>(
        k, dy, rec, ds, dv_out, S, H, dk, dv, C, has_dstate, vec);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (only < 0 || only == 5) {
    ssm_bwd_scalars_kernel<<<(unsigned)((chunks * 32 + 255) / 256), 256, 0,
                             s>>>(rec, qs_part, r_part, dsd_part, da, dg, B,
                                  S, H, C, CP, ntd);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
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

// The backward of ssm_chunk_scan_launch (float32 only). q, k: (B, S, H, dk);
// v and dy (y's gradient): (B, S, H, dv); a, g: (B, S, H); init (the
// initial state) and dstate (the final state's gradient): (B, H, dk, dv)
// or null (zero). Outputs: dq, dk_out (B, S, H, dk), dv_out (B, S, H, dv),
// da, dg (B, S, H), and dinit (B, H, dk, dv), written only where init is
// given. Workspaces, sized as ssm_scan_bwd_plan_bytes gives them: rec (a
// record of bwd_record_floats(cp) a chunk), sp and ds (dk * dv floats a
// chunk each), qs_part and r_part (B*S*H floats a 64-wide dk tile each) and
// dsd_part (B*H*(S/C) floats a dk tile). S is a multiple of C <= 128. vec:
// bit 0 says q and k rows may be read 16 bytes at a time (dk % 4 == 0,
// 16-byte aligned), bit 1 the same of v and dy (dv % 4 == 0). only: -1 runs
// the six passes in order; 0 to 5 runs that pass alone on a workspace an
// earlier call filled (its time is measured on its own).
extern "C" int ssm_chunk_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* a,
    const void* g, const void* init, const void* dy, const void* dstate,
    void* dq, void* dk_out, void* dv_out, void* da, void* dg, void* dinit,
    void* rec, void* sp, void* ds, void* qs_part, void* r_part,
    void* dsd_part, int B, int S, int H, int dk, int dv, int C, int vec,
    int only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
#define SSM_BWD_ARGS(CP)                                                     \
  launch_bwd_cp<CP>(                                                         \
      static_cast<const float*>(q), static_cast<const float*>(k),           \
      static_cast<const float*>(v), static_cast<const float*>(a),           \
      static_cast<const float*>(g), static_cast<const float*>(init),        \
      static_cast<const float*>(dy), static_cast<const float*>(dstate),     \
      static_cast<float*>(dq), static_cast<float*>(dk_out),                 \
      static_cast<float*>(dv_out), static_cast<float*>(da),                 \
      static_cast<float*>(dg), static_cast<float*>(dinit),                  \
      static_cast<float*>(rec), static_cast<float*>(sp),                    \
      static_cast<float*>(ds), static_cast<float*>(qs_part),                \
      static_cast<float*>(r_part), static_cast<float*>(dsd_part), B, S, H,  \
      dk, dv, C, vec, only, s)
  if (C <= 16) return SSM_BWD_ARGS(16);
  if (C <= 32) return SSM_BWD_ARGS(32);
  if (C <= 64) return SSM_BWD_ARGS(64);
  if (C <= 128) return SSM_BWD_ARGS(128);
#undef SSM_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// The backward's sizes, as its launcher computes them: which = 0 to 3 the
// shared memory a block of the record, state-products, dq/dk and dv
// passes, 4 the floats of one chunk's record.
extern "C" long long ssm_scan_bwd_plan_bytes(int C, int which) {
  const int cp = padded_chunk(C);
  if (cp == 0) return -1;
  if (which == 0) return (long long)bwd_record_smem(cp);
  if (which == 1) return (long long)bwd_state_smem(cp);
  if (which == 2) return (long long)bwd_qk_smem(cp);
  if (which == 3) return (long long)bwd_v_smem(cp);
  return (long long)bwd_record_floats(cp);
}
