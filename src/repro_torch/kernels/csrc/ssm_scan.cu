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
