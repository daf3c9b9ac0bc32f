// Split-KV one-token GQA decode attention for Hopper (sm_90a): the device
// code shared by the paged kernel (paged_attention.cu, K1) and the
// contiguous-slot kernel (decode_attention.cu, K3).
//
// The two compute one function, one-token attention of the G query heads of
// each KV head over a row's live cache span with an online softmax, and
// differ only in how a token's K/V row is addressed (a block table for K1, a
// slot row for K3). Each file supplies a `Rows` policy:
//   void span(int b, int& lo, int& hi)  the live span [lo, hi) of row b
//   int row(int b, int t)               the cache row of row b's token t in
//                                       the (rows, Hkv, hd) view of K and V,
//                                       or -1 (masked: a -1 table entry)
//   static constexpr bool kScaleScores  scale fp32 scores by 1/sqrt(hd) (K1);
//                                       else the query comes pre-scaled and
//                                       rounded to the cache dtype (K3)
//
// Bound on an H100: memory bytes. Each live K/V row is read once; the
// arithmetic is ~4 flops per byte, far below the card's ~295.
//
// Design:
// 1. Split-KV. Grid (split, KV head x group of 8 query heads, row). A block
//    takes the tokens [s*S, s*S+S) of its row clipped to the live span and
//    exits at once when that is empty; the host never reads `lengths`. It
//    writes one fp32 partial (acc, m, l) per query head to a workspace. A
//    second kernel, launched from the same C entry point, reads each row's
//    live span again and merges the partials of the splits it covers with
//    the usual rescale. An empty partial carries m = -1e30 and l = 0, so it
//    merges without NaN; a row with no live token writes zeros. The merge
//    is a programmatic dependent launch, so its launch overlaps the split
//    pass's last blocks; its blocks read `lengths` and then wait for the
//    split pass's writes.
// 2. A ring of tiles filled by cp.async. A split is cut into 16-token tiles;
//    warp w owns tiles w, w+4, ... and one stage of the block's ring, which
//    it refills with its next tile as soon as it has computed one, so the
//    block's four stages are all in flight before any is computed and a
//    warp needs only __syncwarp, never a block barrier, inside its loop.
//    A block reads its row's length and its first tiles' table entries
//    together and exits at once if its split is dead; its query tile
//    (bf16) is one cp.async group ahead of its K/V stages, so it lands
//    while they fly. Launch bounds keep 6 (hd <= 128) or 8 (hd <= 64) bf16
//    blocks resident on an SM to hide the copies' latency.
//    Each stage holds K and V in the cache dtype, copied with 16-byte
//    `cp.async.cg` (zero-filled for masked tokens) and committed per stage.
//    bf16 rows are XOR-swizzled in 16-byte chunks so that `ldmatrix` reads
//    are free of bank conflicts; float32 rows are padded by 16 bytes.
// 3. bf16 on tensor cores, `mma.sync.m16n8k16` with fp32 accumulation in the
//    "swap AB" layout: tokens on M (16), query heads on N (8, padded when
//    G < 8; G > 8 runs as several groups). S^T = K Q^T with K from
//    `ldmatrix` and the Q^T fragments, read once with `ldmatrix` from the
//    swizzled query tile, held in registers; the online softmax runs
//    on the fp32 score fragments with warp shuffles; P^T is rounded to bf16
//    and moved into the B layout with `movmatrix.trans`; O^T = V^T P^T with
//    `ldmatrix.trans` from the V stage. The four warps' states are merged in
//    shared memory at the end of the block.
// 4. float32 keeps the same split, ring and fragment ownership but computes
//    its products with fp32 FMA on CUDA cores (no TF32), so that float32
//    callers get float32 results.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dattn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;    // tokens per tile: the M of one mma
constexpr int kHeads = 8;    // query heads per block: the N of one mma
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMergeThreads = 256;

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

__device__ __forceinline__ float group_max(float v) {  // over lane bits 2..4
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ------------------------------------------------------------ layout ----

// Bytes between two token rows of a stage. bf16: the row's 16-byte chunks
// rounded up to a power of two (so the XOR swizzle stays inside the row);
// float32: the row plus 16 bytes of padding.
template <typename T>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  if (std::is_same<T, float>::value) return (hd + 4) * 4;
  int n = 1;
  while (n < hd / 8) n <<= 1;
  return n * 16;
}

// Physical 16-byte chunk of logical chunk c in row r (bf16 stages): eight
// rows read at one logical chunk land in eight distinct bank groups.
__device__ __forceinline__ int swz(int r, int c, int nchunk_pow2) {
  const int per = nchunk_pow2 >= 8 ? 8 : nchunk_pow2;
  const int rows_per_128b = 8 / per;
  return c ^ ((r / rows_per_128b) & (per - 1));
}

template <typename T>
__host__ __device__ __forceinline__ size_t split_smem_bytes(int hd) {
  size_t tiles = (size_t)kWarps * 2 * kTile * row_bytes<T>(hd);
  size_t red = (size_t)kWarps * kHeads * hd * 4;  // reuses the stages
  if (red > tiles) tiles = red;
  const size_t q = std::is_same<T, float>::value
                       ? (size_t)kHeads * (hd + 4) * 4
                       : (size_t)kHeads * row_bytes<T>(hd);
  return tiles + q + (size_t)(kWarps + 1) * kHeads * 2 * 4;
}

// -------------------------------------------------------- split pass ----

// Blocks per SM that the register budget must allow: the split pass is
// bound by the latency of its copies, so residency is what hides it.
template <typename T, int HD>
struct MinBlocks {
  static constexpr int value =
      std::is_same<T, float>::value ? 1 : (HD <= 64 ? 8 : (HD <= 128 ? 6 : 3));
};

// Partial record per (row b, split s, query head): [acc(hd), m, l], fp32.
template <typename T, int HD, class Rows>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, HD>::value))
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, Rows rows, float* __restrict__ part,
             int Hq, int Hkv, int hd, int S, int nsplit, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kDb = HD / 16;  // 16-wide blocks of hd
  extern __shared__ __align__(128) unsigned char smem[];

  const int s = blockIdx.x;
  const int G = Hq / Hkv;
  const int ngrp = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / ngrp;
  const int grp = blockIdx.y - h * ngrp;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // fragment column pair
  const int Gv = min(kHeads, G - grp * kHeads);  // live heads of the group
  const int head0 = h * G + grp * kHeads;        // first query head
  const int base_t = s * S;

  // This warp's first tile's rows (warp w owns tiles w, w + kWarps, ... of
  // the split; for K1 a table read) and the row's length are read together.
  int ri_first = rows.row(b, base_t + w * kTile + (lane & (kTile - 1)));
  int lo, hi;
  rows.span(b, lo, hi);
  const int t_begin = max(lo, base_t);
  const int t_end = min(hi, base_t + S);
  if (t_begin >= t_end) return;  // block-uniform: nothing live here

  const int RS = row_bytes<T>(hd);
  const int nchunk = hd * (int)sizeof(T) / 16;
  const int nchunk_p2 = RS / 16;
  const int64_t row_elems = (int64_t)Hkv * hd;  // elements between rows
  const int64_t head_off = (int64_t)h * hd;
  const size_t stage_bytes = (size_t)2 * kTile * RS;
  size_t tiles_bytes = (size_t)kWarps * stage_bytes;
  const size_t red_bytes = (size_t)kWarps * kHeads * hd * 4;
  if (red_bytes > tiles_bytes) tiles_bytes = red_bytes;
  // the queries: f32 rows padded as the stages; bf16 rows swizzled as them
  float* q_s = reinterpret_cast<float*>(smem + tiles_bytes);
  unsigned char* q_tile = smem + tiles_bytes;
  float* ml_s = reinterpret_cast<float*>(
      smem + tiles_bytes +
      (kF32 ? (size_t)kHeads * (hd + 4) * 4 : (size_t)kHeads * RS));
  unsigned char* ks = smem + (size_t)w * stage_bytes;  // this warp's stage
  unsigned char* vs = ks + (size_t)kTile * RS;
  const int ntiles = S / kTile;

  // tile i's row index for lane (token i * kTile + lane % kTile), -1 when
  // masked or outside the live span
  auto live_row = [&](int i, int ri) {
    const int t = base_t + i * kTile + (lane & (kTile - 1));
    return (t >= t_begin && t < t_end) ? ri : -1;
  };
  auto tile_live = [&](int i) {
    return base_t + i * kTile < t_end && base_t + (i + 1) * kTile > t_begin;
  };

  // copy a tile's K and V rows into the warp's stage: 16-byte chunks, each
  // row's index (`ri` of lane r) shuffled from the lane that holds it,
  // zero-fill for masked rows
  auto issue = [&](int ri) {
    auto copy = [&](int r, int c, bool active) {  // every lane shuffles
      const int rr = __shfl_sync(0xffffffffu, ri, r);
      if (!active) return;
      const bool live = rr >= 0;
      const int64_t e = (int64_t)(live ? rr : 0) * row_elems + head_off +
                        (int64_t)c * (16 / (int)sizeof(T));
      const int pc = kF32 ? c : swz(r, c, nchunk_p2);
      cp_async16(smem_u32(ks + r * RS + pc * 16), k + e, live);
      cp_async16(smem_u32(vs + r * RS + pc * 16), v + e, live);
    };
    if (nchunk <= 32 && (32 % nchunk) == 0) {  // a fixed chunk per lane
      const int per = 32 / nchunk;
      const int c = lane % nchunk;
      for (int r = lane / nchunk; r < kTile; r += per) copy(r, c, true);
    } else {
      const int total = kTile * nchunk;
      for (int base = 0; base < total; base += 32) {
        const int idx = min(base + lane, total - 1);
        const int r = idx / nchunk;
        copy(r, idx - r * nchunk, base + lane < total);
      }
    }
  };

  if constexpr (!kF32) {  // bf16 queries: one group of 16-byte copies
    for (int i = tid; i < kHeads * nchunk; i += kThreads) {
      const int j = i / nchunk, c = i - j * nchunk;
      const bool live = j < Gv;  // heads past the group are zero-filled
      const T* src = q + ((int64_t)b * Hq + head0 + (live ? j : 0)) * hd + c * 8;
      cp_async16(smem_u32(q_tile + j * RS + swz(j, c, nchunk_p2) * 16), src,
                 live);
    }
    cp_async_commit();
  }

  // this warp's live tiles: w, w + kWarps, ... that meet [t_begin, t_end)
  int ri = -1;  // row index of the tile in the stage
  int next = w;
  auto advance = [&]() {  // next live tile of this warp, or ntiles
    while (next < ntiles && !tile_live(next)) next += kWarps;
  };
  advance();
  bool in = next < ntiles;  // a tile is in the stage
  if (in) {
    ri = live_row(next, next == w ? ri_first
                                  : rows.row(b, base_t + next * kTile +
                                                    (lane & (kTile - 1))));
    issue(ri);
    next += kWarps;
    advance();
  }
  cp_async_commit();

  uint32_t qf[kDb][2];  // bf16: B operand of S^T = K Q^T, in registers
  if constexpr (!kF32) {  // once the queries' group has landed
    cp_async_wait<1>();
    __syncthreads();
    const int mi = lane >> 3;
    const int r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kDb; kk += 2) {
      if (kk * 16 < hd) {  // four 8x8 matrices: d chunks 2kk .. 2kk+3
        uint32_t x[4];
        ldsm_x4(smem_u32(q_tile + r * RS + swz(r, kk * 2 + mi, nchunk_p2) * 16), x);
        qf[kk][0] = x[0];
        qf[kk][1] = x[1];
        qf[kk + 1][0] = x[2];
        qf[kk + 1][1] = x[3];
      }
    }
    if (!Rows::kScaleScores) {  // pre-scaled, rounded to the cache dtype
#pragma unroll
      for (int kk = 0; kk < kDb; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][half]);
          qf[kk][half] = pack_bf16(round_bf16(__low2float(x) * scale),
                                   round_bf16(__high2float(x) * scale));
        }
      }
    }
  } else {  // float32 queries, staged while the copies fly
    for (int i = tid; i < kHeads * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      float x = 0.f;
      if (j < Gv) {
        x = to_float(q[((int64_t)b * Hq + head0 + j) * hd + d]);
        if (!Rows::kScaleScores) x *= scale;
      }
      q_s[j * (hd + 4) + d] = x;
    }
    __syncthreads();
  }

  float m[2] = {kNeg, kNeg};  // heads 2*t4, 2*t4 + 1
  float l[2] = {0.f, 0.f};
  float acc[kDb][4];
#pragma unroll
  for (int i = 0; i < kDb; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  while (in) {
    cp_async_wait<0>();
    __syncwarp();

    // scores S^T: sc[0] (token g, head 2t4), sc[1] (g, 2t4+1),
    // sc[2] (g+8, 2t4), sc[3] (g+8, 2t4+1)
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kF32) {
      const float* k0 = reinterpret_cast<const float*>(ks + g * RS);
      const float* k1 = reinterpret_cast<const float*>(ks + (g + 8) * RS);
      const float* q0 = q_s + (2 * t4) * (hd + 4);
      const float* q1 = q0 + (hd + 4);
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(k0 + d);
        const float4 c = *reinterpret_cast<const float4*>(k1 + d);
        const float4 x = *reinterpret_cast<const float4*>(q0 + d);
        const float4 y = *reinterpret_cast<const float4*>(q1 + d);
        sc[0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
        sc[1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
        sc[2] += c.x * x.x + c.y * x.y + c.z * x.z + c.w * x.w;
        sc[3] += c.x * y.x + c.y * y.y + c.z * y.z + c.w * y.w;
      }
    } else {
      const int mi = lane >> 3;
      const int r = (lane & 7) + 8 * (mi & 1);
#pragma unroll
      for (int kk = 0; kk < kDb; ++kk) {
        if (kk * 16 < hd) {
          uint32_t a[4];
          const int c = kk * 2 + (mi >> 1);
          ldsm_x4(smem_u32(ks + r * RS + swz(r, c, nchunk_p2) * 16), a);
          mma_bf16(sc, a, qf[kk][0], qf[kk][1]);
        }
      }
    }

    // mask, online softmax on the fragments
    const bool va = __shfl_sync(0xffffffffu, ri, g) >= 0;
    const bool vb = __shfl_sync(0xffffffffu, ri, g + 8) >= 0;
    if (Rows::kScaleScores) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] *= scale;
    }
    float p[4], alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float mx = group_max(fmaxf(va ? sc[c] : kNeg, vb ? sc[c + 2] : kNeg));
      const float mn = fmaxf(m[c], mx);
      alpha[c] = __expf(m[c] - mn);
      p[c] = va ? __expf(sc[c] - mn) : 0.f;
      p[c + 2] = vb ? __expf(sc[c + 2] - mn) : 0.f;
      if constexpr (!kF32) {
        p[c] = round_bf16(p[c]);
        p[c + 2] = round_bf16(p[c + 2]);
      }
      l[c] = l[c] * alpha[c] + group_sum(p[c] + p[c + 2]);
      m[c] = mn;
    }
#pragma unroll
    for (int i = 0; i < kDb; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[1];
      acc[i][2] *= alpha[0];
      acc[i][3] *= alpha[1];
    }

    // O^T += V^T P^T
    if constexpr (kF32) {
#pragma unroll 2
      for (int r8 = 0; r8 < 8; ++r8) {
        const int src = r8 * 4 + t4;
        const float pa0 = __shfl_sync(0xffffffffu, p[0], src);
        const float pa1 = __shfl_sync(0xffffffffu, p[1], src);
        const float pb0 = __shfl_sync(0xffffffffu, p[2], src);
        const float pb1 = __shfl_sync(0xffffffffu, p[3], src);
        const float* va_row = reinterpret_cast<const float*>(vs + r8 * RS);
        const float* vb_row = reinterpret_cast<const float*>(vs + (r8 + 8) * RS);
#pragma unroll
        for (int i = 0; i < kDb; ++i) {
          const int d = i * 16 + g;
          if (d < hd) {
            const float x = va_row[d], y = vb_row[d];
            acc[i][0] += x * pa0 + y * pb0;
            acc[i][1] += x * pa1 + y * pb1;
          }
          if (d + 8 < hd) {
            const float x = va_row[d + 8], y = vb_row[d + 8];
            acc[i][2] += x * pa0 + y * pb0;
            acc[i][3] += x * pa1 + y * pb1;
          }
        }
      }
    } else {
      const uint32_t b0 = movmatrix_trans(pack_bf16(p[0], p[1]));
      const uint32_t b1 = movmatrix_trans(pack_bf16(p[2], p[3]));
      const int mi = lane >> 3;
      const int r = (lane & 7) + 8 * (mi >> 1);
#pragma unroll
      for (int i = 0; i < kDb; ++i) {
        if (i * 16 < hd) {
          uint32_t a[4];
          const int c = i * 2 + (mi & 1);
          ldsm_x4_trans(smem_u32(vs + r * RS + swz(r, c, nchunk_p2) * 16), a);
          mma_bf16(acc[i], a, b0, b1);
        }
      }
    }
    __syncwarp();
    in = next < ntiles;
    if (in) {  // refill the stage just computed
      ri = live_row(next, rows.row(b, base_t + next * kTile +
                                       (lane & (kTile - 1))));
      issue(ri);
      next += kWarps;
      advance();
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its stages

  // merge the four warps' states in shared memory, write the partials
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][kHeads][hd]
#pragma unroll
  for (int i = 0; i < kDb; ++i) {
    const int d = i * 16 + g;
    float* r0 = red + ((size_t)w * kHeads + 2 * t4) * hd;
    float* r1 = r0 + hd;
    if (d < hd) {
      r0[d] = acc[i][0];
      r1[d] = acc[i][1];
    }
    if (d + 8 < hd) {
      r0[d + 8] = acc[i][2];
      r1[d + 8] = acc[i][3];
    }
  }
  if (g == 0) {
    float* ml = ml_s + ((size_t)w * kHeads + 2 * t4) * 2;
    ml[0] = m[0];
    ml[1] = l[0];
    ml[2] = m[1];
    ml[3] = l[1];
  }
  __syncthreads();
  if (tid < kHeads) {  // per head: the block's max, sum and warp weights
    float M = kNeg;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) M = fmaxf(M, ml_s[(ww * kHeads + tid) * 2]);
    float ls = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      float* ml = ml_s + (ww * kHeads + tid) * 2;
      const float f = __expf(ml[0] - M);
      ls += f * ml[1];
      ml[0] = f;  // the weight replaces the warp's max
    }
    ml_s[(kWarps * kHeads + tid) * 2] = M;
    ml_s[(kWarps * kHeads + tid) * 2 + 1] = ls;
  }
  __syncthreads();
  float* rec0 = part + (((int64_t)b * nsplit + s) * Hq + head0) * (hd + 2);
  for (int e = tid; e < Gv * hd; e += kThreads) {
    const int jh = e / hd, d = e - jh * hd;
    float a = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      a += ml_s[(ww * kHeads + jh) * 2] * red[((size_t)ww * kHeads + jh) * hd + d];
    float* rec = rec0 + (int64_t)jh * (hd + 2);
    rec[d] = a;
    if (d == 0) {
      rec[hd] = ml_s[(kWarps * kHeads + jh) * 2];
      rec[hd + 1] = ml_s[(kWarps * kHeads + jh) * 2 + 1];
    }
  }
}

// -------------------------------------------------------- merge pass ----

// One thread per output element of a row: the splits that the row's live
// span covers, rescaled to their common max. The loops are unrolled so that
// the partials' loads of several splits are in flight together.
template <typename T, class Rows>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(Rows rows, const float* __restrict__ part, T* __restrict__ out,
             int Hq, int hd, int S, int nsplit) {
  const int b = blockIdx.y;
  int lo, hi;
  rows.span(b, lo, hi);
  const int s0 = lo / S;
  const int n = hi > lo ? (hi - 1) / S + 1 - s0 : 0;  // splits that wrote
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split pass
  const int64_t step = (int64_t)Hq * (hd + 2);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < Hq * hd;
       e += gridDim.x * blockDim.x) {
    const int head = e / hd, d = e - head * hd;
    const float* rec =
        part + ((int64_t)b * nsplit + s0) * step + (int64_t)head * (hd + 2);
    float M = kNeg;
#pragma unroll 4
    for (int i = 0; i < n; ++i) M = fmaxf(M, __ldcg(rec + i * step + hd));
    float a = 0.f, ls = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float* r = rec + i * step;
      const float f = __expf(__ldcg(r + hd) - M);
      a += f * __ldcg(r + d);
      ls += f * __ldcg(r + hd + 1);
    }
    store(ls > 0.f ? a / ls : 0.f, &out[((int64_t)b * Hq + head) * hd + d]);
  }
}

// ------------------------------------------------------------ launch ----

template <typename T, int HD, class Rows>
int launch_hd(const T* q, const T* k, const T* v, const Rows& rows,
              float* part, T* out, int B, int Hq, int Hkv, int hd, int S,
              int nsplit, float scale, int merge, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int ngrp = (G + kHeads - 1) / kHeads;
  const size_t smem = split_smem_bytes<T>(hd);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, HD, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nsplit, Hkv * ngrp, B);
  split_kernel<T, HD, Rows><<<grid, kThreads, smem, stream>>>(
      q, k, v, rows, part, Hq, Hkv, hd, S, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !merge) return (int)e;
  // the merge as a programmatic dependent launch: it is launched as the
  // split pass's blocks exit, not after the grid's completion is signalled,
  // and waits for the split pass's writes before reading the partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Hq * hd + kMergeThreads - 1) / kMergeThreads, B);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpart = part;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<T, Rows>, rows, cpart,
                                 out, Hq, hd, S, nsplit);
}

// merge: 1 = split pass, then the merge into out; 0 = split pass only.
template <typename T, class Rows>
int launch(const void* q, const void* k, const void* v, const Rows& rows,
           void* part, void* out, int B, int Hq, int Hkv, int hd, int S,
           int nsplit, int merge, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || hd <= 0 || hd > kMaxHd || S <= 0 || S % kTile ||
      nsplit <= 0 || (hd * (int)sizeof(T)) % 16 ||
      (!std::is_same<T, float>::value && hd % 16))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  float* pt = static_cast<float*>(part);
  T* ot = static_cast<T*>(out);
#define DATTN_LAUNCH(HD)                                                  \
  return launch_hd<T, HD>(qt, kt, vt, rows, pt, ot, B, Hq, Hkv, hd, S,    \
                          nsplit, scale, merge, stream)
  if (hd <= 32) DATTN_LAUNCH(32);
  if (hd <= 64) DATTN_LAUNCH(64);
  if (hd <= 128) DATTN_LAUNCH(128);
  DATTN_LAUNCH(256);
#undef DATTN_LAUNCH
}

}  // namespace dattn
