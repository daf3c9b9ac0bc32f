// BF-IO pairwise swap search for Hopper (sm_90a), batched over clusters, with
// its prepass inside the one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/bfio_swap.py:swap_best_pallas.
// For cluster c and every candidate row i it computes
//
//   val[i, j] = sum_w max(ex(g_i, g_j)[w], max(lo_i[w] + d[w], lo_j[w] - d[w]))
//   d[w]      = c_j[w] - c_i[w]
//   ex(a, b)  = the largest load in window slot w over workers other than a, b
//               (picked from the per-slot top-3 loads)
//
// over the feasible j (both admitted, on different workers; +inf otherwise), and
// returns best_val[i] = min_j val[i, j] and best_j[i] = its first minimizer.
// A row with no feasible pair reports (+inf, 0), as jnp.argmin does.
//
// The kernel takes the solver's raw inputs -- loads (C, G, W) f32, cands
// (C, N, W) f32, assign (C, N) int32 or int64 (-1 = not admitted), valid (C, N)
// one byte each -- and computes inside itself what swap_prep computes in plain
// PyTorch: adm = assign >= 0 && valid, g = max(assign, 0), lo = loads[g] read
// straight from loads, and the per-slot top 3 in torch.argsort(-loads, dim=1,
// stable=True)'s order (larger value first, equal values, -0.0 and 0.0 among
// them, to the lower row; position k clamped to row G-1).
//
// Bound on an H100: at the router's shapes (C=1, G=4, N=64, W=1) neither bytes
// (~1 KB) nor operations (~25 K): the launch.  At pod scale (C=8, G=32, N=512,
// W=9) ~2 M pairs x 9 slots of float32 sub/add/max: ~1.2 us of the card's
// float32 rate.  What binds in practice is issue and shared memory: each
// (pair, slot) takes two shared-memory reads and eight arithmetic and select
// instructions, about 6 M warp instructions at pod scale.
//
// Design:
// * One warp per row i, kWarps = 16 rows a block, grid (ceil(N / 16), C).  A
//   thread takes ~120 registers at W = 9, so one such block fills an SM's
//   register file with 16 warps, as two blocks of 8 rows would; pod scale's
//   4,096 rows are 256 blocks, two deep on the 132 SMs.  Sixteen rows, not
//   eight, share each staged tile and each block's prologue.
// * The prologue, one round trip: every thread issues its cp.async copies of
//   the cluster's loads (G x W) and of the first j tile, and reads its share
//   of the tile's assign and valid, and each warp its own row's.  After one
//   barrier each warp ranks a window slot's loads from shared memory: each
//   lane's own top 3, then three redux.sync rounds over an order-preserving
//   key.  G x W floats must fit beside the tiles: the wrapper raises for a W
//   over swap_best_max_w(G).
// * Each row turns the top 3 into three numbers a slot for its own g_i: u, the
//   largest load on a row other than g_i, its row tu, and u2, the next one; then
//   ex(g_i, g_j) = (tu != g_j) ? u : u2, which picks exactly what the reference's
//   two-row exclusion picks (a selection, no arithmetic).  u, tu, u2, c_i and
//   lo_i sit in registers: the kernel is compiled for each W up to kChunk, so
//   the slot loop unrolls; a wider window walks its slots in chunks of kChunk,
//   reloading them from shared memory.
// * The 32 lanes of a warp take j = lane, lane + 32 of each 64 j, each keeping
//   a running (min, argmin) with a strict '<' over ascending j, and merge with
//   __shfl_xor_sync by least value, ties to the least j -- the first minimizer
//   over all j.  c_j is staged slot-major with a padded pitch, so the lanes
//   read consecutive words, and lo_j = loads[g_j] comes from the staged loads.
// * The j tile holds every j when that fits (N <= 1024 and ~112 KB), so the
//   search runs with no barrier in it.  Otherwise two tiles are double-
//   buffered: tile t+1's c_j is copied with cp.async, and its g_j (-1 when not
//   admitted) read into registers, while tile t is searched.  cp.async copies
//   no single byte, hence registers and not cp.async for assign and valid.
//
// Bit-exactness with the plain PyTorch version (and the reference's XLA path):
// the operations are the reference's, in its order -- d = c_j - c_i,
// la = lo_i + d, lb = lo_j - d, m = max(ex, max(la, lb)) -- and the W-sum is a
// left fold w = 0, 1, ..., W-1 starting from m[0].  There is no multiply, so no
// FMA contraction can apply, and the build uses no fast-math flag.
//
// Plain C interface (loaded with ctypes): swap_best_launch returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;                // rows i per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 64;                  // j a warp searches in one step
constexpr int kGroups = kSub / 32;        // j a lane takes per kSub
constexpr int kMaxTile = 1024;            // j per staged tile, at most
constexpr int kIdx = kMaxTile / kThreads; // a thread's share of a tile's j
constexpr int kChunk = 12;                // window slots held in registers
constexpr int kSmemMax = 232448;          // a block's shared memory on Hopper
constexpr int kSmemTile = 112 * 1024;     // what the tiles aim to fit

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (v, r) ranks before (w, s) in argsort(-loads, stable=True)'s order
__device__ __forceinline__ bool before(float v, int r, float w, int s) {
  return v > w || (v == w && r < s);
}

// insert (x, g) into the sorted top 3 (v, r)
__device__ __forceinline__ void push3(float (&v)[3], int (&r)[3], float x,
                                      int g) {
  if (!before(x, g, v[2], r[2])) return;
  if (before(x, g, v[1], r[1])) {
    v[2] = v[1];
    r[2] = r[1];
    if (before(x, g, v[0], r[0])) {
      v[1] = v[0];
      r[1] = r[0];
      v[0] = x;
      r[0] = g;
    } else {
      v[1] = x;
      r[1] = g;
    }
  } else {
    v[2] = x;
    r[2] = g;
  }
}

// an unsigned key in the order of the floats' values (NaN aside), with -0.0
// and 0.0 on one key so that they tie
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned u = __float_as_uint(x);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Layout {
  // floats: c_j tiles [nbuf][W][tile + 1], the cluster's loads [G][W], top-3
  // values [3][W], per-row slots [kWarps][W][4] (chunked only); then the
  // ints: top-2 rows [2][W], per-row tu [kWarps][W] (chunked only), g_j tiles
  // [nbuf][tile]
  size_t cj, lg, vtop, rowf, ttop, rowt, gj, bytes;
  __host__ __device__ Layout(int G, int W, int tile, int nbuf, bool chunked) {
    const size_t rows = chunked ? static_cast<size_t>(kWarps) * W : 0;
    cj = 0;
    lg = cj + static_cast<size_t>(nbuf) * W * (tile + 1);
    vtop = lg + static_cast<size_t>(G) * W;
    rowf = vtop + 3 * static_cast<size_t>(W);
    ttop = rowf + 4 * rows;                // in 4-byte words from here on
    rowt = ttop + 2 * static_cast<size_t>(W);
    gj = rowt + rows;
    bytes = 4 * (gj + static_cast<size_t>(nbuf) * tile);
  }
};

__host__ __device__ int n_buffers(int N, int tile) { return N > tile ? 2 : 1; }

// kW > 0: the window is exactly kW slots, all in registers; kW == 0: any W
// over kChunk, in chunks.  assign is read as int32 words, istride of them an
// element: an int64 in [-1, 2^31) has its value in its low word.
template <int kW>
__global__ void __launch_bounds__(kThreads, 1)
swap_best_kernel(int N, int G, int W, int tile, int istride,
                 const float* __restrict__ loads,     // (C, G, W)
                 const float* __restrict__ cands,     // (C, N, W)
                 const int32_t* __restrict__ assign,  // (C, N) x istride
                 const uint8_t* __restrict__ valid,   // (C, N)
                 float* __restrict__ best_val,        // (C, N)
                 int32_t* __restrict__ best_j) {      // (C, N)
  constexpr bool kChunked = kW == 0;
  constexpr int RW = kChunked ? kChunk : kW;   // slots in registers
  if (!kChunked) W = kW;
  extern __shared__ float smem[];
  const int nbuf = n_buffers(N, tile);
  const Layout L(G, W, tile, nbuf, kChunked);
  float* cj_s = smem + L.cj;
  float* lg_s = smem + L.lg;
  float* v_s = smem + L.vtop;
  float* rowf_s = smem + L.rowf;
  int32_t* t_s = reinterpret_cast<int32_t*>(smem) + L.ttop;
  int32_t* rowt_s = reinterpret_cast<int32_t*>(smem) + L.rowt;
  int32_t* gj_s = reinterpret_cast<int32_t*>(smem) + L.gj;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int P = tile + 1;                  // a slot's pitch in a tile
  const int64_t base = static_cast<int64_t>(c) * N;
  const float* lc = loads + static_cast<int64_t>(c) * G * W;
  const float* cc = cands + base * W;
  const int32_t* ac = assign + base * istride;
  const uint8_t* vc = valid + base;
  const int n_tiles = (N + tile - 1) / tile;

  // a tile's g_j (-1 when not admitted), read into registers while the tile
  // before it is searched: thread tid holds j = j0 + tid + e * kThreads
  int g_nx[kIdx];
  auto fetch = [&](int t) {
    const int j0 = t * tile;
#pragma unroll
    for (int e = 0; e < kIdx; ++e) {
      const int jj = tid + e * kThreads;
      g_nx[e] = -1;
      if (jj < tile && j0 + jj < N) {
        const int a = ac[static_cast<int64_t>(j0 + jj) * istride];
        if (a >= 0 && vc[j0 + jj] != 0) g_nx[e] = a;
      }
    }
  };
  auto store = [&](int t) {
    int32_t* gt = gj_s + (nbuf == 2 ? (t & 1) : 0) * tile;
#pragma unroll
    for (int e = 0; e < kIdx; ++e) {
      const int jj = tid + e * kThreads;
      if (jj < tile) gt[jj] = g_nx[e];
    }
  };
  // cp.async of tile t's c_j into its buffer, slot-major
  auto copy = [&](int t) {
    const int j0 = t * tile;
    const int nj = min(tile, N - j0);
    float* cj = cj_s + static_cast<size_t>(nbuf == 2 ? (t & 1) : 0) * W * P;
    const float* src = cc + static_cast<int64_t>(j0) * W;
    for (int k = tid; k < nj * W; k += kThreads) {
      const int jj = k / W;
      cp_async4(cj + (k - jj * W) * P + jj, src + k);
    }
    cp_async_commit();
  };

  fetch(0);
  for (int k = tid; k < G * W; k += kThreads) cp_async4(lg_s + k, lc + k);
  copy(0);

  // this warp's row; its c_i loads while the copies are in flight
  const int i = blockIdx.x * kWarps + warp;
  bool live = false;
  int gi = 0;
  if (i < N) {
    const int a = ac[static_cast<int64_t>(i) * istride];
    gi = max(a, 0);
    live = a >= 0 && vc[i] != 0;
  }
  const float* ci_row = cc + static_cast<int64_t>(live ? i : 0) * W;
  float r_ci[RW], r_li[RW], r_u[RW], r_u2[RW];
  int r_tu[RW];
  if (!kChunked && live) {
#pragma unroll
    for (int w = 0; w < RW; ++w) r_ci[w] = ci_row[w];
  }
  store(0);
  cp_async_wait_all();
  __syncthreads();

  // the top 3 of each window slot, from the staged loads, one warp a slot:
  // each lane keeps the top 3 of its own rows, then three rounds pick the
  // warp's next largest head (redux.sync over an order-preserving key), ties
  // to the lower row; argsort's position k is clamped to G - 1, as
  // idx[:, min(k, G - 1)] is
  for (int w = warp; w < W; w += kWarps) {
    float v[3] = {-INFINITY, -INFINITY, -INFINITY};
    int r[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    for (int g = lane; g < G; g += 32) push3(v, r, lg_s[g * W + w], g);
    int head = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float hv = head == 0 ? v[0] : head == 1 ? v[1] : v[2];
      const int hr = head == 0 ? r[0] : head == 1 ? r[1] : r[2];
      const unsigned hk = order_key(hv);
      const unsigned mk = __reduce_max_sync(0xffffffffu, hk);
      const int mr = __reduce_min_sync(0xffffffffu, hk == mk ? hr : INT32_MAX);
      if (hk == mk && hr == mr && hr != INT32_MAX) {
        v_s[k * W + w] = hv;
        if (k < 2) t_s[k * W + w] = hr;
        ++head;
      }
    }
    __syncwarp();
    if (lane == 0) {
      for (int k = G; k < 3; ++k) {
        v_s[k * W + w] = v_s[(G - 1) * W + w];
        if (k < 2) t_s[k * W + w] = t_s[(G - 1) * W + w];
      }
    }
  }
  __syncthreads();
  const float* li_row = lg_s + min(gi, G - 1) * W;

  // slot w of this row: ex(g_i, g_j) = tu != g_j ? u : u2
  auto row_slot = [&](int w, float& u, float& u2, int& tu) {
    const int t1 = t_s[w], t2 = t_s[W + w];
    const float v1 = v_s[w], v2 = v_s[W + w], v3 = v_s[2 * W + w];
    if (t1 != gi) {
      u = v1;
      tu = t1;
      u2 = t2 != gi ? v2 : v3;
    } else {
      u = v2;
      tu = t2;
      u2 = v3;
    }
  };
  if (live) {
    if (kChunked) {
      float* rf = rowf_s + static_cast<size_t>(warp) * W * 4;
      int32_t* rt = rowt_s + static_cast<size_t>(warp) * W;
      for (int w = lane; w < W; w += 32) {
        rf[4 * w] = ci_row[w];
        rf[4 * w + 1] = li_row[w];
        row_slot(w, rf[4 * w + 2], rf[4 * w + 3], rt[w]);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        r_li[w] = li_row[w];
        row_slot(w, r_u[w], r_u2[w], r_tu[w]);
      }
    }
  }

  float best = INFINITY;
  int arg = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const bool next = t + 1 < n_tiles;
    if (next) {
      copy(t + 1);
      fetch(t + 1);
    }
    if (live) {
      const int b = nbuf == 2 ? (t & 1) : 0;
      const int nj = min(tile, N - t * tile);
      const float* cj = cj_s + static_cast<size_t>(b) * W * P;
      const int32_t* gt = gj_s + b * tile;
      for (int sb = 0; sb < nj; sb += kSub) {
        float val[kGroups];
        int g[kGroups];
        const float* lj[kGroups];          // lo_j = loads[g_j]
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          g[q] = gt[sb + q * 32 + lane];
          lj[q] = lg_s + min(max(g[q], 0), G - 1) * W;
        }
        // one pass when the window fits the registers, else chunks of kChunk
        for (int w0 = 0; w0 < (kChunked ? W : 1); w0 += RW) {
          if (kChunked) {
            const float* rf = rowf_s + static_cast<size_t>(warp) * W * 4;
            const int32_t* rt = rowt_s + static_cast<size_t>(warp) * W;
#pragma unroll
            for (int w = 0; w < RW; ++w) {
              if (w0 + w < W) {
                r_ci[w] = rf[4 * (w0 + w)];
                r_li[w] = rf[4 * (w0 + w) + 1];
                r_u[w] = rf[4 * (w0 + w) + 2];
                r_u2[w] = rf[4 * (w0 + w) + 3];
                r_tu[w] = rt[w0 + w];
              }
            }
          }
#pragma unroll
          for (int w = 0; w < RW; ++w) {
            if (kChunked && w0 + w >= W) break;
#pragma unroll
            for (int q = 0; q < kGroups; ++q) {
              const int jj = sb + q * 32 + lane;
              const float ex = r_tu[w] != g[q] ? r_u[w] : r_u2[w];
              const float d = __fsub_rn(cj[(w0 + w) * P + jj], r_ci[w]);
              const float la = __fadd_rn(r_li[w], d);
              const float lb = __fsub_rn(lj[q][w0 + w], d);
              const float m = fmaxf(ex, fmaxf(la, lb));
              val[q] = (w0 + w == 0) ? m : __fadd_rn(val[q], m);
            }
          }
        }
        // infeasible (not admitted, same worker, or past N): +inf, never
        // < best
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          if (g[q] >= 0 && g[q] != gi && val[q] < best) {
            best = val[q];
            arg = t * tile + sb + q * 32 + lane;
          }
        }
      }
    }
    if (next) {
      store(t + 1);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // merge the lanes: the least value, ties to the least j, which is the first
  // minimizer over all j; rows with no feasible pair stay (+inf, 0)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, off);
    const int a = __shfl_xor_sync(0xffffffffu, arg, off);
    if (v < best || (v == best && a < arg)) {
      best = v;
      arg = a;
    }
  }
  if (lane == 0 && i < N) {
    best_val[base + i] = best;
    best_j[base + i] = arg;
  }
}

// The j tile: every j in one buffer when that fits kSmemTile, else the
// widest double-buffered tile that does, else kSub.
int pick_tile(int N, int G, int W, bool chunked) {
  const int all = ((N + kSub - 1) / kSub) * kSub;
  if (all <= kMaxTile && Layout(G, W, all, 1, chunked).bytes <= kSmemTile)
    return all;
  for (int t = (all < kMaxTile ? all : kMaxTile); t > kSub; t -= kSub)
    if (Layout(G, W, t, 2, chunked).bytes <= kSmemTile) return t;
  return kSub;
}

template <int kW>
int launch(int C, int N, int G, int W, int istride, const void* loads,
           const void* cands, const void* assign, const void* valid,
           void* best_val, void* best_j, cudaStream_t stream) {
  const int tile = pick_tile(N, G, W, kW == 0);
  const size_t smem = Layout(G, W, tile, n_buffers(N, tile), kW == 0).bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swap_best_kernel<kW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kWarps - 1) / kWarps, C);
  kernel<<<grid, kThreads, smem, stream>>>(
      N, G, W, tile, istride, static_cast<const float*>(loads),
      static_cast<const float*>(cands), static_cast<const int32_t*>(assign),
      static_cast<const uint8_t*>(valid), static_cast<float*>(best_val),
      static_cast<int32_t*>(best_j));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest W whose double-buffered tiles of kSub and loads table fit the
// 227 KB a block may use on Hopper, for G workers (0 when none does).
extern "C" int swap_best_max_w(int G) {
  int w = 0;
  while (Layout(G, w + 1, kSub, 2, true).bytes <= kSmemMax) ++w;
  return w;
}

// C clusters of N candidates over G workers with window W.  Every array is
// contiguous with the cluster axis first; assign is int64 when assign_is64 is
// nonzero and int32 otherwise; valid holds one byte per candidate.
extern "C" int swap_best_launch(int C, int N, int G, int W, int assign_is64,
                                const void* loads, const void* cands,
                                const void* assign, const void* valid,
                                void* best_val, void* best_j, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  if (G <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int st = assign_is64 ? 2 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFIO_CASE(w)                                                       \
  case w:                                                                  \
    return launch<w>(C, N, G, W, st, loads, cands, assign, valid, best_val, \
                     best_j, s);
  switch (W > kChunk ? 0 : W) {
    BFIO_CASE(1) BFIO_CASE(2) BFIO_CASE(3) BFIO_CASE(4) BFIO_CASE(5)
    BFIO_CASE(6) BFIO_CASE(7) BFIO_CASE(8) BFIO_CASE(9) BFIO_CASE(10)
    BFIO_CASE(11) BFIO_CASE(12)
    default:
      return launch<0>(C, N, G, W, st, loads, cands, assign, valid, best_val,
                       best_j, s);
  }
#undef BFIO_CASE
}
