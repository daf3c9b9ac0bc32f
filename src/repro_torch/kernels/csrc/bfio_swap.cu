// BF-IO pairwise swap search for Hopper (sm_90a), batched over clusters.
//
// Replaces the Pallas TPU kernel repro/kernels/bfio_swap.py:swap_best_pallas.
// For cluster c and every candidate row i it computes
//
//   val[i, j] = sum_w max(ex(g_i, g_j)[w], max(lo_i[w] + d[w], lo_j[w] - d[w]))
//   d[w]      = c_j[w] - c_i[w]
//   ex(a, b)  = the largest load in window slot w over workers other than a, b
//               (picked from the per-slot top-3 values vtop and top-2 rows ttop)
//
// over the feasible j (both admitted, on different workers; +inf otherwise), and
// returns best_val[i] = min_j val[i, j] and best_j[i] = its first minimizer.
//
// Bound on an H100: neither bytes nor operations at the router's shapes (C=1,
// N=64, W=1 reads ~1 KB and does ~25 K operations): the launch dominates.  At
// pod scale (C=8, N=512, W=9) it is ~2 M pairs x 9 slots of float32 adds and
// max ops, still a few microseconds of the card's float32 rate.
//
// Design: grid (ceil(N / 32), C) of 256-thread blocks: 32 rows i per block and
// 8 lanes per row.  The block's own rows (c_i, lo_i) and the cluster's
// vtop/ttop live in shared memory for the whole walk; j ascends in 64-row
// tiles staged in shared memory (c_j, lo_j, g_j, admitted), and lane s of a
// row takes j = s, s + 8, ... of each tile, so a warp (one lane of 32 rows)
// reads one j at a time as a broadcast.  Each lane keeps its running
// (min, argmin) in registers from (+inf, 0) with a strict '<' over ascending
// j: its first minimizer.  The lanes merge through shared memory by least
// value, ties to the least j -- the first minimizer over all j -- and a row
// with no feasible pair reports (+inf, 0), as jnp.argmin does.  The lanes
// exist for latency: a single thread per row walking every j leaves each SM
// one or two warps to hide its shared-memory and branch latency with.
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

constexpr int kRows = 32;              // rows i per block
constexpr int kSplit = 8;              // j lanes per row
constexpr int kThreads = kRows * kSplit;
constexpr int kJ = 64;                 // rows j per staged tile

__global__ void __launch_bounds__(kThreads)
swap_best_kernel(int N, int W,
                 const float* __restrict__ cands,    // (C, N, W)
                 const float* __restrict__ lo,       // (C, N, W)
                 const int32_t* __restrict__ ga,     // (C, N)
                 const uint8_t* __restrict__ adm,    // (C, N)
                 const float* __restrict__ vtop,     // (C, 3, W)
                 const int32_t* __restrict__ ttop,   // (C, 2, W)
                 float* __restrict__ best_val,       // (C, N)
                 int32_t* __restrict__ best_j) {     // (C, N)
  extern __shared__ float smem[];
  // layout: own rows [W][kRows] x2, j tile [kJ][W] x2, vtop [3][W], lane
  // minima [kSplit][kRows]; then the int32 arrays: ttop [2][W], g_j [kJ],
  // admitted_j [kJ], lane argmins [kSplit][kRows]
  float* ci_s = smem;
  float* li_s = ci_s + W * kRows;
  float* cj_s = li_s + W * kRows;
  float* lj_s = cj_s + kJ * W;
  float* v_s = lj_s + kJ * W;
  float* rv_s = v_s + 3 * W;
  int32_t* t_s = reinterpret_cast<int32_t*>(rv_s + kSplit * kRows);
  int32_t* gj_s = t_s + 2 * W;
  int32_t* aj_s = gj_s + kJ;
  int32_t* ra_s = aj_s + kJ;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid % kRows;             // a warp is one lane of 32 rows,
  const int lane = tid / kRows;          // so it reads one j at a time
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + r;
  const int64_t base = static_cast<int64_t>(c) * N;
  const float* cc = cands + base * W;
  const float* lc = lo + base * W;

  for (int k = tid; k < 3 * W; k += kThreads) v_s[k] = vtop[static_cast<int64_t>(c) * 3 * W + k];
  for (int k = tid; k < 2 * W; k += kThreads) t_s[k] = ttop[static_cast<int64_t>(c) * 2 * W + k];
  for (int k = tid; k < kRows * W; k += kThreads) {
    const int rr = k % kRows;
    const int w = k / kRows;
    if (i0 + rr < N) {
      ci_s[k] = cc[static_cast<int64_t>(i0 + rr) * W + w];
      li_s[k] = lc[static_cast<int64_t>(i0 + rr) * W + w];
    }
  }
  const bool live = i < N;
  const int gi = live ? ga[base + i] : -1;
  const bool ai = live && adm[base + i] != 0;

  // each lane walks its j (jj = lane, lane + kSplit, ...) in ascending
  // order with a strict '<': its first minimizer
  float best = INFINITY;
  int arg = 0;
  for (int j0 = 0; j0 < N; j0 += kJ) {
    const int nj = min(kJ, N - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = tid; k < nj * W; k += kThreads) {
      cj_s[k] = cc[static_cast<int64_t>(j0) * W + k];
      lj_s[k] = lc[static_cast<int64_t>(j0) * W + k];
    }
    for (int k = tid; k < nj; k += kThreads) {
      gj_s[k] = ga[base + j0 + k];
      aj_s[k] = adm[base + j0 + k];
    }
    __syncthreads();
    if (!ai) continue;
    for (int jj = lane; jj < nj; jj += kSplit) {
      const int gj = gj_s[jj];
      if (!aj_s[jj] || gj == gi) continue;  // infeasible: +inf, never < best
      const float* cj = cj_s + jj * W;
      const float* lj = lj_s + jj * W;
      float val = 0.f;
      for (int w = 0; w < W; ++w) {
        const int t1 = t_s[w];
        const int t2 = t_s[W + w];
        const float ex = (t1 != gi && t1 != gj) ? v_s[w]
                         : (t2 != gi && t2 != gj) ? v_s[W + w]
                                                  : v_s[2 * W + w];
        const float d = __fsub_rn(cj[w], ci_s[w * kRows + r]);
        const float la = __fadd_rn(li_s[w * kRows + r], d);
        const float lb = __fsub_rn(lj[w], d);
        const float m = fmaxf(ex, fmaxf(la, lb));
        val = (w == 0) ? m : __fadd_rn(val, m);
      }
      if (val < best) {
        best = val;
        arg = j0 + jj;
      }
    }
  }
  // merge the lanes: the least value, ties to the least j, which is the
  // first minimizer over all j; rows with no feasible pair stay (+inf, 0)
  rv_s[lane * kRows + r] = best;
  ra_s[lane * kRows + r] = arg;
  __syncthreads();
  if (lane == 0 && live) {
    for (int s = 1; s < kSplit; ++s) {
      const float v = rv_s[s * kRows + r];
      const int a = ra_s[s * kRows + r];
      if (v < best || (v == best && a < arg)) {
        best = v;
        arg = a;
      }
    }
    best_val[base + i] = best;
    best_j[base + i] = arg;
  }
}

size_t smem_bytes(int W) {
  return sizeof(float) * (2 * static_cast<size_t>(kRows + kJ) * W + 3 * W +
                          kSplit * kRows) +
         sizeof(int32_t) * (2 * static_cast<size_t>(W) + 2 * kJ +
                            kSplit * kRows);
}

}  // namespace

// Largest W whose tiles fit the 227 KB a block may use on Hopper.
extern "C" int swap_best_max_w() {
  int w = 1;
  while (smem_bytes(w + 1) <= 232448) ++w;
  return w;
}

// C clusters of N candidates over G workers with window W.  Every array is
// contiguous with the cluster axis first; adm holds one byte per candidate.
extern "C" int swap_best_launch(int C, int N, int G, int W, const void* cands,
                                const void* lo, const void* ga, const void* adm,
                                const void* vtop, const void* ttop, void* best_val,
                                void* best_j, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  if (G <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(W);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        swap_best_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kRows - 1) / kRows, C);
  swap_best_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      N, W, static_cast<const float*>(cands), static_cast<const float*>(lo),
      static_cast<const int32_t*>(ga), static_cast<const uint8_t*>(adm),
      static_cast<const float*>(vtop), static_cast<const int32_t*>(ttop),
      static_cast<float*>(best_val), static_cast<int32_t*>(best_j));
  return static_cast<int>(cudaGetLastError());
}
