// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py:paged_decode_attention_pallas.
// Bound on an H100: memory bytes. Per call it must read each live K/V row of
// every (row, kv-head) once (2 * sum(len) * Hkv * hd elements) plus q and the
// output; the arithmetic (4 * G * hd flops per K/V row pair) is far below the
// card's ratio of ~295 flops per byte.
//
// Design: the split-KV kernel of decode_attention_common.cuh (grid of splits
// x (KV head, group of 8 query heads) x row, a cp.async ring of 16-token
// K/V stages kept in the cache dtype, bf16 products on tensor cores with
// mma.sync in the swap-AB layout, float32 on CUDA cores, then a merge
// kernel over the splits' partials), with the paged addressing below. A split spans a whole number of pool blocks (64 tokens
// at block size 16). Token t of row b reads physical block tables[b, t /
// bs], row t % bs: ((phys * bs + t % bs) * Hkv + h) * hd; each warp reads
// its tile's table entries ahead of the copies that need them. A row attends [0, min(len, max_blocks * bs)) (the Pallas
// grid walks every max_blocks entry). Table entries of -1 are masked, as in
// the Pallas kernel; an index past the pool is clamped to its last block.
// The 1/sqrt(hd) scale is applied to the fp32 scores, as the plain version
// applies it, and q is not rounded again. A row with lengths == 0 writes
// zeros.
//
// Plain C interface (loaded with ctypes): paged_decode_attention_launch
// returns cudaGetLastError() after its two launches; it never synchronises.

#include "decode_attention_common.cuh"

namespace {

struct PagedRows {
  const int32_t* tables;
  const int32_t* lengths;
  int max_blocks, bs, n_pool;
  static constexpr bool kScaleScores = true;

  __device__ __forceinline__ void span(int b, int& lo, int& hi) const {
    const int len = lengths[b];
    const int cap = max_blocks * bs;
    lo = 0;
    hi = len < cap ? (len > 0 ? len : 0) : cap;
  }

  __device__ __forceinline__ int row(int b, int t) const {
    const int i = t / bs;
    if (i >= max_blocks) return -1;  // past the table (a split's tail)
    int phys = tables[(int64_t)b * max_blocks + i];
    if (phys < 0) return -1;  // unallocated entry: masked
    if (phys >= n_pool) phys = n_pool - 1;
    return phys * bs + t % bs;
  }
};

}  // namespace

// q: (B, Hq, hd); k_pool/v_pool: (n_pool_blocks, bs, Hkv, hd) of ONE layer;
// tables: (B, max_blocks) int32; lengths: (B,) int32; out: (B, Hq, hd);
// part: fp32 workspace of B * nsplit * Hq * (hd + 2) floats, with
// nsplit * split_len >= max_blocks * bs. dtype: 0 = float32, 1 = bfloat16.
// merge: 1 = split pass and merge, 0 = split pass only. The caller checked
// Hq % Hkv == 0, hd (<= 256; % 16 for bfloat16, % 8 for float32) and
// 16-byte alignment of q and the pools.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* part, void* out, int B, int Hq, int Hkv,
    int hd, int bs, int max_blocks, int n_pool_blocks, int split_len,
    int nsplit, int dtype, int merge, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || n_pool_blocks <= 0 ||
      (int64_t)nsplit * split_len < (int64_t)max_blocks * bs ||
      (int64_t)n_pool_blocks * bs > INT32_MAX)
    return (int)cudaErrorInvalidValue;  // pool rows are indexed in int32
  const PagedRows rows{static_cast<const int32_t*>(tables),
                       static_cast<const int32_t*>(lengths), max_blocks, bs,
                       n_pool_blocks};
  if (dtype == 0)
    return dattn::launch<float>(q, k_pool, v_pool, rows, part, out, B, Hq,
                                Hkv, hd, split_len, nsplit, merge, s);
  if (dtype == 1)
    return dattn::launch<__nv_bfloat16>(q, k_pool, v_pool, rows, part, out,
                                        B, Hq, Hkv, hd, split_len, nsplit,
                                        merge, s);
  return (int)cudaErrorInvalidValue;
}
