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
// Design: the split-KV kernel of decode_attention_common.cuh (grid of
// 64-token splits x (KV head, group of 8 query heads) x row, a cp.async ring
// of 16-token K/V stages kept in the cache dtype, bf16 products on tensor
// cores with mma.sync in the swap-AB layout, float32 on CUDA cores, then a
// merge kernel over the splits' partials), with the slot addressing below:
// token t of row b for KV head h sits at ((b * L + t) * Hkv + h) * hd. Each
// row attends
// its live span [lo, hi): hi = min(len, L); lo = max(0, len - window) for a
// non-rolling sliding window, else 0 (the Pallas grid walks every tile of
// L). The query is pre-scaled by 1/sqrt(hd) in fp32 and rounded to the
// cache dtype, as the plain version rounds it. A row whose span is empty
// writes zeros.
//
// Plain C interface (loaded with ctypes): decode_attention_launch returns
// cudaGetLastError() after its launches; it never synchronises.

#include "decode_attention_common.cuh"

namespace {

struct SlotRows {
  const int32_t* lengths;
  int L, window, rolling;
  static constexpr bool kScaleScores = false;

  __device__ __forceinline__ void span(int b, int& lo, int& hi) const {
    const int len = lengths[b];
    hi = len < L ? (len > 0 ? len : 0) : L;
    lo = (!rolling && window > 0 && len - window > 0) ? len - window : 0;
  }

  __device__ __forceinline__ int row(int b, int t) const {
    return b * L + t;
  }
};

}  // namespace

// q: (B, Hq, hd); k/v: (B, L, Hkv, hd); lengths: (B,) int32; out: (B, Hq,
// hd); part: fp32 workspace of B * nsplit * Hq * (hd + 2) floats, with
// nsplit * split_len >= L. window: sliding window (0 = none, ignored when
// rolling); rolling: 1 for a ring-buffer cache. dtype: 0 = float32,
// 1 = bfloat16. merge: 1 = split pass and merge, 0 = split pass only. The
// caller checked Hq % Hkv == 0, hd (<= 256; % 16 for bfloat16, % 8 for
// float32) and 16-byte alignment of q, k and v.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* part, void* out, int B, int Hq,
                                       int Hkv, int hd, int L, int window,
                                       int rolling, int split_len, int nsplit,
                                       int dtype, int merge, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)nsplit * split_len < L || (int64_t)B * L > INT32_MAX)
    return (int)cudaErrorInvalidValue;  // cache rows are indexed in int32
  const SlotRows rows{static_cast<const int32_t*>(lengths), L, window,
                      rolling};
  if (dtype == 0)
    return dattn::launch<float>(q, k, v, rows, part, out, B, Hq, Hkv, hd,
                                split_len, nsplit, merge, s);
  if (dtype == 1)
    return dattn::launch<__nv_bfloat16>(q, k, v, rows, part, out, B, Hq, Hkv,
                                        hd, split_len, nsplit, merge, s);
  return (int)cudaErrorInvalidValue;
}
