"""One-token GQA decode attention over a contiguous per-slot KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py:
decode_attention_pallas`` and carries the two masks the reference's model
function (``repro/models/attention.py: decode_attention``) adds to it: a
sliding window and a rolling (ring-buffer) cache.  On an H100 the kernel
(``csrc/decode_attention.cu`` over the split-KV design shared with the
paged kernel in ``csrc/decode_attention_common.cuh``) is bound by memory
bytes: it must read each live K/V row once, and its arithmetic (4 * G * hd
flops per K/V row pair) is far below the card's flops-per-byte ratio.  Its
design: the cache's L positions are cut into 64-token splits, one block
per (split, KV head, group of 8 query heads, row), so that a decode step
fills the card however few rows it has; a block whose split lies outside
its row's live span exits at once, and the host never reads ``lengths``.
Each block streams its K/V through a ring of 16-token stages in shared
memory, filled by ``cp.async`` in the cache dtype; in bf16 the scores and
the products run on tensor cores (``mma.sync``, tokens on M, query heads
on N), float32 runs on CUDA cores.  Each block writes fp32 partials (acc,
running max, running sum) to a workspace the wrapper allocates, and a
merge kernel launched by the same C call combines each row's live splits.
The pre-scaled query is rounded to the cache dtype, as the plain version
does.  The bf16 kernel needs ``hd % 16 == 0``, float32 ``hd % 8 == 0``,
both ``hd <= 256``; any ``Hq % Hkv == 0`` is taken.

Each row's live span is ``[lo, hi)`` with ``hi = min(len, L)`` and
``lo = max(0, len - window)`` for a (non-rolling) sliding window, else 0.
A row whose span is empty (``len == 0``, which the engine's decode never
produces) writes zeros in both versions.

:func:`decode_attention` is the wrapper: on a CPU tensor it runs
:func:`decode_attention_plain`; on a CUDA tensor it launches the kernel or
raises.  ``decode_attention.launches`` counts the calls that launched it
(one per call, though a call runs two CUDA kernels).  On DTensors (a
model under a mesh) it runs on each local shard with the batch rows and
the KV heads (and their query heads) as the cache shards them, and the
length and ``hd`` whole.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate, Shard

from .grad import refuse_grad
from .sharded import as_dtensor, is_dtensor, kept, on_shards

__all__ = ["decode_attention", "decode_attention_plain", "live_span"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
#: tokens per split of the kernel's split-KV grid
SPLIT_LEN = 64
_MAX_HD = 256


def live_span(lengths: torch.Tensor, L: int, *, sliding_window: int = 0,
              rolling: bool = False):
    """Per-row attended cache positions ``[lo, hi)`` as (B,) int64."""
    lens = lengths.long()
    hi = lens.clamp(0, L)
    if rolling or not sliding_window:
        lo = torch.zeros_like(hi)
    else:
        lo = (lens - sliding_window).clamp(min=0)
    return lo, hi


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           sliding_window: int = 0, rolling: bool = False):
    """Plain PyTorch version of the kernel and the port's CPU path.

    q: (B, Hq, hd); k_cache, v_cache: (B, L, Hkv, hd); lengths: (B,) —
    tokens so far *including* the new one (whose KV is already written).
    ``rolling`` marks a ring-buffer cache: every slot is valid once
    ``lengths >= L``.  Otherwise positions ``< lengths`` are attended,
    limited to the last ``sliding_window`` when one is set.  The
    pre-scaled query and the probabilities are rounded to the cache dtype
    before fp32-accumulated products, as in the reference."""
    b, hq, hd = q.shape
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / torch.sqrt(torch.full((), float(hd), device=q.device))
    qf = (q.reshape(b, hkv, g, hd).float() * scale).to(k_cache.dtype)
    s = torch.einsum("bhgd,blhd->bhgl", qf.float(), k_cache.float())
    lo, hi = live_span(lengths.to(q.device), L,
                       sliding_window=sliding_window, rolling=rolling)
    pos = torch.arange(L, device=q.device)[None, :]
    mask = (pos >= lo[:, None]) & (pos < hi[:, None])
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgl,blhd->bhgd", p.float(), v_cache.float())
    out = out.reshape(b, hq, hd).to(q.dtype)
    live = (hi > lo)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out))


def _lib():
    from .build import load
    lib = load("decode_attention.cu")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     sliding_window: int = 0,
                     rolling: bool = False) -> torch.Tensor:
    """q: (B, Hq, hd); k_cache/v_cache: (B, L, Hkv, hd) in q's dtype;
    lengths: (B,) int32.  Returns (B, Hq, hd) in q's dtype."""
    if is_dtensor(q) or is_dtensor(k_cache):
        return _on_shards(q, k_cache, v_cache, lengths, sliding_window,
                          rolling)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      sliding_window=sliding_window,
                                      rolling=rolling)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    refuse_grad("decode_attention", q, k_cache, v_cache)
    B, Hq, hd = q.shape
    Bk, L, Hkv, hd_k = k_cache.shape
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes matching "
                        f"float32/bfloat16 q and caches, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if v_cache.shape != k_cache.shape or hd_k != hd or Bk != B:
        raise ValueError(f"decode_attention: cache shape "
                         f"{tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    hd_mult = 16 if q.dtype == torch.bfloat16 else 8
    if Hkv == 0 or Hq % Hkv or hd % hd_mult or hd > _MAX_HD:
        raise ValueError(f"decode_attention kernel needs Hq % Hkv == 0 and "
                         f"hd % {hd_mult} == 0, hd <= {_MAX_HD} for {q.dtype}"
                         f" (Hq={Hq}, Hkv={Hkv}, hd={hd})")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("decode_attention: lengths must be (B,) int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"on {q.device}")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 \
            or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: q and the caches must be "
                         "16-byte aligned")
    out = _launch(q, k_cache, v_cache, lengths, sliding_window, rolling)
    if B:
        decode_attention.launches += 1
    return out


def _launch(q, k_cache, v_cache, lengths, sliding_window=0, rolling=False,
            *, merge: bool = True) -> torch.Tensor:
    """One C call on checked inputs: the split pass and, with ``merge``,
    the merge kernel into the returned output (without it, the split pass
    alone, for timing)."""
    B, Hq, hd = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    nsplit = max(1, -(-L // SPLIT_LEN))
    part = torch.empty(B * nsplit * Hq * (hd + 2), dtype=torch.float32,
                       device=q.device)
    rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), part.data_ptr(), out.data_ptr(), B, Hq,
                Hkv, hd, L, int(sliding_window), int(bool(rolling)),
                SPLIT_LEN, nsplit, _DTYPES[q.dtype], int(merge),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def _on_shards(q, k_cache, v_cache, lengths, sliding_window, rolling):
    mesh = (q if is_dtensor(q) else k_cache).device_mesh
    q, k_cache, v_cache, lengths = (as_dtensor(t, mesh) for t in
                                    (q, k_cache, v_cache, lengths))
    kv = kept(k_cache, {0: 0, 2: 2})
    qp = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
               else Replicate() for p in kv)
    lp = tuple(p if p == Shard(0) else Replicate() for p in kv)
    return on_shards(
        lambda a, b, c, d: decode_attention(
            a, b, c, d, sliding_window=sliding_window, rolling=rolling),
        (q, k_cache, v_cache, lengths), (qp, kv, kv, lp), qp, mesh)


decode_attention.launches = 0
