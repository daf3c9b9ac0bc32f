"""Paged one-token GQA decode attention.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:
paged_decode_attention_pallas``.  On an H100 the kernel
(``csrc/paged_attention.cu``) is bound by memory bytes: it must read each
live K/V row once, and its arithmetic is far below the card's
flops-per-byte ratio.  Its design: one block per (row, KV head), the G
query heads of that KV head pre-scaled in shared memory, a walk over only
the ``ceil(len / block_size)`` live entries of the row's block table
(the Pallas grid visits all ``max_blocks``), K/V tiles staged in shared
memory with 16-byte loads, an fp32 online softmax and fp32 accumulation.

:func:`paged_decode_attention` is the wrapper: on a CPU tensor it runs
:func:`paged_decode_attention_plain`; on a CUDA tensor it launches the
kernel or raises.  ``paged_decode_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                               block_size: int):
    """One-token GQA attention over a paged cache (gather oracle).

    q: (B, Hq, hd); k_pool/v_pool: (n_blocks, block, Hkv, hd) for ONE
    layer; block_tables: (B, max_blocks) int32 (-1 = unallocated, clipped
    for the gather and masked by ``lengths``); lengths: (B,).  A row with
    ``lengths == 0`` is fully masked and averages its gathered V."""
    B, hq, hd = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    max_blocks = block_tables.shape[1]
    L = max_blocks * block_size
    bt = block_tables.long().clamp(0, k_pool.shape[0] - 1)
    k = k_pool[bt].reshape(B, L, hkv, hd).float()
    v = v_pool[bt].reshape(B, L, hkv, hd).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    qf = q.reshape(B, hkv, g, hd).float() * scale
    s = torch.einsum("bhgd,blhd->bhgl", qf, k)
    pos = torch.arange(L, device=q.device)[None, :]
    mask = pos < lengths.to(q.device).long()[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgl,blhd->bhgd", p, v)
    return out.reshape(B, hq, hd).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                 block_size: int):
    """Plain PyTorch version of the kernel: the gather oracle, with rows
    of ``lengths == 0`` (bucket padding the engine discards) set to zero
    as the kernel writes them."""
    out = paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                     lengths, block_size)
    live = (lengths.to(q.device) > 0)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out))


def _lib():
    from .build import load
    lib = load("paged_attention.cu")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           block_size: int) -> torch.Tensor:
    """q: (B, Hq, hd); k_pool/v_pool: (n_blocks, block_size, Hkv, hd) of
    one layer, in q's dtype; block_tables: (B, max_blocks) int32;
    lengths: (B,) int32.  Returns (B, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, block_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, Hq, hd = q.shape
    n_pool, bs, Hkv, hd_k = k_pool.shape
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention kernel takes matching "
                        f"float32/bfloat16 q and pools, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if v_pool.shape != k_pool.shape or hd_k != hd or bs != block_size:
        raise ValueError(f"paged_decode_attention: pool shape "
                         f"{tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} / block_size {block_size}")
    if Hq % Hkv or hd % 8 or (Hq // Hkv) * hd > 2048:
        raise ValueError(f"paged_decode_attention kernel needs Hq % Hkv == 0,"
                         f" hd % 8 == 0 and G * hd <= 2048 (Hq={Hq}, "
                         f"Hkv={Hkv}, hd={hd})")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_tables.shape[0] != B or lengths.shape != (B,):
        raise TypeError("paged_decode_attention: block_tables (B, "
                        "max_blocks) and lengths (B,) must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous on {q.device}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    rc = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, hd, bs, block_tables.shape[1], n_pool,
                _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
