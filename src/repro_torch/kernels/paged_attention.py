"""Paged one-token GQA decode attention.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py:
paged_decode_attention_pallas``.  On an H100 the kernel
(``csrc/paged_attention.cu`` over the split-KV design shared with the
contiguous kernel in ``csrc/decode_attention_common.cuh``) is bound by
memory bytes: it must read each live K/V row once, and its arithmetic is
far below the card's flops-per-byte ratio.  Its design: a row's
``max_blocks * block_size`` positions are cut into splits of whole pool
blocks (64 tokens at block size 16), one block per (split, KV head, group
of 8 query heads, row); a block whose split lies past the row's length
exits at once, and the host never reads ``lengths``.  Each block reads its
table entries, streams the K/V rows they name through a ring of 16-token
stages in shared memory filled by ``cp.async`` in the pool's dtype, and
in bf16 forms the scores and products on tensor cores (``mma.sync``,
tokens on M, query heads on N); float32 runs on CUDA cores.  The 1/sqrt(hd)
scale is applied to the fp32 scores.  In bf16 the kernel rounds each
tile's probabilities to bf16 before the P.V product (the tensor cores'
input), where the plain version and the Pallas kernel keep them in fp32;
the output differs by about one bf16 ulp.  Each block writes fp32 partials to a
workspace the wrapper allocates, and a merge kernel launched by the same C
call combines each row's live splits.  The bf16 kernel needs
``hd % 16 == 0``, float32 ``hd % 8 == 0``, both ``hd <= 256``; any
``Hq % Hkv == 0`` is taken.

:func:`paged_decode_attention` is the wrapper: on a CPU tensor it runs
:func:`paged_decode_attention_plain`; on a CUDA tensor it launches the
kernel or raises.  ``paged_decode_attention.launches`` counts the calls
that launched it (one per call, though a call runs two CUDA kernels).
On DTensors (a model under a mesh) it runs on each local shard with the
pools' KV heads (and their query heads) as the pools shard them, the
query rows, tables and lengths as q shards its batch, and the pools'
blocks and ``hd`` whole.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import Replicate, Shard

from .grad import refuse_grad
from .sharded import as_dtensor, is_dtensor, kept, on_shards

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
_MAX_HD = 256


def split_len(block_size: int) -> int:
    """Tokens per split of the kernel's grid: whole pool blocks and whole
    16-token tiles, at least 64 (64 for block sizes 1, 2, 4, ..., 64)."""
    unit = block_size * 16 // math.gcd(block_size, 16)
    return unit * -(-64 // unit)


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
    scale = 1.0 / torch.sqrt(torch.full((), float(hd)))
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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 \
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
    if is_dtensor(q) or is_dtensor(k_pool):
        return _on_shards(q, k_pool, v_pool, block_tables, lengths,
                          block_size)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, block_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    refuse_grad("paged_decode_attention", q, k_pool, v_pool)
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
    hd_mult = 16 if q.dtype == torch.bfloat16 else 8
    if Hq % Hkv or hd % hd_mult or hd > _MAX_HD:
        raise ValueError(f"paged_decode_attention kernel needs Hq % Hkv == 0"
                         f" and hd % {hd_mult} == 0, hd <= {_MAX_HD} for "
                         f"{q.dtype} (Hq={Hq}, Hkv={Hkv}, hd={hd})")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_tables.shape[0] != B or lengths.shape != (B,):
        raise TypeError("paged_decode_attention: block_tables (B, "
                        "max_blocks) and lengths (B,) must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous on {q.device}")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: q and the pools must be "
                         "16-byte aligned")
    out = _launch(q, k_pool, v_pool, block_tables, lengths)
    if B:
        paged_decode_attention.launches += 1
    return out


def _launch(q, k_pool, v_pool, block_tables, lengths, *,
            merge: bool = True) -> torch.Tensor:
    """One C call on checked inputs: the split pass and, with ``merge``,
    the merge kernel into the returned output (without it, the split pass
    alone, for timing)."""
    B, Hq, hd = q.shape
    n_pool, bs, Hkv = k_pool.shape[:3]
    mb = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    S = split_len(bs)
    nsplit = max(1, -(-(mb * bs) // S))
    part = torch.empty(B * nsplit * Hq * (hd + 2), dtype=torch.float32,
                       device=q.device)
    rc = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), part.data_ptr(),
                out.data_ptr(), B, Hq, Hkv, hd, bs, mb, n_pool, S, nsplit,
                _DTYPES[q.dtype], int(merge),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    return out


def _on_shards(q, k_pool, v_pool, block_tables, lengths, block_size):
    mesh = (q if is_dtensor(q) else k_pool).device_mesh
    q, k_pool, v_pool, block_tables, lengths = (
        as_dtensor(t, mesh) for t in (q, k_pool, v_pool, block_tables,
                                      lengths))
    pool = kept(k_pool, {2: 2})
    rows = kept(q, {0: 0})
    qp = tuple(Shard(1) if p == Shard(2) else r
               for p, r in zip(pool, rows))
    bp = tuple(p if p == Shard(0) else Replicate() for p in qp)
    return on_shards(
        lambda a, b, c, d, e: paged_decode_attention(
            a, b, c, d, e, block_size=block_size),
        (q, k_pool, v_pool, block_tables, lengths),
        (qp, pool, pool, bp, bp), qp, mesh)


paged_decode_attention.launches = 0
