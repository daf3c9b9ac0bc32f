"""Attention as plain PyTorch: causal prefill, mid-prefill chunk
attention, non-causal cross attention, and cached one-token decode with
ragged lengths.

All paths are GQA-native: queries are shaped (B, S, Hkv, G, hd) inside
the einsums so K/V are never expanded to Hq width.  The reference runs
prefill as a blocked online-softmax scan in jnp (no Pallas kernel, so
there is nothing to port as a kernel); here prefill is a direct fp32
masked softmax with the same masks, which is exact in arithmetic but not
in rounding order.  One-token decode has kernels: over the paged pool
(:mod:`repro_torch.kernels.paged_attention`) and over a contiguous cache
(:func:`decode_attention`, which runs
:mod:`repro_torch.kernels.decode_attention` — the Hopper kernel on a CUDA
tensor, its plain version on a CPU tensor; the ``"gather"`` paged path
reuses it on a gathered view).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops

__all__ = ["causal_attention", "chunk_attention", "cross_attention",
           "decode_attention"]

_NEG = -1e30


def _scale(hd: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(hd), device=device))


def _group_q(q, n_kv: int):
    """(B, Sq, Hq, hd) -> (B, Sq, Hkv, G, hd)."""
    b, s, hq, hd = q.shape
    assert hq % n_kv == 0, (hq, n_kv)
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def causal_attention(q, k, v, *, q_offset: int = 0, sliding_window: int = 0,
                     lengths: Optional[torch.Tensor] = None):
    """Causal self-attention.  q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd);
    q_offset: absolute position of q[0]; lengths: (B,) valid kv lengths.

    Masks as the reference's flash scan does: causal (and window) masked
    scores are set to -1e30, then an additive -1e30 bias carries the
    ragged ``lengths``.  The pre-scaled query and the probabilities are
    rounded to the K/V dtype before the fp32-accumulated products, as in
    the reference.  Returns (B, Sq, Hq, hd) in q's dtype."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = (_group_q(q, hkv).float() * _scale(hd, q.device)).to(k.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf.float(), k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = kv_pos <= q_pos
    if sliding_window:
        mask = mask & (kv_pos > q_pos - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    if lengths is not None:
        bias = torch.where(kv_pos < lengths.long()[:, None], 0.0, _NEG)
        s = s + bias[:, None, None, None, :].float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def chunk_attention(q, k_cache, v_cache, *, q_pos, kv_len):
    """Mid-prefill chunk attention with per-row query offsets.

    q: (B, C, Hq, hd) — the chunk's queries, right-padded per row;
    k_cache, v_cache: (B, L, Hkv, hd) — the full per-row buffers, with
    this chunk's KV already written; q_pos: (B, C) absolute query
    positions; kv_len: (B,) valid cache length including this chunk.
    Padded query columns produce garbage rows the caller drops."""
    b, c, hq, hd = q.shape
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = _group_q(q, hkv).float() * _scale(hd, q.device)
    s = torch.einsum("bqhgd,blhd->bhgql", qf, k_cache.float())
    kv_pos = torch.arange(L, device=q.device)
    mask = ((kv_pos[None, None, :] <= q_pos.long()[:, :, None])
            & (kv_pos[None, None, :] < kv_len.long()[:, None, None]))
    s = torch.where(mask[:, None, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgql,blhd->bhgqd", p, v_cache.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, c, hq, hd)
    return out.to(q.dtype)


def cross_attention(q, k, v, *, lengths: Optional[torch.Tensor] = None):
    """Non-causal attention over a fixed encoder sequence (the audio
    family's encoder self-attention and the decoder's cross attention).

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); lengths: (B,) valid
    encoder positions, or None for all.  Unlike the causal and decode
    paths, the reference keeps the pre-scaled query, the scores and the
    probabilities in float32 here, and masks with ``where`` rather than an
    additive bias.  Returns (B, Sq, Hq, hd) in q's dtype."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = _group_q(q, hkv).float() * _scale(hd, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if lengths is not None:
        mask = (torch.arange(skv, device=q.device)[None, :]
                < lengths.long()[:, None])
        s = s.masked_fill(~mask[:, None, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     sliding_window: int = 0, rolling: bool = False):
    """One-token attention against a contiguous KV cache.

    q: (B, Hq, hd); k_cache, v_cache: (B, L, Hkv, hd); lengths: (B,) int32
    — tokens so far *including* the new one (whose KV is already written).
    ``rolling=True`` marks a ring-buffer cache (sliding-window archs): all
    L slots are valid once lengths >= L, and positional correctness comes
    from RoPE applied at write time.  Otherwise positions ``< lengths``
    are attended, the last ``sliding_window`` of them when one is set.
    The pre-scaled query and the probabilities are rounded to the cache
    dtype before fp32-accumulated products, as in the reference."""
    return ops.decode_attention(q, k_cache, v_cache, lengths,
                                sliding_window=sliding_window,
                                rolling=rolling)
