"""Attention as plain PyTorch: causal prefill, the blocked causal
attention that training differentiates, mid-prefill chunk attention,
non-causal cross attention, and cached one-token decode with ragged
lengths.

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

Training (``transformer.loss_fn``) attends through
:func:`blocked_causal_attention`, the reference's blocked causal
attention with its hand-written backward (``repro/models/attention.py``
``_flash_fwd_scan`` / ``_flash_attend`` / ``_flash_bwd`` /
``_attend_q_chunk``): a Python loop over query chunks, each an
online-softmax pass over the key chunks up to its causal frontier, as a
``torch.autograd.Function`` whose backward recomputes every (query chunk
x key chunk) tile from the saved log-sum-exp instead of keeping it, so
memory stays bounded by a tile in both directions.  It is the
reference's jnp code, not a Pallas kernel, so plain PyTorch is its port;
its roundings are the reference's (the pre-scaled query rounded to K's
dtype in the forward, the backward in float32), which
``scaled_dot_product_attention`` does not give.

Under a mesh, :func:`decode_attention_lsharded` is the reference's
distributed flash-decode over a cache sharded along its length: plain
products on each shard and three all-reduces over the model axis, as the
reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.sharded import is_dtensor

__all__ = ["causal_attention", "blocked_causal_attention", "chunk_attention",
           "cross_attention", "decode_attention",
           "decode_attention_lsharded"]

_NEG = -1e30


def _scale(hd: int, device) -> torch.Tensor:
    # a fill on the device, not a copy from the host (the captured decode
    # cannot hold one)
    return 1.0 / torch.sqrt(torch.full((), float(hd), device=device))


def _group_q(q, n_kv: int):
    """(B, Sq, Hq, hd) -> (B, Sq, Hkv, G, hd)."""
    b, s, hq, hd = q.shape
    assert hq % n_kv == 0, (hq, n_kv)
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _attend_on_shards(fn, q, k, v, lengths, **kw):
    """``fn`` (a prefill attention) on DTensors, on each rank's shards:
    the batch rows and the query heads as q shards them, K/V's heads cut
    the same way where they divide, else whole on every rank and each
    local query head given its own KV head (a (Hkv, G) split of sharded
    query heads has no DTensor layout; each score is the same product of
    the same two rows); the sequence and ``hd`` whole."""
    from torch.distributed.tensor import Replicate, Shard

    from ..kernels.sharded import as_dtensor, kept, on_shards
    mesh = q.device_mesh
    q, k, v, lengths = (as_dtensor(t, mesh) for t in (q, k, v, lengths))
    hq, hkv = q.shape[2], k.shape[2]
    qp = kept(q, {0: 0, 2: 2})
    cut = [i for i, p in enumerate(qp) if p == Shard(2)]
    n_cut = 1
    for i in cut:
        n_cut *= mesh.size(i)
    kv_cut = hkv % n_cut == 0
    kvp = tuple(p if p == Shard(0) or (p == Shard(2) and kv_cut)
                else Replicate() for p in qp)

    def local(ql, kl, vl, *ll):
        if not kv_cut:
            size, h0 = hq, 0
            for i in cut:
                size //= mesh.size(i)
                h0 += mesh.get_local_rank(i) * size
            idx = (h0 + torch.arange(ql.shape[2], device=ql.device)) \
                // (hq // hkv)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl, lengths=ll[0] if ll else None, **kw)

    args, pls = (q, k, v), (qp, kvp, kvp)
    if lengths is not None:
        args += (lengths,)
        pls += (tuple(p if p == Shard(0) else Replicate() for p in qp),)
    return on_shards(local, args, pls, qp, mesh)


def causal_attention(q, k, v, *, q_offset: int = 0, sliding_window: int = 0,
                     lengths: Optional[torch.Tensor] = None):
    """Causal self-attention.  q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd);
    q_offset: absolute position of q[0]; lengths: (B,) valid kv lengths.

    Masks as the reference's flash scan does: causal (and window) masked
    scores are set to -1e30, then an additive -1e30 bias carries the
    ragged ``lengths``.  The pre-scaled query and the probabilities are
    rounded to the K/V dtype before the fp32-accumulated products, as in
    the reference.  Returns (B, Sq, Hq, hd) in q's dtype.  On DTensors it
    runs on each rank's shards (:func:`_attend_on_shards`)."""
    if is_dtensor(q):
        return _attend_on_shards(causal_attention, q, k, v, lengths,
                                 q_offset=q_offset,
                                 sliding_window=sliding_window)
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


def _tile_mask(q_pos, kv_pos, skv_valid: int, sliding_window: int):
    """The causal (and window) and padding mask of one tile: q_pos (Sqc,),
    kv_pos (C,) -> (Sqc, C) bool."""
    mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :]
                                                  < skv_valid)
    if sliding_window:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
    return mask


def _flash_fwd_scan(qf, k, v, bias, q_pos0: int, sliding_window: int,
                    kv_chunk: int, n_kv: int, skv_valid: int):
    """Forward online-softmax pass of one query chunk over ``n_kv`` key
    chunks; returns (out (B, Hkv, G, Sqc, hd) fp32, L the log-sum-exp
    (B, Hkv, G, Sqc)).  The scores take the query rounded to K's dtype and
    P rounded to V's dtype, with float32 products, as the reference's
    ``preferred_element_type`` einsums."""
    b, sqc, hkv, g, hd = qf.shape
    dev = qf.device
    qk = qf.to(k.dtype).float()
    q_pos = q_pos0 + torch.arange(sqc, device=dev)
    m = torch.full((b, hkv, g, sqc), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sqc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sqc, hd), dtype=torch.float32, device=dev)
    for ci in range(n_kv):
        start = ci * kv_chunk
        kc = k[:, start:start + kv_chunk]
        vc = v[:, start:start + kv_chunk]
        bc = bias[:, start:start + kv_chunk]
        s = torch.einsum("bqhgd,bchd->bhgqc", qk, kc.float())
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = _tile_mask(q_pos, kv_pos, skv_valid, sliding_window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        s = s + bc[:, None, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    L = m + torch.log(l.clamp_min(1e-30))
    return out, L


def _flash_bwd(q_pos0: int, sliding_window: int, kv_chunk: int, n_kv: int,
               skv_valid: int, res, g_out):
    """The backward of one query chunk, every tile recomputed in float32
    from the saved log-sum-exp: returns (dq fp32, dk, dv in K's and V's
    dtypes)."""
    qf, k, v, bias, out, L = res
    sqc = qf.shape[1]
    dev = qf.device
    dout = g_out.float().permute(0, 2, 3, 1, 4)        # (B,Hkv,G,Sqc,hd)
    D = (dout * out).sum(dim=-1)                        # (B,Hkv,G,Sqc)
    q_pos = q_pos0 + torch.arange(sqc, device=dev)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for ci in range(n_kv):
        start = ci * kv_chunk
        kc = k[:, start:start + kv_chunk].float()
        vc = v[:, start:start + kv_chunk].float()
        bc = bias[:, start:start + kv_chunk]
        s = torch.einsum("bqhgd,bchd->bhgqc", qf, kc)
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = _tile_mask(q_pos, kv_pos, skv_valid, sliding_window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        s = s + bc[:, None, None, None, :]
        p = torch.exp(s - L[..., None])                 # (B,Hkv,G,Sqc,C)
        dp = torch.einsum("bhgqd,bchd->bhgqc", dout, vc)
        ds = p * (dp - D[..., None])
        dq = dq + torch.einsum("bhgqc,bchd->bqhgd", ds, kc)
        dks.append(torch.einsum("bhgqc,bqhgd->bchd", ds, qf))
        dvs.append(torch.einsum("bhgqc,bhgqd->bchd", p, dout))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttend(torch.autograd.Function):
    """Flash attention for one query chunk (fp32 ``qf`` pre-scaled), the
    reference's ``_flash_attend`` custom VJP: the forward saves the chunk's
    output and log-sum-exp, the backward recomputes each (Sqc x C) tile
    instead of differentiating through the saved scan.  bias: (B,
    Skv_pad) additive fp32 (0 / -1e30), which carries ragged lengths.
    Returns (B, Sqc, Hkv, G, hd) fp32."""

    @staticmethod
    def forward(ctx, qf, k, v, bias, q_pos0, sliding_window, kv_chunk,
                n_kv, skv_valid):
        args = (q_pos0, sliding_window, kv_chunk, n_kv, skv_valid)
        out, L = _flash_fwd_scan(qf, k, v, bias, *args)
        ctx.save_for_backward(qf, k, v, bias, out, L)
        ctx.args = args
        return out.permute(0, 3, 1, 2, 4)

    @staticmethod
    def backward(ctx, g_out):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, g_out)
        return (dq, dk, dv) + (None,) * 6


def _attend_q_chunk(qf, k, v, *, q_pos0: int, skv_valid: int,
                    sliding_window: int, kv_chunk: int,
                    lengths: Optional[torch.Tensor], n_kv: int):
    """Online-softmax attention of one query chunk against k[:, :n_kv*C].
    qf: (B, Sq_c, Hkv, G, hd) pre-scaled fp32; k/v padded to kv_chunk
    multiples.  Returns fp32 (B, Sq_c, Hkv, G, hd)."""
    b, skv_pad = qf.shape[0], k.shape[1]
    if lengths is not None:
        pos = torch.arange(skv_pad, device=qf.device)
        bias = torch.where(pos[None, :] < lengths.long()[:, None], 0.0,
                           _NEG).float()
    else:
        bias = torch.zeros((b, skv_pad), dtype=torch.float32,
                           device=qf.device)
    return _FlashAttend.apply(qf, k, v, bias, q_pos0, sliding_window,
                              kv_chunk, n_kv, skv_valid)


def blocked_causal_attention(q, k, v, *, q_offset: int = 0,
                             sliding_window: int = 0, kv_chunk: int = 512,
                             q_chunk: int = 512,
                             lengths: Optional[torch.Tensor] = None):
    """Two-level blocked causal self-attention with online softmax, the
    reference's ``causal_attention`` with its backward (see the module
    docstring).  q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv ==
    0.  Query chunks are a Python loop so each chunk's key scan stops at
    the causal frontier; at most 16 of them (longer sequences take wider
    chunks).  Peak score tile: (B, Hkv, G, q_chunk, kv_chunk).
    q_offset: absolute position of q[0]; lengths: (B,) valid kv lengths.
    Returns (B, Sq, Hq, hd) in q's dtype.  On DTensors it runs on each
    rank's shards (:func:`_attend_on_shards`), the Function's gradients
    coming back with the inputs' placements."""
    if is_dtensor(q):
        return _attend_on_shards(blocked_causal_attention, q, k, v, lengths,
                                 q_offset=q_offset,
                                 sliding_window=sliding_window,
                                 kv_chunk=kv_chunk, q_chunk=q_chunk)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, skv)
    if max(1, sq // q_chunk) > 16:
        q_chunk = sq // 16
    q_chunk = min(q_chunk, sq)
    pad_kv = (-skv) % kv_chunk
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    qf = _group_q(q, hkv).float() * _scale(hd, q.device)
    outs = []
    for start in range(0, sq, q_chunk):
        stop = min(start + q_chunk, sq)
        # causal frontier: this chunk never reads past q_offset + stop
        lo = 0
        if sliding_window:
            lo = max(0, (q_offset + start - sliding_window + 1)
                     // kv_chunk * kv_chunk)
        hi_tok = min(q_offset + stop, skv)
        n_kv = max(1, -(-(hi_tok - lo) // kv_chunk))
        outs.append(_attend_q_chunk(
            qf[:, start:stop], k[:, lo:lo + n_kv * kv_chunk],
            v[:, lo:lo + n_kv * kv_chunk], q_pos0=q_offset + start - lo,
            skv_valid=skv - lo, sliding_window=sliding_window,
            kv_chunk=kv_chunk,
            lengths=None if lengths is None else lengths - lo, n_kv=n_kv))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
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
    additive bias.  Returns (B, Sq, Hq, hd) in q's dtype.  On DTensors it
    runs on each rank's shards (:func:`_attend_on_shards`)."""
    if is_dtensor(q):
        return _attend_on_shards(cross_attention, q, k, v, lengths)
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


def decode_attention_lsharded(q, k_cache, v_cache, lengths, *, mesh,
                              batch_axes=("data",), model_axis="model"):
    """Distributed flash-decode: KV cache sharded along the LENGTH axis.

    Each model shard attends q (replicated, tiny) against its local KV
    slice at its offset ``rank * L / M``, and the partial (m, l, acc)
    statistics are merged with an online-softmax combine: a max
    all-reduce of m, then sum all-reduces of the rescaled l and of the
    (B, Hq, hd) accumulator over the ``model_axis`` sub-mesh, instead of
    regathering the cache.  q: (B, Hq, hd); k_cache/v_cache: (B, L, Hkv,
    hd), L divisible by the model axis; lengths: (B,).  DTensors are
    redistributed to that layout (batch over ``batch_axes``); a plain
    tensor counts as the same on every rank.  Returns (B, Hq, hd),
    replicated over the model axis."""
    from torch.distributed import _functional_collectives as funcol

    from ..kernels.sharded import as_dtensor, on_shards
    from ..launch.mesh import NamedSharding, mesh_shape

    b_spec = tuple(batch_axes) if batch_axes else None
    L = k_cache.shape[1]
    msize = mesh_shape(mesh)[model_axis]
    assert L % msize == 0, (L, msize)
    l_loc = L // msize
    group = mesh.get_group(model_axis)

    def local_fn(q, k, v, lengths):
        # q: (B, Hq, hd) replicated over model; k/v: (B, L_loc, Hkv, hd)
        b, hq, hd = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        offset = mesh.get_local_rank(model_axis) * l_loc
        qf = (q.reshape(b, hkv, g, hd).float()
              * _scale(hd, q.device)).to(k.dtype)
        s = torch.einsum("bhgd,blhd->bhgl", qf.float(), k.float())
        pos = offset + torch.arange(l_loc, device=q.device)[None, :]
        mask = pos < lengths.long()[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
        m = s.amax(dim=-1)                                 # (B,Hkv,G)
        p = torch.exp(s - m[..., None])
        l_sum = p.sum(dim=-1)
        acc = torch.einsum("bhgl,blhd->bhgd", p.to(v.dtype).float(),
                           v.float())
        # online-softmax merge across shards (tiny collectives)
        m_all = funcol.all_reduce(m, "max", group)
        alpha = torch.exp((m - m_all).clamp(-60.0, 0.0))
        l_tot = funcol.all_reduce(l_sum * alpha, "sum", group)
        acc_tot = funcol.all_reduce(acc * alpha[..., None], "sum", group)
        out = acc_tot / l_tot.clamp_min(1e-30)[..., None]
        return out.reshape(b, hq, hd).to(q.dtype)

    def pl(*spec):
        return NamedSharding(mesh, spec).placements

    qp = pl(b_spec, None, None)
    kvp = pl(b_spec, model_axis, None, None)
    q, k_cache, v_cache, lengths = (as_dtensor(t, mesh) for t in
                                    (q, k_cache, v_cache, lengths))
    return on_shards(local_fn, (q, k_cache, v_cache, lengths),
                     (qp, kvp, kvp, pl(b_spec)), qp, mesh)
