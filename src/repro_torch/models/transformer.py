"""Model assembly for the dense decoder family: parameter init, prefill,
chunked prefill, and paged decode.

Parameters keep the reference's stacked per-layer layout: ``params
["blocks"]`` holds every layer's weights on a leading axis, and the layer
loop slices it (the reference scans it).  Only the dense family is ported
in this slice; every other family raises ``NotImplementedError`` naming
its ROADMAP item.

The paged entry points update the KV pools IN PLACE (the reference
donates them to the jitted call and rebinds the returned buffers).  The
reference relies on JAX dropping out-of-bounds scatter writes (padding
rows and columns carry ``block == n_blocks``); PyTorch raises on such an
index, so the writes are masked out first — never clamped, which would
land in a live block.  Gathers through block tables are clipped, as the
reference clips them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import attention as attn_lib
from .layers import (
    apply_rope,
    dense_init,
    embed_init,
    linear,
    make_rope,
    norm_init,
    rms_norm,
    swiglu,
)

__all__ = ["init_params", "init_cache", "layer_pattern",
           "supports_paged_stack", "prefill_fn", "chunk_prefill_fn",
           "paged_decode_fn", "paged_chunk_prefill_fn", "resolve_device",
           "torch_dtype"]

_TODO = {
    "moe": "ROADMAP Queue A item 10 (remaining model families: MoE)",
    "vlm": "ROADMAP Queue A item 10 (remaining model families: vlm)",
    "audio": "ROADMAP Queue A item 10 (remaining model families: audio)",
    "ssm": "ROADMAP Queue A item 10 (remaining model families: ssm, "
           "kernel K5)",
    "hybrid": "ROADMAP Queue A item 10 (remaining model families: hybrid, "
              "kernel K5)",
}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for something else; a request for
    CUDA without a card raises instead of running on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]


def _require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family is not ported yet — "
            f"{_TODO.get(cfg.family, 'ROADMAP Queue A item 10')}")


# ==========================================================================
# Parameter initialization
# ==========================================================================

def layer_pattern(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """The decoder stack as homogeneous groups (group, kind, n_blocks)."""
    _require_dense(cfg, "layer_pattern")
    return [("blocks", "attn", cfg.n_layers)]


def _stacked(n: int, shape, *, gen, device, dtype, scale=None):
    """n layers of one dense weight, drawn layer by layer so the float32
    draw never holds more than one layer."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = dense_init(shape, generator=gen, device=device,
                            scale=scale, dtype=dtype)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from the port's own ``torch.Generator`` (never
    compared bit for bit with the reference's init; the tests carry the
    reference's weights over with :mod:`repro_torch.models.bridge`)."""
    _require_dense(cfg, "init_params")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    n = cfg.n_layers
    kw = dict(gen=gen, device=dev, dtype=dtype)
    attn = {
        "wq": _stacked(n, (d, hq, hd), **kw),
        "wk": _stacked(n, (d, hkv, hd), **kw),
        "wv": _stacked(n, (d, hkv, hd), **kw),
        "wo": _stacked(n, (hq, hd, d), scale=1.0 / (hq * hd) ** 0.5, **kw),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, hq, hd), dtype=dtype, device=dev)
        attn["bk"] = torch.zeros((n, hkv, hd), dtype=dtype, device=dev)
        attn["bv"] = torch.zeros((n, hkv, hd), dtype=dtype, device=dev)
    ffn = {"w_in": _stacked(n, (d, f), **kw),
           "w_out": _stacked(n, (f, d), **kw)}
    if cfg.mlp_variant == "swiglu":
        ffn["w_gate"] = _stacked(n, (d, f), **kw)
    params = {
        "embed": embed_init(cfg.vocab_size, d, generator=gen, device=dev,
                            dtype=dtype),
        "final_norm": norm_init(d, device=dev),
        "blocks": {
            "norm1": norm_init(d, device=dev).repeat(n, 1),
            "attn": attn,
            "norm2": norm_init(d, device=dev).repeat(n, 1),
            "ffn": ffn,
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab_size), generator=gen,
                                       device=dev, dtype=dtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> dict:
    """Contiguous decode cache: k/v (layers, batch, max_len, Hkv, hd)."""
    _require_dense(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    z = torch.zeros((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd),
                    dtype=dtype, device=dev)
    return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "blocks": {"k": z, "v": z.clone()}}


# ==========================================================================
# Blocks
# ==========================================================================

def _layer(params, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters (views, no copies)."""
    def sl(t):
        return {k: sl(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return sl(params["blocks"])


def _mlp_forward(cfg: ModelConfig, p, x):
    if cfg.mlp_variant == "swiglu":
        return swiglu(x, p["w_in"], p["w_gate"], p["w_out"])
    return linear(F.gelu(linear(x, p["w_in"]), approximate="tanh"),
                  p["w_out"])


def _chunk_qkv(cfg: ModelConfig, p, xx, sin, cos):
    """Pre-attention half of an attn block: norm + q/k/v projection + rope."""
    h = rms_norm(xx, p["norm1"], cfg.norm_eps)
    ap = p["attn"]
    q = apply_rope(linear(h, ap["wq"], ap.get("bq")), sin, cos)
    k = apply_rope(linear(h, ap["wk"], ap.get("bk")), sin, cos)
    v = linear(h, ap["wv"], ap.get("bv"))
    return q, k, v


def _chunk_finish(cfg: ModelConfig, p, xx, o):
    """Post-attention half: output projection + FFN residual."""
    ap = p["attn"]
    xx = xx + linear(o.reshape(o.shape[:-2] + (-1,)),
                     ap["wo"].reshape(-1, cfg.d_model))
    h2 = rms_norm(xx, p["norm2"], cfg.norm_eps)
    return xx + _mlp_forward(cfg, p["ffn"], h2)


def _lm_logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return linear(x, params["lm_head"])


def _last(x, lens, S):
    """Hidden state at each row's last valid position: x (n, S, d)."""
    idx = (lens.long() - 1).clamp(0, S - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


# ==========================================================================
# Model-level API
# ==========================================================================

def prefill_fn(cfg: ModelConfig, params, batch, *, max_len: int):
    """Prefill: run the prompt, build the decode cache.

    batch: tokens (B, S), lengths (B,) true prompt lengths; returns
    (last_logits (B, V), cache) with k/v (layers, B, max_len, Hkv, hd)."""
    _require_dense(cfg, "prefill_fn")
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    sin, cos = make_rope(torch.arange(S, device=dev), cfg.hd,
                         cfg.rope_theta)
    sin, cos = sin[None], cos[None]
    cache = init_cache(cfg, B, max_len, device=dev)
    kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _chunk_qkv(cfg, p, x, sin, cos)
        o = attn_lib.causal_attention(q, k, v, lengths=lengths)
        kc[i, :, :S] = k.to(kc.dtype)
        vc[i, :, :S] = v.to(vc.dtype)
        x = _chunk_finish(cfg, p, x, o)
    cache["lengths"] = lengths
    return _lm_logits(cfg, params, _last(x, lengths, S)), cache


def supports_paged_stack(cfg: ModelConfig) -> bool:
    """True iff the decoder is a single homogeneous attention stack whose
    KV cache is pure (k, v) pairs (reference semantics: dense/moe/vlm
    without a sliding window).  Of these the port runs dense so far."""
    return (cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window)


def _require_paged_stack(cfg: ModelConfig, what: str) -> None:
    if not supports_paged_stack(cfg):
        raise ValueError(
            f"{what} supports only attention-family models without a "
            f"sliding window (dense/moe/vlm), got family={cfg.family!r} "
            f"sliding_window={cfg.sliding_window}")
    _require_dense(cfg, what)


def chunk_prefill_fn(cfg: ModelConfig, params, cache, tokens, offsets,
                     chunk_lens):
    """Incremental prefill: run ONE chunk of each row's prompt against its
    (already partially filled) contiguous cache row.

    cache: {"lengths", "blocks": {"k", "v"}} with k/v (layers, n, L, Hkv,
    hd), updated in place; tokens: (n, C) right-padded; offsets: (n,)
    chunk start positions; chunk_lens: (n,) valid tokens (0 marks a
    padding row — its writes are dropped).  Returns (last_logits (n, V),
    cache) with ``lengths = offsets + chunk_lens``."""
    _require_paged_stack(cfg, "chunk_prefill_fn")
    n, C = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.long()]
    posmat = offsets.long()[:, None] + torch.arange(C, device=dev)[None, :]
    sin, cos = make_rope(posmat, cfg.hd, cfg.rope_theta)
    kv_len = offsets.long() + chunk_lens.long()
    kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
    L = kc.shape[2]
    # padding columns (and positions past the row) write nowhere
    valid = (torch.arange(C, device=dev)[None, :] < chunk_lens.long()[:, None]
             ) & (posmat < L)
    rows, cols = valid.nonzero(as_tuple=True)
    wpos = posmat[rows, cols]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _chunk_qkv(cfg, p, x, sin, cos)
        kc[i, rows, wpos] = k[rows, cols].to(kc.dtype)
        vc[i, rows, wpos] = v[rows, cols].to(vc.dtype)
        o = attn_lib.chunk_attention(q, kc[i], vc[i], q_pos=posmat,
                                     kv_len=kv_len)
        x = _chunk_finish(cfg, p, x, o)
    cache["lengths"] = kv_len.to(torch.int32)
    return _lm_logits(cfg, params, _last(x, chunk_lens, C)), cache


def paged_decode_fn(cfg: ModelConfig, params, k_pool, v_pool, tables,
                    lengths, blk, off, tokens, *, block_size: int,
                    attn_impl: str = "kernel"):
    """One decode step over a paged KV cache (vLLM block tables).

    k_pool/v_pool: (layers, n_blocks, block, Hkv, hd), updated in place;
    tables: (n, max_blocks) int32 (-1 = unallocated); lengths: (n,)
    counting the new token; blk/off: (n,) physical (block, offset) of the
    new token's KV (``blk == n_blocks`` marks a write to drop: padding
    rows and frozen KV).  tokens: (n,) int32.

    attn_impl:
      * ``"kernel"`` (default) — :func:`repro_torch.kernels.ops.
        paged_decode_attention`: the Hopper kernel on a CUDA tensor, its
        plain version on a CPU tensor;
      * ``"gather"`` — materialize each row's blocks as a contiguous view
        and reuse :func:`attention.decode_attention` (the reference's
        bit-parity oracle);
      * ``"ref"`` — the standalone gather-softmax oracle.

    Returns (next_tokens (n,) int32 greedy, k_pool, v_pool)."""
    _require_paged_stack(cfg, "paged_decode_fn")
    if attn_impl not in ("kernel", "gather", "ref"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    from ..kernels.ops import paged_decode_attention
    from ..kernels.paged_attention import paged_decode_attention_ref
    n = tokens.shape[0]
    x = params["embed"][tokens.long()[:, None]]
    pos = lengths.long() - 1
    sin, cos = make_rope(pos[:, None], cfg.hd, cfg.rope_theta)
    nb_pool = k_pool.shape[1]
    bt = tables.long().clamp(0, nb_pool - 1)
    L = tables.shape[1] * block_size
    wrows = (blk < nb_pool).nonzero(as_tuple=True)[0]
    wblk, woff = blk[wrows].long(), off[wrows].long()
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        kp, vp = k_pool[i], v_pool[i]
        q, k, v = _chunk_qkv(cfg, p, x, sin, cos)
        kp[wblk, woff] = k[wrows, 0].to(kp.dtype)
        vp[wblk, woff] = v[wrows, 0].to(vp.dtype)
        if attn_impl == "kernel":
            o = paged_decode_attention(q[:, 0].contiguous(), kp, vp, tables,
                                       lengths, block_size=block_size)
        elif attn_impl == "ref":
            o = paged_decode_attention_ref(q[:, 0], kp, vp, tables, lengths,
                                           block_size)
        else:
            kc = kp[bt].reshape(n, L, *kp.shape[2:])
            vc = vp[bt].reshape(n, L, *vp.shape[2:])
            o = attn_lib.decode_attention(q[:, 0], kc, vc, lengths)
        x = _chunk_finish(cfg, p, x, o[:, None])
    logits = _lm_logits(cfg, params, x[:, 0])
    return logits.argmax(-1).to(torch.int32), k_pool, v_pool


def paged_chunk_prefill_fn(cfg: ModelConfig, params, k_pool, v_pool, tables,
                           tokens, offsets, chunk_lens, wblk, woff, *,
                           block_size: int):
    """Chunked prefill over the paged pool: write each chunk's KV into the
    rows' blocks (in place), then attend through a gathered contiguous
    view.  wblk/woff: (n, C) physical (block, offset) of every chunk token
    (``wblk == n_blocks`` marks a dropped write).  Returns (last_logits
    (n, V), k_pool, v_pool)."""
    _require_paged_stack(cfg, "paged_chunk_prefill_fn")
    n, C = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.long()]
    posmat = offsets.long()[:, None] + torch.arange(C, device=dev)[None, :]
    sin, cos = make_rope(posmat, cfg.hd, cfg.rope_theta)
    kv_len = offsets.long() + chunk_lens.long()
    nb_pool = k_pool.shape[1]
    bt = tables.long().clamp(0, nb_pool - 1)
    L = tables.shape[1] * block_size
    rows, cols = (wblk < nb_pool).nonzero(as_tuple=True)
    pblk, poff = wblk[rows, cols].long(), woff[rows, cols].long()
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        kp, vp = k_pool[i], v_pool[i]
        q, k, v = _chunk_qkv(cfg, p, x, sin, cos)
        kp[pblk, poff] = k[rows, cols].to(kp.dtype)
        vp[pblk, poff] = v[rows, cols].to(vp.dtype)
        kc = kp[bt].reshape(n, L, *kp.shape[2:])
        vc = vp[bt].reshape(n, L, *vp.shape[2:])
        o = attn_lib.chunk_attention(q, kc, vc, q_pos=posmat, kv_len=kv_len)
        x = _chunk_finish(cfg, p, x, o)
    return (_lm_logits(cfg, params, _last(x, chunk_lens, C)), k_pool,
            v_pool)
