"""Model assembly: parameter init, prefill, decode, chunked prefill and
paged decode for the dense decoder, the MoE decoder (the dense stack with
a top-k routed expert FFN, :mod:`repro_torch.models.moe`) and the
recurrent families (ssm: xLSTM's mLSTM/sLSTM stack; hybrid: Zamba2's
Mamba2 stack with one shared attention block).

Parameters keep the reference's stacked per-group layout: each group of
:func:`layer_pattern` holds its blocks' weights on a leading axis and the
layer loop slices it (the reference scans it); zamba2's shared attention
block is one unstacked ``params["shared_attn"]`` applied after every group
of Mamba2 blocks, each application with its own cache (``shared0`` ...).
The vlm and audio families raise ``NotImplementedError`` naming their
ROADMAP item.

Every block hands its residual branch's output to the next norm instead
of adding it itself: a block takes ``(x, r)`` and returns ``(x', r')``,
and the norm that reads ``x + r`` adds it in the same kernel launch
(:func:`layers.add_rms_norm`), the last pending branch in the final norm.
The sums are the reference's, computed in the same dtype.

Caches update IN PLACE (the reference donates them to its jitted calls
and rebinds the returned buffers): :func:`decode_fn` writes the new KV and
the new recurrent states into the cache it is given; the paged entry
points write into the pools.  The reference relies on JAX dropping
out-of-bounds scatter writes (padding rows and columns carry ``block ==
n_blocks``; in full-batch slot decode an idle slot's length grows past
``max_seq_len``); PyTorch raises on such an index, so those writes are
masked out first — never clamped into a live position.  Gathers through
block tables are clipped, as the reference clips them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import ssm as ssm_lib
from .layers import (
    add_rms_norm,
    apply_rope,
    dense_init,
    embed_init,
    linear,
    make_rope,
    norm_init,
    rms_norm,
    swiglu,
)
from .moe import moe_ffn

__all__ = ["init_params", "init_cache", "layer_pattern",
           "supports_paged_stack", "prefill_fn", "decode_fn",
           "chunk_prefill_fn", "paged_decode_fn", "paged_chunk_prefill_fn",
           "resolve_device", "torch_dtype"]

_PORTED = ("dense", "moe", "ssm", "hybrid")
_TODO = {
    "vlm": "ROADMAP Queue A item 10 (remaining model families: vlm)",
    "audio": "ROADMAP Queue A item 10 (remaining model families: audio)",
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


def _require_ported(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family is not ported yet — "
            f"{_TODO.get(cfg.family, 'ROADMAP Queue A item 10')}")


# ==========================================================================
# Parameter initialization
# ==========================================================================

def layer_pattern(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """The decoder stack as homogeneous groups (group, kind, n_blocks)."""
    _require_ported(cfg, "layer_pattern")
    if cfg.family in ("dense", "moe"):
        return [("blocks", "attn", cfg.n_layers)]
    if cfg.family == "ssm":
        # xLSTM [7:1]: every cfg.slstm_every-th block is sLSTM
        out = []
        run = 0
        gi = 0
        for i in range(cfg.n_layers):
            if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0:
                if run:
                    out.append((f"m{gi}", "mlstm", run))
                out.append((f"s{gi}", "slstm", 1))
                run = 0
                gi += 1
            else:
                run += 1
        if run:
            out.append((f"m{gi}", "mlstm", run))
        return out
    # hybrid (Zamba2): groups of attn_every mamba blocks + 1 *shared* attn
    n_groups = cfg.n_layers // (cfg.attn_every + 1)
    rest = cfg.n_layers - n_groups * (cfg.attn_every + 1)
    out = []
    for gi in range(n_groups):
        out.append((f"m{gi}", "mamba", cfg.attn_every))
        out.append((f"shared{gi}", "shared_attn", 1))
    if rest:
        out.append(("m_tail", "mamba", rest))
    return out


def _stacked(n: int, shape, *, gen, device, dtype, scale=None):
    """n layers of one dense weight, drawn layer by layer so the float32
    draw never holds more than one layer."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = dense_init(shape, generator=gen, device=device,
                            scale=scale, dtype=dtype)
    return out


def _normal(n: int, shape, scale: float, *, gen, device, dtype):
    """n layers of ``scale * N(0, 1)``, drawn in float32."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = (scale * torch.randn(shape, generator=gen, device=device,
                                      dtype=torch.float32)).to(dtype)
    return out


def _ones(n: int, dim: int, device) -> torch.Tensor:
    return norm_init(dim, device=device).repeat(n, 1)


def _attn_block_init(cfg: ModelConfig, n: int, kw) -> dict:
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    dev, dtype = kw["device"], kw["dtype"]
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
    if cfg.is_moe:
        ffn = _moe_init(cfg, n, kw)
    else:
        ffn = {"w_in": _stacked(n, (d, f), **kw),
               "w_out": _stacked(n, (f, d), **kw)}
        if cfg.mlp_variant == "swiglu":
            ffn["w_gate"] = _stacked(n, (d, f), **kw)
    return {"norm1": _ones(n, d, dev), "attn": attn,
            "norm2": _ones(n, d, dev), "ffn": ffn}


def _moe_init(cfg: ModelConfig, n: int, kw) -> dict:
    """The reference's expert FFN tree: a float32 router (d, E) and the
    experts' SwiGLU weights w1/w3 (E, d, f) and w2 (E, f, d), w2 at scale
    1/sqrt(f).  Each leaf is allocated once and filled a layer at a time:
    a full-size stacked expert leaf is 19.3 GB in bf16 for
    qwen3-moe-30b-a3b, and no second copy of it fits the card."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": _stacked(n, (d, E), **{**kw, "dtype": torch.float32}),
        "w1": _stacked(n, (E, d, f), **kw),
        "w3": _stacked(n, (E, d, f), **kw),
        "w2": _stacked(n, (E, f, d), scale=1.0 / np.sqrt(f), **kw),
    }


def _mamba_block_init(cfg: ModelConfig, n: int, kw) -> dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    K = cfg.ssm_conv_width
    dev = kw["device"]
    a_log = torch.log(torch.linspace(1.0, float(max(H, 2)), H,
                                     device=dev))
    return {"norm1": _ones(n, d, dev), "ssm": {
        # in_proj -> [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": _stacked(n, (d, 2 * di + 2 * N + H), **kw),
        "conv_w": _normal(n, (K, di), 0.1, **kw),
        "a_log": a_log.repeat(n, 1),
        "dt_bias": torch.zeros((n, H), device=dev),
        "d_skip": torch.ones((n, H), device=dev),
        "norm": _ones(n, di, dev),
        "w_out": _stacked(n, (di, d), **kw),
    }}


def _mlstm_block_init(cfg: ModelConfig, n: int, kw) -> dict:
    d, di, H, K = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, \
        cfg.ssm_conv_width
    dev = kw["device"]
    return {"norm1": _ones(n, d, dev), "ssm": {
        "w_up": _stacked(n, (d, 2 * di), **kw),
        "conv_w": _normal(n, (K, di), 0.1, **kw),
        "wq": _stacked(n, (di, di), **kw),
        "wk": _stacked(n, (di, di), **kw),
        "wv": _stacked(n, (di, di), **kw),
        "w_gates": _stacked(n, (di, 2 * H), **{**kw,
                                                "dtype": torch.float32}),
        "norm": _ones(n, di, dev),
        "w_out": _stacked(n, (di, d), **kw),
    }}


def _slstm_block_init(cfg: ModelConfig, n: int, kw) -> dict:
    d, H = cfg.d_model, cfg.n_ssm_heads
    hd = d // H
    dev = kw["device"]
    return {"norm1": _ones(n, d, dev), "ssm": {
        "w_x": _stacked(n, (d, H, 4, hd), **kw),
        "b_x": torch.zeros((n, H, 4, hd), device=dev),
        "r_h": _normal(n, (H, 4, hd, hd), 0.5 / np.sqrt(hd), **kw),
        "w_ffn_in": _stacked(n, (d, 2 * d), **kw),
        "w_ffn_out": _stacked(n, (2 * d, d), **kw),
    }, "norm2": _ones(n, d, dev)}


_BLOCK_INIT = {"attn": _attn_block_init, "mamba": _mamba_block_init,
               "mlstm": _mlstm_block_init, "slstm": _slstm_block_init}


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from the port's own ``torch.Generator`` (never
    compared bit for bit with the reference's init; the tests carry the
    reference's weights over with :mod:`repro_torch.models.bridge`), in
    the reference's tree: one stacked dict per group of
    :func:`layer_pattern`, ``shared_attn`` unstacked."""
    _require_ported(cfg, "init_params")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    kw = dict(gen=gen, device=dev, dtype=dtype)
    params: dict = {}
    for gname, kind, n in layer_pattern(cfg):
        if kind == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = _slice(
                    _attn_block_init(cfg, 1, kw), 0)
            continue
        params[gname] = _BLOCK_INIT[kind](cfg, n, kw)
    params["embed"] = embed_init(cfg.vocab_size, cfg.d_model, generator=gen,
                                 device=dev, dtype=dtype)
    params["final_norm"] = norm_init(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size),
                                       generator=gen, device=dev,
                                       dtype=dtype)
    return params


def _empty_cache_block(cfg: ModelConfig, kind: str, n: int, batch: int,
                       max_len: int, dtype, device) -> dict:
    """One group's cache, stacked: every leaf has a leading axis of n."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    K = cfg.ssm_conv_width

    def zeros(*shape, dt=torch.float32):
        return torch.zeros((n, batch) + shape, dtype=dt, device=device)

    if kind in ("attn", "shared_attn"):
        L = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        return {"k": zeros(L, cfg.n_kv_heads, cfg.hd, dt=dtype),
                "v": zeros(L, cfg.n_kv_heads, cfg.hd, dt=dtype)}
    if kind == "mamba":
        return {"conv": zeros(K - 1, di, dt=dtype),
                "state": zeros(H, N, di // H)}
    if kind == "mlstm":
        hd = di // H
        return {"conv": zeros(K - 1, di, dt=dtype),
                "state": zeros(H, hd, hd + 1)}
    if kind == "slstm":
        hd = cfg.d_model // H
        return {"hcnm": (zeros(H, hd), zeros(H, hd), zeros(H, hd),
                         torch.full((n, batch, H, hd), -1e30,
                                    dtype=torch.float32, device=device))}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> dict:
    """Decode cache: ``lengths`` (batch,) int32 and, per group of
    :func:`layer_pattern`, its blocks' caches stacked on a leading axis —
    k/v (n, batch, L, Hkv, hd) for attention (L = min(max_len, window)
    with a sliding window), conv/state for Mamba2 and mLSTM, the
    (h, c, n, m) tuple for sLSTM (m starts at -1e30)."""
    _require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    cache: dict = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)}
    for gname, kind, n in layer_pattern(cfg):
        cache[gname] = _empty_cache_block(cfg, kind, n, batch, max_len,
                                          dtype, dev)
    return cache


# ==========================================================================
# Blocks
# ==========================================================================

def _slice(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slice(v, i) for v in tree)
    return tree[i]


def _mlp_forward(cfg: ModelConfig, p, x):
    """The block's FFN: the routed experts for an MoE model (its
    load-balance loss is not needed here and not computed), else the dense
    MLP."""
    if cfg.is_moe:
        return moe_ffn(x, p, n_experts=cfg.n_experts,
                       k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor,
                       aux_loss=False)[0]
    if cfg.mlp_variant == "swiglu":
        return swiglu(x, p["w_in"], p["w_gate"], p["w_out"])
    return linear(F.gelu(linear(x, p["w_in"]), approximate="tanh"),
                  p["w_out"])


def _chunk_qkv(cfg: ModelConfig, p, xx, r, sin, cos):
    """Pre-attention half of an attn block: the pending residual ``r`` (None
    at the first block) added in norm1, q/k/v projection, rope.  Returns
    (xx + r, q, k, v)."""
    xx, h = add_rms_norm(xx, r, p["norm1"], cfg.norm_eps)
    ap = p["attn"]
    q = apply_rope(linear(h, ap["wq"], ap.get("bq")), sin, cos)
    k = apply_rope(linear(h, ap["wk"], ap.get("bk")), sin, cos)
    v = linear(h, ap["wv"], ap.get("bv"))
    return xx, q, k, v


def _chunk_finish(cfg: ModelConfig, p, xx, o):
    """Post-attention half: output projection, its residual added in norm2,
    FFN.  Returns (residual stream, FFN output): the next norm adds the
    second."""
    ap = p["attn"]
    a = linear(o.reshape(o.shape[:-2] + (-1,)),
               ap["wo"].reshape(-1, cfg.d_model))
    xx, h2 = add_rms_norm(xx, a, p["norm2"], cfg.norm_eps)
    return xx, _mlp_forward(cfg, p["ffn"], h2)


def _write_rows(buf, pos, new):
    """``buf[b, pos[b]] = new[b]`` for every row whose ``pos`` lies in
    ``[0, L)``; the other rows keep their content (the reference's dropped
    out-of-bounds scatter), without a host sync."""
    L = buf.shape[1]
    ok = (pos >= 0) & (pos < L)
    bidx = torch.arange(buf.shape[0], device=buf.device)
    pc = pos.clamp(0, L - 1)
    keep = ok.reshape((-1,) + (1,) * (new.dim() - 1))
    buf[bidx, pc] = torch.where(keep, new.to(buf.dtype), buf[bidx, pc])


def _attn_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache, sin, cos,
                  lengths, rolling: bool = False):
    """Self-attention block (+ FFN).  ``decode`` writes the new token's KV
    at ``lengths - 1`` (taken ``% L`` on a rolling cache) into ``cache`` in
    place and attends through :func:`attention.decode_attention` (kernel
    K3 on a CUDA tensor); ``prefill`` attends causally and fills the cache
    rows' first S positions."""
    x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        pos = lengths.long() - 1
        if rolling:
            pos = pos % kc.shape[1]
        _write_rows(kc, pos, k[:, 0])
        _write_rows(vc, pos, v[:, 0])
        o = attn_lib.decode_attention(
            q[:, 0].contiguous(), kc, vc, lengths,
            sliding_window=cfg.sliding_window, rolling=rolling)[:, None]
    else:
        o = attn_lib.causal_attention(q, k, v,
                                      sliding_window=cfg.sliding_window,
                                      lengths=lengths)
        if cache is not None:
            S, L = k.shape[1], cache["k"].shape[1]
            if S > L:
                raise ValueError(f"prefill of {S} positions does not fit a "
                                 f"KV cache of length {L}")
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _chunk_finish(cfg, p, x, o)


def _valid(lengths, S: int):
    """(B, S) float mask of the positions below each row's length."""
    return (torch.arange(S, device=lengths.device)[None, :]
            < lengths.long()[:, None]).float()


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _mamba_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache,
                   lengths):
    """Mamba2 (SSD) block.  In prefill, padding steps get dt=0, which zeroes
    both the decay exponent and the input gate — the state is untouched
    beyond the true prompt length.  ``cache`` (conv, state) is written in
    place."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // H
    sp = p["ssm"]
    x, h = add_rms_norm(x, r, p["norm1"], cfg.norm_eps)
    proj = linear(h, sp["w_in"])          # (..., 2di+2N+H)
    z, xs, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    dt = _softplus(dt.float() + sp["dt_bias"].float())          # (..., H)
    a = -torch.exp(sp["a_log"].float())                          # (H,)
    if mode == "decode":
        xc, conv_state = ssm_lib.causal_conv1d_step(xs[:, 0], sp["conv_w"],
                                                    cache["conv"])
        xh = F.silu(xc).reshape(-1, H, P)
        Bt = xh.shape[0]
        y, state = ssm_lib.linear_attention_step(
            Cm[:, 0, None, :].expand(Bt, H, N),
            Bm[:, 0, None, :].expand(Bt, H, N),
            xh, dt[:, 0] * a[None, :], dt[:, 0], cache["state"])
        y = y + sp["d_skip"].to(y.dtype)[None, :, None] * xh
        y = y.reshape(Bt, 1, di)
    else:
        if lengths is not None:
            dt = dt * _valid(lengths, x.shape[1])[..., None]
        xc, conv_state = ssm_lib.causal_conv1d(xs, sp["conv_w"],
                                               lengths=lengths)
        Bt, S = x.shape[0], x.shape[1]
        xh = F.silu(xc).reshape(Bt, S, H, P)
        y, state = ssm_lib.chunked_linear_attention(
            Cm[:, :, None, :], Bm[:, :, None, :], xh,
            dt * a[None, None, :], dt, chunk=128)
        y = y + sp["d_skip"].to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(Bt, S, di)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
    y = rms_norm(y * F.silu(z), sp["norm"], cfg.norm_eps)
    return x, linear(y, sp["w_out"])


def _mlstm_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache,
                   lengths):
    """mLSTM block: the gated linear-attention core with the normalizer
    column.  ``cache`` (conv, state) is written in place."""
    di, H = cfg.d_inner, cfg.n_ssm_heads
    hd = di // H
    sp = p["ssm"]
    x, h = add_rms_norm(x, r, p["norm1"], cfg.norm_eps)
    xm, z = torch.chunk(linear(h, sp["w_up"]), 2, dim=-1)
    if mode == "decode":
        xc, conv_state = ssm_lib.causal_conv1d_step(xm[:, 0], sp["conv_w"],
                                                    cache["conv"])
        xc = F.silu(xc)
        q = linear(xc, sp["wq"]).reshape(-1, H, hd)
        # the reference divides by a numpy float64, which promotes to f32
        k = linear(xc, sp["wk"]).reshape(-1, H, hd).float() / math.sqrt(hd)
        v = linear(xc, sp["wv"]).reshape(-1, H, hd)
        i_pre, f_pre = torch.chunk(linear(xc, sp["w_gates"]).float(), 2,
                                   dim=-1)                     # (B, H)
        y, state = ssm_lib.linear_attention_step(
            q, k, v, F.logsigmoid(f_pre), torch.sigmoid(i_pre),
            cache["state"], normalize=True)
        y = y.reshape(-1, 1, di)
    else:
        xc, conv_state = ssm_lib.causal_conv1d(xm, sp["conv_w"],
                                               lengths=lengths)
        xc = F.silu(xc)
        Bt, S = x.shape[0], x.shape[1]
        q = linear(xc, sp["wq"]).reshape(Bt, S, H, hd)
        k = linear(xc, sp["wk"]).reshape(Bt, S, H, hd).float() \
            / math.sqrt(hd)
        v = linear(xc, sp["wv"]).reshape(Bt, S, H, hd)
        i_pre, f_pre = torch.chunk(linear(xc, sp["w_gates"]).float(), 2,
                                   dim=-1)                     # (B, S, H)
        log_f = F.logsigmoid(f_pre)
        i_g = torch.sigmoid(i_pre)
        if lengths is not None:
            valid = _valid(lengths, S)[..., None]
            log_f = log_f * valid   # decay 1 on padding
            i_g = i_g * valid       # no input on padding
        y, state = ssm_lib.chunked_linear_attention(
            q, k, v, log_f, i_g, chunk=128, normalize=True)
        y = y.reshape(Bt, S, di)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
    y = rms_norm(y * F.silu(z), sp["norm"], cfg.norm_eps)
    return x, linear(y, sp["w_out"])


def _slstm_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache,
                   lengths):
    """sLSTM block (+ its GELU FFN).  ``cache["hcnm"]`` is written in
    place."""
    d, H = cfg.d_model, cfg.n_ssm_heads
    hd = d // H
    sp = p["ssm"]
    x, h = add_rms_norm(x, r, p["norm1"], cfg.norm_eps)
    xg = linear(h, sp["w_x"].reshape(d, -1)).reshape(
        h.shape[:-1] + (H, 4, hd)) + sp["b_x"].to(h.dtype)
    if mode == "decode":
        y, state = ssm_lib.slstm_step(xg[:, 0], sp["r_h"], cache["hcnm"])
        y = y[:, None]
    else:
        valid = None
        if lengths is not None:
            valid = _valid(lengths, xg.shape[1]) > 0
        y, state = ssm_lib.slstm_scan(xg, sp["r_h"], valid=valid)
    if cache is not None:
        for dst, src in zip(cache["hcnm"], state):
            dst.copy_(src)
    x, h2 = add_rms_norm(x, y.reshape(y.shape[:2] + (d,)), p["norm2"],
                         cfg.norm_eps)
    ff = linear(F.gelu(linear(h2, sp["w_ffn_in"]), approximate="tanh"),
                sp["w_ffn_out"])
    return x, ff


_FORWARD = {"mamba": _mamba_forward, "mlstm": _mlstm_forward,
            "slstm": _slstm_forward}


def _block_forward(cfg: ModelConfig, kind: str, p, x, r, *, mode: str,
                   cache, common: dict):
    if kind in ("attn", "shared_attn"):
        return _attn_forward(cfg, p, x, r, mode=mode, cache=cache, **common)
    return _FORWARD[kind](cfg, p, x, r, mode=mode, cache=cache,
                          lengths=common["lengths"])


def _run_stack(cfg: ModelConfig, params, x, *, mode: str, cache,
               common: dict):
    """Every block of every group in order; each block reads and writes
    its own slice of ``cache`` (the shared attention block: one cache per
    application).  Returns (residual stream, the last block's branch
    output), which :func:`_lm_logits` adds."""
    r = None
    for gname, kind, n in layer_pattern(cfg):
        gcache = cache.get(gname) if cache is not None else None
        if kind == "shared_attn":
            c = _slice(gcache, 0) if gcache is not None else None
            x, r = _block_forward(cfg, kind, params["shared_attn"], x, r,
                                  mode=mode, cache=c, common=common)
            continue
        gp = params[gname]
        for i in range(n):
            c = _slice(gcache, i) if gcache is not None else None
            x, r = _block_forward(cfg, kind, _slice(gp, i), x, r, mode=mode,
                                  cache=c, common=common)
    return x, r


def _lm_logits(cfg, params, x, r):
    """The final norm, with the last block's pending branch ``r`` added in
    it, and the LM head."""
    _, x = add_rms_norm(x, r, params["final_norm"], cfg.norm_eps)
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
    (last_logits (B, V), cache) with the :func:`init_cache` layout."""
    _require_ported(cfg, "prefill_fn")
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
    cache = init_cache(cfg, B, max_len, device=dev)
    x, r = _run_stack(cfg, params, x, mode="prefill", cache=cache,
                      common=dict(sin=sin[None], cos=cos[None],
                                  lengths=lengths))
    cache["lengths"] = lengths
    return (_lm_logits(cfg, params, _last(x, lengths, S),
                       _last(r, lengths, S)), cache)


def decode_fn(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens: (B,) int32 — the tokens sampled last step.

    ``cache`` (the :func:`init_cache` layout, ``lengths`` counting the
    tokens so far) is updated IN PLACE: the new KV at ``lengths`` (rolling
    ``% L`` with a sliding window), every recurrent state, and ``lengths``
    + 1.  Returns (logits (B, V), cache)."""
    _require_ported(cfg, "decode_fn")
    lengths = cache["lengths"] + 1
    x = params["embed"][tokens.long()[:, None]]
    pos = lengths.long() - 1
    sin, cos = make_rope(pos[:, None], cfg.hd, cfg.rope_theta)
    x, r = _run_stack(cfg, params, x, mode="decode", cache=cache,
                      common=dict(sin=sin, cos=cos, lengths=lengths,
                                  rolling=bool(cfg.sliding_window)))
    cache["lengths"] = lengths
    return _lm_logits(cfg, params, x[:, 0], r[:, 0]), cache


def supports_paged_stack(cfg: ModelConfig) -> bool:
    """True iff the decoder is a single homogeneous attention stack whose
    KV cache is pure (k, v) pairs (reference semantics: dense/moe/vlm
    without a sliding window).  Of these the port runs dense and moe so
    far; vlm raises naming its ROADMAP item."""
    return (cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window)


def _require_paged_stack(cfg: ModelConfig, what: str) -> None:
    if not supports_paged_stack(cfg):
        raise ValueError(
            f"{what} supports only attention-family models without a "
            f"sliding window (dense/moe/vlm), got family={cfg.family!r} "
            f"sliding_window={cfg.sliding_window}")
    _require_ported(cfg, what)


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
    r = None
    for i in range(cfg.n_layers):
        p = _slice(params["blocks"], i)
        x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
        kc[i, rows, wpos] = k[rows, cols].to(kc.dtype)
        vc[i, rows, wpos] = v[rows, cols].to(vc.dtype)
        o = attn_lib.chunk_attention(q, kc[i], vc[i], q_pos=posmat,
                                     kv_len=kv_len)
        x, r = _chunk_finish(cfg, p, x, o)
    cache["lengths"] = kv_len.to(torch.int32)
    return (_lm_logits(cfg, params, _last(x, chunk_lens, C),
                       _last(r, chunk_lens, C)), cache)


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
    r = None
    for i in range(cfg.n_layers):
        p = _slice(params["blocks"], i)
        kp, vp = k_pool[i], v_pool[i]
        x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
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
            o = attn_lib.decode_attention(q[:, 0].contiguous(), kc, vc,
                                          lengths)
        x, r = _chunk_finish(cfg, p, x, o[:, None])
    logits = _lm_logits(cfg, params, x[:, 0], r[:, 0])
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
    r = None
    for i in range(cfg.n_layers):
        p = _slice(params["blocks"], i)
        kp, vp = k_pool[i], v_pool[i]
        x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
        kp[pblk, poff] = k[rows, cols].to(kp.dtype)
        vp[pblk, poff] = v[rows, cols].to(vp.dtype)
        kc = kp[bt].reshape(n, L, *kp.shape[2:])
        vc = vp[bt].reshape(n, L, *vp.shape[2:])
        o = attn_lib.chunk_attention(q, kc, vc, q_pos=posmat, kv_len=kv_len)
        x, r = _chunk_finish(cfg, p, x, o)
    return (_lm_logits(cfg, params, _last(x, chunk_lens, C),
                       _last(r, chunk_lens, C)), k_pool, v_pool)
