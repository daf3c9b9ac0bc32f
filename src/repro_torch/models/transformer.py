"""Model assembly: parameter init, the training loss, prefill, decode,
chunked prefill and paged decode for all six families: the dense
decoder, the MoE decoder (the dense stack with a top-k routed expert FFN,
:mod:`repro_torch.models.moe`), the recurrent families (ssm: xLSTM's
mLSTM/sLSTM stack; hybrid: Zamba2's Mamba2 stack with one shared
attention block), vlm (the dense decoder with projected image-patch
embeddings spliced over the prompt's first ``patch_tokens`` positions)
and audio (a Whisper-style encoder over frame embeddings and the dense
decoder with one cross attention a layer).  The vision tower and the
audio front end are stubs, as in the reference: the caller passes
``patches`` and ``frames`` embeddings.

Parameters keep the reference's stacked per-group layout: each group of
:func:`layer_pattern` holds its blocks' weights on a leading axis and the
layer loop slices it (the reference scans it); zamba2's shared attention
block is one unstacked ``params["shared_attn"]`` applied after every group
of Mamba2 blocks, each application with its own cache (``shared0`` ...);
audio adds ``enc_blocks``, ``enc_pos``, ``enc_norm`` and the stacked
``cross_blocks``, vlm the ``projector`` MLP.

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

Training (:func:`loss_fn`) runs the stack in ``mode="train"``: no cache,
attention through :func:`attention.blocked_causal_attention` (the
reference's blocked attention with its recomputing backward), each block
under ``torch.utils.checkpoint`` when ``remat`` (the reference's
``jax.checkpoint`` a layer), the MoE load-balance losses summed over the
layers, and the LM head fused with the cross entropy over sequence
chunks.  On a CUDA tensor the norms take K2 with its backward kernel
(:mod:`repro_torch.kernels.rms_norm`); the recurrent families' scans
(K5) have no backward on the card and refuse to run under autograd.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import ssm as ssm_lib
from .layers import (
    add_rms_norm,
    apply_rope,
    cross_entropy_loss,
    dense_init,
    embed_init,
    linear,
    make_rope,
    norm_init,
    rms_norm,
    gather_fsdp,
    sharded_dims,
    swiglu,
    token_nll,
)
from .moe import moe_ffn

__all__ = ["init_params", "param_axes", "init_cache", "layer_pattern",
           "supports_paged_stack", "loss_fn", "prefill_fn", "decode_fn",
           "chunk_prefill_fn", "paged_decode_fn", "paged_chunk_prefill_fn",
           "resolve_device", "torch_dtype"]

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


# ==========================================================================
# Parameter initialization
# ==========================================================================

def layer_pattern(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """The decoder stack as homogeneous groups (group, kind, n_blocks);
    audio's encoder is not part of it."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
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
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
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


def _attn_init(cfg: ModelConfig, n: int, kw) -> dict:
    """n stacked attention weight sets: wq/wk/wv (d, heads, hd), wo (Hq,
    hd, d) and, with ``qkv_bias``, zero biases."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
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
    return attn


def _mlp_init(cfg: ModelConfig, n: int, kw) -> dict:
    """n stacked dense MLPs: w_in (d, f), w_out (f, d), and w_gate (d, f)
    for SwiGLU."""
    d, f = cfg.d_model, cfg.d_ff
    ffn = {"w_in": _stacked(n, (d, f), **kw),
           "w_out": _stacked(n, (f, d), **kw)}
    if cfg.mlp_variant == "swiglu":
        ffn["w_gate"] = _stacked(n, (d, f), **kw)
    return ffn


def _attn_block_init(cfg: ModelConfig, n: int, kw) -> dict:
    d, dev = cfg.d_model, kw["device"]
    ffn = _moe_init(cfg, n, kw) if cfg.is_moe else _mlp_init(cfg, n, kw)
    return {"norm1": _ones(n, d, dev), "attn": _attn_init(cfg, n, kw),
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
        # the reference scales the draw rounded to the model dtype by a
        # numpy float64, which makes the leaf float32 in a bf16 model
        "r_h": _normal(n, (H, 4, hd, hd), 1.0, **kw).float()
        * (0.5 / np.sqrt(hd)),
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
    :func:`layer_pattern`, ``shared_attn`` unstacked; audio's encoder
    (``enc_blocks``, ``enc_pos`` (encoder_seq, d) at scale 0.01,
    ``enc_norm``) and ``cross_blocks`` ({norm, attn} per decoder layer,
    stacked); vlm's unstacked ``projector`` MLP.  ``device="meta"`` gives
    the shapes and dtypes alone."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = None                    # the meta device draws nothing
    if dev.type != "meta":
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
    if cfg.family == "audio":
        d = cfg.d_model
        params["enc_blocks"] = _attn_block_init(cfg, cfg.encoder_layers, kw)
        params["enc_pos"] = _normal(1, (cfg.encoder_seq, d), 0.01, **kw)[0]
        params["enc_norm"] = norm_init(d, device=dev)
        params["cross_blocks"] = {"norm": _ones(cfg.n_layers, d, dev),
                                  "attn": _attn_init(cfg, cfg.n_layers, kw)}
    if cfg.family == "vlm":
        params["projector"] = _slice(_mlp_init(cfg, 1, kw), 0)
    return params


def _attn_axes(cfg: ModelConfig) -> dict:
    ax = {"wq": ("embed", "heads", "hd"), "wk": ("embed", "kv_heads", "hd"),
          "wv": ("embed", "kv_heads", "hd"), "wo": ("heads", "hd", "embed")}
    if cfg.qkv_bias:
        ax.update(bq=("heads", "hd"), bk=("kv_heads", "hd"),
                  bv=("kv_heads", "hd"))
    return ax


def _mlp_axes(cfg: ModelConfig) -> dict:
    ax = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if cfg.mlp_variant == "swiglu":
        ax["w_gate"] = ("embed", "mlp")
    return ax


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """One unstacked block's logical axes, as the reference's ``Param``s
    carry them."""
    norm = ("embed",)
    if kind == "attn":
        ffn = {"router": ("embed", "experts"),
               "w1": ("experts", "embed", "expert_mlp"),
               "w3": ("experts", "embed", "expert_mlp"),
               "w2": ("experts", "expert_mlp", "embed")} if cfg.is_moe \
            else _mlp_axes(cfg)
        return {"norm1": norm, "attn": _attn_axes(cfg), "norm2": norm,
                "ffn": ffn}
    conv = ("conv_k", "ssm_inner")
    if kind == "mamba":
        h = ("ssm_heads",)
        return {"norm1": norm, "ssm": {
            "w_in": ("embed", "ssm_in"), "conv_w": conv, "a_log": h,
            "dt_bias": h, "d_skip": h, "norm": ("ssm_inner",),
            "w_out": ("ssm_inner", "embed")}}
    if kind == "mlstm":
        sq = ("ssm_inner", "ssm_inner2")
        return {"norm1": norm, "ssm": {
            "w_up": ("embed", "ssm_in"), "conv_w": conv, "wq": sq,
            "wk": sq, "wv": sq, "w_gates": ("ssm_inner", "ssm_heads2"),
            "norm": ("ssm_inner",), "w_out": ("ssm_inner", "embed")}}
    if kind == "slstm":
        return {"norm1": norm, "ssm": {
            "w_x": ("embed", "ssm_heads", "gates", "hd"),
            "b_x": ("ssm_heads", "gates", "hd"),
            "r_h": ("ssm_heads", "gates", "hd", "hd2"),
            "w_ffn_in": ("embed", "mlp"), "w_ffn_out": ("mlp", "embed")},
            "norm2": norm}
    raise ValueError(kind)


def _stacked_axes(tree):
    if isinstance(tree, dict):
        return {k: _stacked_axes(v) for k, v in tree.items()}
    return ("layers",) + tree


def param_axes(cfg: ModelConfig) -> dict:
    """The logical sharding axes of every leaf of :func:`init_params`'s
    tree, a tuple of names per leaf: the axes the reference's ``Param``s
    carry (``split_params``), which :mod:`repro_torch.launch.mesh` maps to
    mesh axes."""
    axes: dict = {}
    for gname, kind, _ in layer_pattern(cfg):
        if kind == "shared_attn":
            axes.setdefault("shared_attn", _block_axes(cfg, "attn"))
            continue
        axes[gname] = _stacked_axes(_block_axes(cfg, kind))
    axes["embed"] = ("vocab", "embed")
    axes["final_norm"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.family == "audio":
        axes["enc_blocks"] = _stacked_axes(_block_axes(cfg, "attn"))
        axes["enc_pos"] = ("enc_seq", "embed")
        axes["enc_norm"] = ("embed",)
        axes["cross_blocks"] = _stacked_axes({"norm": ("embed",),
                                              "attn": _attn_axes(cfg)})
    if cfg.family == "vlm":
        axes["projector"] = _mlp_axes(cfg)
    return axes


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
    (h, c, n, m) tuple for sLSTM (m starts at -1e30).  Audio adds the
    cross-attention KV that prefill computes, ``cross_kv`` k and v
    (layers, batch, encoder_seq, Hkv, hd), and ``enc_lengths`` (batch,)
    int32 at ``encoder_seq``.  The reference binds one zeros array to both
    k and v; here they are separate tensors, because the slot backend
    installs prefill rows into them in place."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    cache: dict = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)}
    for gname, kind, n in layer_pattern(cfg):
        cache[gname] = _empty_cache_block(cfg, kind, n, batch, max_len,
                                          dtype, dev)
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.hd)
        cache["cross_kv"] = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
        cache["enc_lengths"] = torch.full((batch,), cfg.encoder_seq,
                                          dtype=torch.int32, device=dev)
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


def _mlp_forward(cfg: ModelConfig, p, x, aux=None, mesh=None,
                 batch_axes=("data",)):
    """The block's FFN: the routed experts for an MoE model (expert- or
    tensor-parallel under ``mesh``), else the dense MLP.  ``aux`` (a list,
    in training) collects the MoE load-balance loss; without it the loss
    is not computed."""
    if cfg.is_moe:
        y, a = moe_ffn(x, p, n_experts=cfg.n_experts,
                       k=cfg.experts_per_token, mesh=mesh,
                       batch_axes=batch_axes,
                       capacity_factor=cfg.capacity_factor,
                       aux_loss=aux is not None)
        if aux is not None:
            aux.append(a)
        return y
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


def _out_proj(cfg: ModelConfig, ap, o):
    """Attention output (..., Hq, hd) through ``wo`` to (..., d).  A
    DTensor ``wo`` sharded on hd contracts (hd, Hq) in that order, so both
    flattens keep a plain shard."""
    wo = ap["wo"]
    if sharded_dims(wo, [1]) and not sharded_dims(wo, [0]):
        n = o.dim()
        o = o.transpose(n - 2, n - 1)
        wo = wo.transpose(0, 1)
    return linear(o.reshape(o.shape[:-2] + (-1,)),
                  wo.reshape(-1, cfg.d_model))


def _chunk_finish(cfg: ModelConfig, p, xx, o, aux=None, mesh=None,
                  batch_axes=("data",)):
    """Post-attention half: output projection, its residual added in norm2,
    FFN.  Returns (residual stream, FFN output): the next norm adds the
    second."""
    xx, h2 = add_rms_norm(xx, _out_proj(cfg, p["attn"], o), p["norm2"],
                          cfg.norm_eps)
    return xx, _mlp_forward(cfg, p["ffn"], h2, aux, mesh, batch_axes)


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


def _write_rows_sharded(buf, pos, new):
    """:func:`_write_rows` on a DTensor cache: the new rows and positions
    are redistributed to the cache's batch and head shards, and each rank
    writes its rows into its local shard, its positions taken from its
    shard's offset along the length (the rows of another length shard
    fall outside ``[0, L_loc)`` and are dropped)."""
    from torch.distributed.tensor import Replicate, Shard
    from ..kernels.sharded import as_dtensor
    mesh = buf.device_mesh
    # the rows without the length dim: batch kept, later dims shifted down
    rows = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
                 and p.dim != 1 else Replicate() for p in buf.placements)
    new = as_dtensor(new, mesh).redistribute(mesh, rows)
    pos = as_dtensor(pos, mesh).redistribute(
        mesh, tuple(p if p == Shard(0) else Replicate() for p in rows))
    # this shard's first position: the mesh dims that cut the length, the
    # outermost first
    size, off = buf.shape[1], 0
    for i, p in enumerate(buf.placements):
        if p == Shard(1):
            size //= mesh.size(i)
            off += mesh.get_local_rank(i) * size
    _write_rows(buf.to_local(), pos.to_local() - off, new.to_local())


def _copy_into(dst, src):
    """``dst.copy_(src)``; on a DTensor ``dst`` each rank copies into its
    own shard from ``src`` redistributed to ``dst``'s placements."""
    from ..kernels.sharded import as_dtensor, is_dtensor
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    src = as_dtensor(src, dst.device_mesh).redistribute(dst.device_mesh,
                                                        dst.placements)
    dst.to_local().copy_(src.to_local())


def _attn_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache, sin, cos,
                  lengths, rolling: bool = False, cross=None, aux=None,
                  mesh=None, batch_axes=("data",), kv_shard: str = "none"):
    """Self-attention block (+ FFN).  ``decode`` writes the new token's KV
    at ``lengths - 1`` (taken ``% L`` on a rolling cache) into ``cache`` in
    place and attends through :func:`attention.decode_attention` (kernel
    K3 on a CUDA tensor), or with ``kv_shard="length"`` on a cache that
    is not rolling through :func:`attention.decode_attention_lsharded`;
    ``prefill`` attends causally and fills the cache rows' first S
    positions; ``train`` attends through
    :func:`attention.blocked_causal_attention` and writes no cache.
    ``aux``: see :func:`_mlp_forward`.  Under ``mesh`` the cache is a
    DTensor tree and each rank writes its own shard.

    ``cross`` (audio): (this layer's ``cross_blocks`` entry, its cross KV
    {k, v} (B, S_enc, Hkv, hd), ``enc_lengths``).  Between the
    self-attention and the FFN the block then runs cross attention: the
    self-attention output is added in the cross norm, the query takes no
    rope, and the cross output is added in norm2."""
    x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        pos = lengths.long() - 1
        if rolling:
            pos = pos % kc.shape[1]
        write = _write_rows if mesh is None else _write_rows_sharded
        write(kc, pos, k[:, 0])
        write(vc, pos, v[:, 0])
        if kv_shard == "length" and not rolling:
            o = attn_lib.decode_attention_lsharded(
                q[:, 0], kc, vc, lengths, mesh=mesh,
                batch_axes=batch_axes)[:, None]
        else:
            o = attn_lib.decode_attention(
                q[:, 0].contiguous(), kc, vc, lengths,
                sliding_window=cfg.sliding_window, rolling=rolling)[:, None]
    else:
        attend = attn_lib.blocked_causal_attention if mode == "train" \
            else attn_lib.causal_attention
        o = attend(q, k, v, sliding_window=cfg.sliding_window,
                   lengths=lengths)
        if cache is not None:
            S, L = k.shape[1], cache["k"].shape[1]
            if S > L:
                raise ValueError(f"prefill of {S} positions does not fit a "
                                 f"KV cache of length {L}")
            if mesh is None:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
            else:
                _copy_into(cache["k"][:, :S], k.to(cache["k"].dtype))
                _copy_into(cache["v"][:, :S], v.to(cache["v"].dtype))
    if cross is not None:
        cp, ckv, enc_lengths = cross
        x, hc = add_rms_norm(x, _out_proj(cfg, p["attn"], o), cp["norm"],
                             cfg.norm_eps)
        qc = linear(hc, cp["attn"]["wq"], cp["attn"].get("bq"))
        o = attn_lib.cross_attention(qc, ckv["k"], ckv["v"],
                                     lengths=enc_lengths)
        p = dict(p, attn=cp["attn"])      # the cross wo projects o below
    return _chunk_finish(cfg, p, x, o, aux, mesh, batch_axes)


def _valid(lengths, S: int):
    """(B, S) float mask of the positions below each row's length."""
    return (torch.arange(S, device=lengths.device)[None, :]
            < lengths.long()[:, None]).float()


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor (no sharding rule) on each rank's
    batch rows."""
    from ..kernels.sharded import is_dtensor, on_batch_shards
    if is_dtensor(x):
        return on_batch_shards(F.logsigmoid, (x,))
    return F.logsigmoid(x)


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
        _copy_into(cache["conv"], conv_state)
        _copy_into(cache["state"], state)
    y = rms_norm(y * F.silu(z), sp["norm"], cfg.norm_eps)
    return x, linear(y, sp["w_out"])


def _mlstm_forward(cfg: ModelConfig, p, x, r, *, mode: str, cache,
                   lengths):
    """mLSTM block: the gated linear-attention core with the normalizer
    column.  ``cache`` (conv, state) is written in place."""
    from ..kernels.sharded import is_dtensor, kept
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
            q, k, v, _logsigmoid(f_pre), torch.sigmoid(i_pre),
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
        gates = linear(xc, sp["w_gates"]).float()
        if is_dtensor(gates):
            # the (B, S, 2H) gates whole on every model rank (their pending
            # sum reduced here): left to DTensor, their gradient may come
            # back with S cut, which the weight's gradient cannot flatten
            gates = gates.redistribute(gates.device_mesh,
                                       kept(gates, {0: 0}))
        i_pre, f_pre = torch.chunk(gates, 2, dim=-1)          # (B, S, H)
        log_f = _logsigmoid(f_pre)
        i_g = torch.sigmoid(i_pre)
        if lengths is not None:
            valid = _valid(lengths, S)[..., None]
            log_f = log_f * valid   # decay 1 on padding
            i_g = i_g * valid       # no input on padding
        y, state = ssm_lib.chunked_linear_attention(
            q, k, v, log_f, i_g, chunk=128, normalize=True)
        y = y.reshape(Bt, S, di)
    if cache is not None:
        _copy_into(cache["conv"], conv_state)
        _copy_into(cache["state"], state)
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
    xg = linear(h, sp["w_x"]) + sp["b_x"].to(h.dtype)   # (..., H, 4, hd)
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
            _copy_into(dst, src)
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


def _constrain(t, act_spec):
    """The reference's ``with_sharding_constraint`` on the residual stream:
    ``t`` redistributed to ``act_spec``'s placements (None: unchanged)."""
    if act_spec is None or t is None:
        return t
    return t.redistribute(act_spec.mesh, act_spec.placements)


def _run_stack(cfg: ModelConfig, params, x, *, mode: str, cache,
               common: dict, remat: bool = False, cross_kv=None,
               enc_lengths=None, act_spec=None):
    """Every block of every group in order; each block reads and writes
    its own slice of ``cache`` (the shared attention block: one cache per
    application; audio's decoder layer i also reads ``cross_blocks[i]``
    and entry i of the cross K/V, ``cross_kv`` or else
    ``cache["cross_kv"]``, with ``enc_lengths`` or else
    ``cache["enc_lengths"]``).  Returns (residual stream, the last block's
    branch output), which :func:`_lm_logits` adds; ``mode="train"``
    (no cache) adds a third value, the MoE load-balance loss summed over
    the layers in order (float32 zero for the other families), and with
    ``remat`` runs each block under ``torch.utils.checkpoint``.
    ``act_spec``: the residual stream's sharding, after the embedding and
    after every block (see :func:`_constrain`)."""
    r = None
    x = _constrain(x, act_spec)
    train = mode == "train"
    aux_total = x.new_zeros((), dtype=torch.float32) if train else None
    if cfg.family == "audio" and cross_kv is None:
        cross_kv, enc_lengths = cache["cross_kv"], cache["enc_lengths"]

    def block(kind, p, x, r, c, kw):
        if not train:
            return _block_forward(cfg, kind, p, x, r, mode=mode, cache=c,
                                  common=kw) + (None,)

        def fn(x, r):
            aux = []
            x, r = _block_forward(
                cfg, kind, p, x, r, mode=mode, cache=None,
                common=dict(kw, aux=aux) if kind in ("attn", "shared_attn")
                else kw)
            return x, r, (aux[0] if aux else None)
        return checkpoint(fn, x, r, use_reentrant=False) if remat \
            else fn(x, r)

    for gname, kind, n in layer_pattern(cfg):
        gcache = cache.get(gname) if cache is not None else None
        gp = params["shared_attn"] if kind == "shared_attn" \
            else params[gname]
        for i in range(n):
            c = _slice(gcache, i) if gcache is not None else None
            kw = common
            if cross_kv is not None:
                kw = dict(common, cross=(_slice(params["cross_blocks"], i),
                                         _slice(cross_kv, i), enc_lengths))
            p = gp if kind == "shared_attn" else _slice(gp, i)
            x, r, aux = block(kind, p, x, r, c, kw)
            x = _constrain(x, act_spec)
            if aux is not None:
                aux_total = aux_total + aux
    if train:
        return x, r, aux_total
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


def _encode_audio(cfg: ModelConfig, params, frames, remat: bool = False,
                  act_spec=None):
    """Whisper-style encoder over precomputed frame embeddings (the stub
    front end): frames (B, S_enc, d) -> (B, S_enc, d).  Each layer: norm1,
    bidirectional :func:`attention.cross_attention` over every position,
    the residual, norm2, the FFN, the residual; then ``enc_norm``.  The
    learned ``enc_pos`` is the only position signal: the reference builds
    rope tables here and applies none.  ``remat``: each layer under
    ``torch.utils.checkpoint`` (training).  ``act_spec``: the residual's
    sharding after the position add and every layer (training under a
    mesh; left free, DTensor cuts S_enc over the model axis unevenly)."""
    pos = gather_fsdp(params["enc_pos"])
    x = _constrain(frames.to(pos.dtype) + pos[None], act_spec)

    def layer(p, x, r):
        x, h = add_rms_norm(x, r, p["norm1"], cfg.norm_eps)
        ap = p["attn"]
        q = linear(h, ap["wq"], ap.get("bq"))
        k = linear(h, ap["wk"], ap.get("bk"))
        v = linear(h, ap["wv"], ap.get("bv"))
        return _chunk_finish(cfg, p, x, attn_lib.cross_attention(q, k, v))

    r = None
    for i in range(cfg.encoder_layers):
        p = _slice(params["enc_blocks"], i)
        x, r = checkpoint(layer, p, x, r, use_reentrant=False) if remat \
            else layer(p, x, r)
        x = _constrain(x, act_spec)
    return add_rms_norm(x, r, params["enc_norm"], cfg.norm_eps)[1]


def _cross_kv_from_encoder(cfg: ModelConfig, params, enc_out, cross_kv=None):
    """Every decoder layer's cross K/V of the encoder output, {"k", "v"} of
    shape (layers, B, S_enc, Hkv, hd): written into ``cross_kv`` in place
    and returned, or (``cross_kv`` None, in training) stacked into new
    tensors."""
    def kv(i):
        ap = _slice(params["cross_blocks"]["attn"], i)
        return (linear(enc_out, ap["wk"], ap.get("bk")),
                linear(enc_out, ap["wv"], ap.get("bv")))

    if cross_kv is None:
        ks, vs = zip(*(kv(i) for i in range(cfg.n_layers)))
        return {"k": torch.stack(ks), "v": torch.stack(vs)}
    for i in range(cfg.n_layers):
        cross_kv["k"][i], cross_kv["v"][i] = kv(i)
    return cross_kv


def _prepare_inputs(cfg: ModelConfig, params, batch):
    """Embed the tokens; for vlm with ``patches`` (B, npt, d), put the
    projector MLP's output in place of the first npt positions."""
    x = _embed(params, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        proj = _mlp_forward(cfg, params["projector"], batch["patches"])
        npt, S = proj.shape[1], x.shape[1]
        if S < npt:
            # the reference fails here with a broadcasting error
            raise ValueError(f"vlm prefill of {S} positions cannot hold the "
                             f"{npt} image-patch positions it splices in")
        x[:, :npt] = proj.to(x.dtype)
    return x


def _chunked_lm_loss(cfg: ModelConfig, params, x, r, targets, mask, *,
                     chunk: int = 256):
    """The final norm (adding the last block's pending branch ``r``), the
    LM head and the cross entropy, over sequence chunks of ``chunk`` each
    under ``torch.utils.checkpoint``, so the fp32 (B, S, V) logits are
    never held whole; one pass over the whole sequence when S is not a
    multiple of ``chunk`` or not longer than it.  Returns the masked mean
    next-token loss."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if S % chunk != 0 or S <= chunk:
        return cross_entropy_loss(_lm_logits(cfg, params, x, r), targets,
                                  mask)

    def body(xs, rs, ts, ms):
        nll = token_nll(_lm_logits(cfg, params, xs, rs), ts)
        msf = ms.float()
        return (nll * msf).sum(), msf.sum()

    nll = x.new_zeros((), dtype=torch.float32)
    m = x.new_zeros((), dtype=torch.float32)
    for i in range(S // chunk):
        cols = slice(i * chunk, (i + 1) * chunk)
        a, b = checkpoint(body, x[:, cols].contiguous(),
                          None if r is None else r[:, cols].contiguous(),
                          targets[:, cols], mask[:, cols],
                          use_reentrant=False)
        nll, m = nll + a, m + b
    return nll / m.clamp_min(1.0)


# ==========================================================================
# Model-level API
# ==========================================================================

def loss_fn(cfg: ModelConfig, params, batch, *, mesh=None,
            batch_axes=("data",), act_spec=None, remat: bool = True):
    """Next-token LM loss plus ``router_aux_weight`` times the MoE
    load-balance loss.  batch: tokens (B, S), targets (B, S), mask (B, S)
    (optional), plus ``patches`` (vlm) or ``frames`` (audio; and
    ``enc_lengths``, optional).  ``remat``: each block (and each audio
    encoder layer) under ``torch.utils.checkpoint``.

    ``mesh``: params and batch are DTensors (placed by
    :mod:`repro_torch.launch.mesh`, FSDP's train-mode rules included); the
    MoE FFN runs over ``batch_axes`` and the model axis, ``act_spec`` (a
    ``NamedSharding``) constrains the residual stream after the embedding
    and every block, and the LM loss reduces its vocab-sharded logits over
    the model axis.  The loss comes back replicated."""
    with _mesh_scope(mesh):
        loss = _loss(cfg, params, batch, mesh=mesh, batch_axes=batch_axes,
                     act_spec=act_spec, remat=remat)
    if mesh is not None:
        from ..kernels.sharded import as_dtensor, replicated
        loss = as_dtensor(loss, mesh).redistribute(mesh, replicated(mesh))
    return loss


def _loss(cfg: ModelConfig, params, batch, *, mesh, batch_axes, act_spec,
          remat: bool):
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _prepare_inputs(cfg, params, batch)
    sin, cos = make_rope(torch.arange(S, device=tokens.device), cfg.hd,
                         cfg.rope_theta)
    common = dict(sin=sin[None], cos=cos[None], lengths=None)
    if mesh is not None:
        common.update(mesh=mesh, batch_axes=batch_axes)
    cross_kv = enc_lengths = None
    if cfg.family == "audio":
        enc = _encode_audio(cfg, params, batch["frames"], remat=remat,
                            act_spec=act_spec)
        cross_kv = _cross_kv_from_encoder(cfg, params, enc)
        enc_lengths = batch.get("enc_lengths")
    x, r, aux = _run_stack(cfg, params, x, mode="train", cache=None,
                           common=common, remat=remat, cross_kv=cross_kv,
                           enc_lengths=enc_lengths, act_spec=act_spec)
    loss = _chunked_lm_loss(cfg, params, x, r, batch["targets"],
                            batch.get("mask"))
    return loss + cfg.router_aux_weight * aux


def _mesh_scope(mesh):
    """Under a mesh, plain tensors made inside the model (rope tables,
    masks, positions) join DTensor ops as replicated."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _embed(params, tokens):
    """The token embedding: ``embed[tokens]``; on a DTensor table (its
    vocab maybe sharded) the embedding op, which DTensor shards, its
    pending sum over the vocab shards reduced at once (a vocab shard's
    pending sum holds a mask that serves one reduction only)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..kernels.sharded import is_dtensor
    table = params["embed"]
    if is_dtensor(table):
        from ..kernels.sharded import as_dtensor, kept, on_shards
        # train mode's FSDP cut of d is gathered first, as FSDP gathers a
        # weight before its use: DTensor's embedding takes a vocab cut
        # only
        mesh = table.device_mesh
        pl = tuple(p if p == Shard(0) else Replicate()
                   for p in table.placements)
        tokens = as_dtensor(tokens, mesh)
        if pl == (Replicate(),) * mesh.ndim:
            # the vocab whole: the plain lookup on each rank's rows
            tp = kept(tokens, {0: 0, 1: 1})
            return on_shards(lambda t, e: e[t.long()], (tokens, table),
                             (tp, pl), tp, mesh)
        table = table.redistribute(mesh, pl)
        x = F.embedding(tokens.long(), table)
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements))
    return params["embed"][tokens.long()]


def _placed_cache(cfg, cache, mesh, kv_shard: str):
    """``cache`` (plain tensors the same on every rank, or DTensors) under
    :func:`repro_torch.launch.mesh.cache_shardings`; the global batch is
    ``lengths``'s."""
    from ..launch.mesh import cache_shardings, distribute_tree
    sh = cache_shardings(cache, cfg, mesh, cache["lengths"].shape[0],
                         kv_shard=kv_shard)
    return distribute_tree(cache, sh)


def prefill_fn(cfg: ModelConfig, params, batch, *, max_len: int, mesh=None,
               batch_axes=("data",), act_spec=None):
    """Prefill: run the prompt, build the decode cache.

    batch: tokens (B, S), lengths (B,) true prompt lengths, plus
    ``patches`` (B, patch_tokens, d) for vlm (optional, as in the
    reference) or ``frames`` (B, encoder_seq, d) for audio, whose encoder
    runs here and fills the cache's ``cross_kv``; returns (last_logits
    (B, V), cache) with the :func:`init_cache` layout.

    ``mesh``: params and batch are DTensors (placed by
    :mod:`repro_torch.launch.mesh`; a plain tensor counts as replicated),
    the cache is made under ``cache_shardings`` (KV heads per the rules),
    the MoE FFN runs over ``batch_axes`` and the model axis, and
    ``act_spec`` (a ``NamedSharding``) constrains the residual stream."""
    with _mesh_scope(mesh):
        return _prefill(cfg, params, batch, max_len=max_len, mesh=mesh,
                        batch_axes=batch_axes, act_spec=act_spec)


def _prefill(cfg: ModelConfig, params, batch, *, max_len: int, mesh,
             batch_axes, act_spec):
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = lengths.to(torch.int32)
    x = _prepare_inputs(cfg, params, batch)
    sin, cos = make_rope(torch.arange(S, device=dev), cfg.hd,
                         cfg.rope_theta)
    cache = init_cache(cfg, B, max_len, device=dev)
    common = dict(sin=sin[None], cos=cos[None], lengths=lengths)
    if mesh is not None:
        cache = _placed_cache(cfg, cache, mesh, "heads")
        common.update(mesh=mesh, batch_axes=batch_axes)
    if cfg.family == "audio":
        _cross_kv_from_encoder(cfg, params,
                               _encode_audio(cfg, params, batch["frames"]),
                               cache["cross_kv"])
    x, r = _run_stack(cfg, params, x, mode="prefill", cache=cache,
                      common=common, act_spec=act_spec)
    if mesh is not None:
        from ..kernels.sharded import as_dtensor
        lengths = as_dtensor(lengths, mesh).redistribute(
            mesh, cache["lengths"].placements)
    cache["lengths"] = lengths
    return (_lm_logits(cfg, params, _last(x, lengths, S),
                       _last(r, lengths, S)), cache)


def decode_fn(cfg: ModelConfig, params, cache, tokens, *, mesh=None,
              batch_axes=("data",), kv_shard: str = "none"):
    """One decode step.  tokens: (B,) int32 — the tokens sampled last step.

    ``cache`` (the :func:`init_cache` layout, ``lengths`` counting the
    tokens so far) is updated IN PLACE: the new KV at ``lengths`` (rolling
    ``% L`` with a sliding window), every recurrent state, and ``lengths``
    + 1; audio reads its ``cross_kv`` and ``enc_lengths``.  Returns
    (logits (B, V), cache).

    ``mesh``: params and cache are DTensors (see :func:`prefill_fn`), each
    rank writing its own cache shard.  ``kv_shard="length"`` first moves
    the self-attention KV to the length-sharded layout of
    ``cache_shardings(..., kv_shard="length")`` (in the cache dict, once:
    a cache already so placed stays as it is) and attends through
    :func:`attention.decode_attention_lsharded`; any other value keeps the
    cache's layout and attends through K3 on each shard."""
    with _mesh_scope(mesh):
        if mesh is not None and kv_shard == "length":
            _length_shard_kv(cfg, cache, mesh)
        lengths = cache["lengths"] + 1
        x = _embed(params, tokens[:, None])
        pos = lengths.long() - 1
        sin, cos = make_rope(pos[:, None], cfg.hd, cfg.rope_theta)
        common = dict(sin=sin, cos=cos, lengths=lengths,
                      rolling=bool(cfg.sliding_window))
        if mesh is not None:
            common.update(mesh=mesh, batch_axes=batch_axes,
                          kv_shard=kv_shard)
        x, r = _run_stack(cfg, params, x, mode="decode", cache=cache,
                          common=common)
        cache["lengths"] = lengths
        return _lm_logits(cfg, params, x[:, 0], r[:, 0]), cache


def _length_shard_kv(cfg: ModelConfig, cache, mesh) -> None:
    """The self-attention K/V leaves of ``cache`` (not audio's
    ``cross_kv``) redistributed in the dict to the length-sharded
    layout."""
    from ..launch.mesh import cache_shardings
    sh = cache_shardings(cache, cfg, mesh, cache["lengths"].shape[0],
                         kv_shard="length")
    for gname, kind, _ in layer_pattern(cfg):
        if kind in ("attn", "shared_attn"):
            for n in ("k", "v"):
                t, s = cache[gname][n], sh[gname][n]
                if tuple(t.placements) != s.placements:
                    cache[gname][n] = t.redistribute(mesh, s.placements)


def supports_paged_stack(cfg: ModelConfig) -> bool:
    """True iff the decoder is a single homogeneous attention stack whose
    KV cache is pure (k, v) pairs: dense, moe and vlm without a sliding
    window, as in the reference.  The chunked and paged entry points embed
    tokens only, so vlm runs there as the dense decoder it is; the engine
    still refuses chunked prefill for vlm, whose prompt takes patches."""
    return (cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window)


def _require_paged_stack(cfg: ModelConfig, what: str) -> None:
    if not supports_paged_stack(cfg):
        raise ValueError(
            f"{what} supports only attention-family models without a "
            f"sliding window (dense/moe/vlm), got family={cfg.family!r} "
            f"sliding_window={cfg.sliding_window}")


def chunk_prefill_fn(cfg: ModelConfig, params, cache, tokens, offsets,
                     chunk_lens, *, mesh=None, batch_axes=("data",)):
    """Incremental prefill: run ONE chunk of each row's prompt against its
    (already partially filled) contiguous cache row.

    cache: {"lengths", "blocks": {"k", "v"}} with k/v (layers, n, L, Hkv,
    hd), updated in place; tokens: (n, C) right-padded; offsets: (n,)
    chunk start positions; chunk_lens: (n,) valid tokens (0 marks a
    padding row — its writes are dropped).  Returns (last_logits (n, V),
    cache) with ``lengths = offsets + chunk_lens``.  ``mesh``: the MoE FFN
    runs over it (see :func:`repro_torch.models.moe.moe_ffn`); the other
    tensors are plain, the same on every rank."""
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
        x, r = _chunk_finish(cfg, p, x, o, mesh=mesh, batch_axes=batch_axes)
    cache["lengths"] = kv_len.to(torch.int32)
    return (_lm_logits(cfg, params, _last(x, chunk_lens, C),
                       _last(r, chunk_lens, C)), cache)


def _kept_writes(blk, off, nb_pool: int):
    """The paged decode's KV writes as one fixed-shape scatter, with no
    host sync: a row whose ``blk`` is ``nb_pool`` (padding, frozen KV) is
    dropped by writing the first live row's value to that row's position
    again, so every duplicate destination gets the same bits and the
    scatter's order cannot matter.  Returns (src rows, blocks, offsets,
    live (B, 1, 1)); with no live row at all ``live`` is False and every
    row's destination is (0, 0), to be written with its own content."""
    keep = blk < nb_pool
    first = keep.int().argmax()                  # 0 when none is live
    src = torch.where(keep, torch.arange(blk.shape[0], device=blk.device),
                      first)
    live = keep[src]
    wblk = torch.where(live, blk[src].long(), 0)
    woff = torch.where(live, off[src].long(), 0)
    return src, wblk, woff, live[:, None, None]


def paged_decode_fn(cfg: ModelConfig, params, k_pool, v_pool, tables,
                    lengths, blk, off, tokens, *, block_size: int,
                    attn_impl: str = "kernel", mesh=None,
                    batch_axes=("data",)):
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

    ``mesh``: as in :func:`chunk_prefill_fn`.  Returns (next_tokens (n,)
    int32 greedy, k_pool, v_pool)."""
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
    src, wblk, woff, live = _kept_writes(blk, off, nb_pool)
    # no row live: every row rewrites position (0, 0) of each layer with
    # the content it had when the step began
    k00, v00 = k_pool[:, 0, 0], v_pool[:, 0, 0]
    r = None
    for i in range(cfg.n_layers):
        p = _slice(params["blocks"], i)
        kp, vp = k_pool[i], v_pool[i]
        x, q, k, v = _chunk_qkv(cfg, p, x, r, sin, cos)
        kp[wblk, woff] = torch.where(live, k[src, 0].to(kp.dtype), k00[i])
        vp[wblk, woff] = torch.where(live, v[src, 0].to(vp.dtype), v00[i])
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
        x, r = _chunk_finish(cfg, p, x, o[:, None], mesh=mesh,
                             batch_axes=batch_axes)
    logits = _lm_logits(cfg, params, x[:, 0], r[:, 0])
    return logits.argmax(-1).to(torch.int32), k_pool, v_pool


def paged_chunk_prefill_fn(cfg: ModelConfig, params, k_pool, v_pool, tables,
                           tokens, offsets, chunk_lens, wblk, woff, *,
                           block_size: int, mesh=None, batch_axes=("data",)):
    """Chunked prefill over the paged pool: write each chunk's KV into the
    rows' blocks (in place), then attend through a gathered contiguous
    view.  wblk/woff: (n, C) physical (block, offset) of every chunk token
    (``wblk == n_blocks`` marks a dropped write).  ``mesh``: as in
    :func:`chunk_prefill_fn`.  Returns (last_logits (n, V), k_pool,
    v_pool)."""
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
        x, r = _chunk_finish(cfg, p, x, o, mesh=mesh, batch_axes=batch_axes)
    return (_lm_logits(cfg, params, _last(x, chunk_lens, C),
                       _last(r, chunk_lens, C)), k_pool, v_pool)
