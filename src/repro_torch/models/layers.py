"""Primitive layers as plain functions on tensors.

The reference attaches logical sharding axes to every parameter; the port
runs on one card, so parameters are bare tensors in nested dicts that keep
the reference's layout (``wq (d, Hq, hd)``, ``wo (Hq, hd, d)``, stacked
layers on a leading axis).  Initializers take an explicit
``torch.Generator`` and ``device``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = [
    "rms_norm",
    "add_rms_norm",
    "make_rope",
    "apply_rope",
    "dense_init",
    "embed_init",
    "norm_init",
    "linear",
    "swiglu",
]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def dense_init(shape, *, generator: torch.Generator, device,
               scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in float32."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if scale is None:
        scale = 1.0 / np.sqrt(fan_in)
    v = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (v * scale).to(dtype)


def embed_init(vocab: int, d: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    v = torch.randn((vocab, d), dtype=torch.float32, device=device,
                    generator=generator)
    return (v / np.sqrt(d)).to(dtype)


def norm_init(dim: int, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# normalization / rotary
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm with fp32 accumulation: the port's RMS-norm kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    return ops.rms_norm(x, scale, eps)


def add_rms_norm(x, r, scale, eps: float = 1e-5):
    """The residual add and the RMSNorm that reads it, in one kernel launch
    on a CUDA tensor: returns ``(x + r, rms_norm(x + r))``.  ``r`` is None
    where there is nothing to add (the first block): ``(x, rms_norm(x))``."""
    if r is None:
        return x, ops.rms_norm(x, scale, eps)
    return ops.add_rms_norm(x, r, scale, eps)


def make_rope(positions, head_dim: int, theta: float = 1e4):
    """Rotary embedding tables for integer positions: (..., hd/2) sin/cos."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., seq, heads, hd); sin/cos: (..., seq, hd/2) or broadcastable."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# linear / MLP
# --------------------------------------------------------------------------

def linear(x, w, b=None):
    """x @ w (+ b), contracting x's last dim with w's first dim; ``w`` may
    carry extra trailing dims (e.g. (d, heads, hd)), kept in the output.
    Mixed dtypes promote, as the reference's einsum does (mLSTM's float32
    gate weights on bf16 activations)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    out = x @ w.reshape(w.shape[0], -1)
    out = out.reshape(x.shape[:-1] + w.shape[1:])
    if b is not None:
        out = out + b
    return out


def swiglu(x, w_in, w_gate, w_out):
    """SwiGLU MLP: (silu(x@w_gate) * (x@w_in)) @ w_out."""
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_in), w_out)
