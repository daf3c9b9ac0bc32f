"""Primitive layers as plain functions on tensors.

The reference attaches logical sharding axes to every parameter; the port
runs on one card, so parameters are bare tensors in nested dicts that keep
the reference's layout (``wq (d, Hq, hd)``, ``wo (Hq, hd, d)``, stacked
layers on a leading axis).  Initializers take an explicit
``torch.Generator`` and ``device``.  :class:`Param` with
:func:`split_params` / :func:`merge_params` keeps the reference's
(value, logical axes) pairing for code that carries axes along, and
:func:`tree_map` / :func:`tree_leaves` walk the nested dicts and tuples
as JAX walks a pytree (dict keys in sorted order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = [
    "Param",
    "split_params",
    "merge_params",
    "tree_map",
    "tree_leaves",
    "rms_norm",
    "add_rms_norm",
    "layer_norm",
    "make_rope",
    "apply_rope",
    "dense_init",
    "embed_init",
    "norm_init",
    "linear",
    "swiglu",
    "gelu_mlp",
    "cross_entropy_loss",
]

PyTree = Any


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Param:
    """A parameter plus its logical sharding axes (one name per dim)."""

    value: Any
    axes: tuple

    def __post_init__(self) -> None:
        assert len(self.axes) == self.value.ndim, (
            f"axes {self.axes} vs shape {tuple(self.value.shape)}")


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """``fn`` over the leaves of nested dicts, tuples and lists (``rest``:
    trees of the same structure, their leaves passed alongside); None is
    an empty subtree, as in JAX."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves in JAX's order: dict entries by sorted key, sequences in
    order, None dropped."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                               is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def _is_param(x) -> bool:
    return isinstance(x, Param)


def split_params(tree: PyTree) -> tuple[PyTree, PyTree]:
    """Split a Param tree into (values, logical_axes) trees."""
    return (tree_map(lambda p: p.value, tree, is_leaf=_is_param),
            tree_map(lambda p: p.axes, tree, is_leaf=_is_param))


def merge_params(values: PyTree, axes: PyTree) -> PyTree:
    """The inverse of :func:`split_params`: a tensor (or numpy array) leaf
    of ``values`` and the axes tuple at the same place make a Param."""
    def is_array(x):
        return isinstance(x, (torch.Tensor, np.ndarray))
    return tree_map(lambda v, a: Param(v, a), values, axes,
                    is_leaf=is_array)


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
    return v.mul_(scale).to(dtype)


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


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32 (population variance), cast back to x's dtype.
    Plain PyTorch: the reference has no kernel for it, and no model path
    calls it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


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
    fsdp = _fsdp_cut(w)
    w = gather_fsdp(w)
    if w.dim() > 2 and sharded_dims(w, range(1, w.dim())):
        return _linear_sharded(x, w, b)
    if w.dim() > 2 and fsdp:
        return _linear_whole(x, w, b)
    out = x @ w.reshape(w.shape[0], -1)
    out = out.reshape(x.shape[:-1] + w.shape[1:])
    if b is not None:
        out = out + b
    return out


def sharded_dims(t, dims) -> list:
    """The dims among ``dims`` that a DTensor ``t`` shards (none for a
    plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return []
    cut = {p.dim % t.dim() for p in t.placements if isinstance(p, Shard)}
    return [d for d in dims if d in cut]


_FSDP_AXES = ("pod", "data")


def _fsdp_cut(w) -> bool:
    """Whether a DTensor weight is cut over a batch mesh axis: train
    mode's FSDP cut of its d (``"embed"``) dim."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(w, DTensor) and any(
        isinstance(p, Shard) and name in _FSDP_AXES
        for p, name in zip(w.placements, w.device_mesh.mesh_dim_names))


def gather_fsdp(w):
    """A DTensor weight with its FSDP cut gathered whole, as FSDP gathers
    a weight before its use (its gradient comes back reduce-scattered);
    any other weight as it is.  Left cut, DTensor's product with
    batch-sharded activations may gather the batch instead, and every rank
    would multiply every row."""
    from torch.distributed.tensor import Replicate, Shard
    if not _fsdp_cut(w):
        return w
    return w.redistribute(w.device_mesh, tuple(
        Replicate() if isinstance(p, Shard) and name in _FSDP_AXES else p
        for p, name in zip(w.placements, w.device_mesh.mesh_dim_names)))


def _linear_whole(x, w, b=None):
    """:func:`linear` for a gathered FSDP weight of more than two dims that
    nothing else cuts (granite-8b's 8 KV heads over a model axis of 16):
    each rank multiplies its rows of x by the whole weight.  DTensor's own
    product would cut the flattened output dim into pieces no view splits
    back into heads."""
    from ..kernels.sharded import as_dtensor, kept, on_shards, replicated
    mesh = w.device_mesh
    x = as_dtensor(x, mesh)
    xp = kept(x, {i: i for i in range(x.dim() - 1)})
    out = on_shards(linear, (x, w), (xp, replicated(mesh)), xp, mesh)
    return out if b is None else out + b


def _linear_sharded(x, w, b=None):
    """:func:`linear` for a DTensor weight whose trailing dims are sharded:
    the sharded ones go first before the flatten, and back after, so the
    flattened weight keeps a plain shard (DTensor cannot multiply a
    strided one)."""
    trail = list(range(1, w.dim()))
    cut = sharded_dims(w, trail)
    perm = [0] + cut + [d for d in trail if d not in cut]
    wp = w.permute(perm)
    out = x @ wp.reshape(w.shape[0], -1)
    out = out.reshape(x.shape[:-1] + wp.shape[1:])
    lead = x.dim() - 1
    inv = [0] * len(trail)
    for i, d in enumerate(perm[1:]):
        inv[d - 1] = i
    out = out.permute(list(range(lead)) + [lead + i for i in inv])
    if b is not None:
        out = out + b
    return out


def swiglu(x, w_in, w_gate, w_out):
    """SwiGLU MLP: (silu(x@w_gate) * (x@w_in)) @ w_out."""
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_in), w_out)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """Classic GELU MLP (Whisper-style), the tanh GELU as the reference's
    ``jax.nn.gelu``.  No model path calls it."""
    return linear(F.gelu(linear(x, w_in, b_in), approximate="tanh"), w_out,
                  b_out)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def token_nll(logits, targets):
    """Each position's ``logsumexp(logits) - logits[target]`` in fp32.  On
    DTensor logits whose vocab is sharded (the LM head's vocab cut over
    the model axis) every rank works on its vocab slice: its max, reduced
    over the ranks, then its sum of exponentials and the gold logit where
    the target falls in its slice, each a pending sum reduced over the
    ranks, as the reference's sharded logits reduce."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        return _token_nll_sharded(logits, targets)
    return _token_nll(logits, targets)


def _token_nll(logits, targets):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def _token_nll_sharded(logits, targets):
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..kernels.sharded import as_dtensor, on_shards
    mesh = logits.device_mesh
    nd = logits.dim()
    vdim = nd - 1
    lp = tuple(p if isinstance(p, Shard) else Replicate()
               for p in logits.placements)
    rows = tuple(p if isinstance(p, Shard) and p.dim % nd != vdim
                 else Replicate() for p in lp)        # (..., ) per position
    targets = as_dtensor(targets, mesh)
    if lp == rows:         # the vocab whole on every rank: the plain loss
        return on_shards(_token_nll, (logits, targets), (lp, rows), rows,
                         mesh)

    def reduced(op):
        return tuple(Partial(op) if isinstance(p, Shard)
                     and p.dim % nd == vdim else r
                     for p, r in zip(lp, rows))
    with torch.no_grad():
        m = on_shards(lambda lg: lg.float().amax(dim=-1), (logits,), (lp,),
                      reduced("max"), mesh).redistribute(mesh, rows)

    def local(lg, ml, tl):
        lg = lg.float()
        v0 = 0
        for i, p in enumerate(lp):
            if isinstance(p, Shard) and p.dim % nd == vdim:
                v0 = v0 * mesh.size(i) + mesh.get_local_rank(i)
        v0 *= lg.shape[-1]
        se = torch.exp(lg - ml[..., None]).sum(dim=-1)
        t = tl.long() - v0
        inside = (t >= 0) & (t < lg.shape[-1])
        gold = torch.gather(lg, -1, t.clamp(0, lg.shape[-1] - 1)[..., None])
        return se, torch.where(inside, gold[..., 0], torch.zeros_like(se))
    se, gold = on_shards(local, (logits, m, targets), (lp, rows, rows),
                         (reduced("sum"), reduced("sum")), mesh)
    se, gold = se.redistribute(mesh, rows), gold.redistribute(mesh, rows)
    return m + torch.log(se) - gold


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token cross entropy in fp32; mask: (B, S) float weights."""
    nll = token_nll(logits, targets)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
