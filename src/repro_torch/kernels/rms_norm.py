"""Fused RMS norm: ``x * rsqrt(mean(x^2) + eps) * scale`` per row, fp32
accumulation, output in x's dtype; and the same norm with the residual add
in front of it, ``s = x + r; (s, rms_norm(s))``.

Replaces the Pallas TPU kernel ``repro/kernels/rms_norm.py:
rms_norm_pallas``; the residual add is the neighbour that XLA fuses into
the reference's jnp norm (``repro/models/layers.py:rms_norm``).  On an
H100 the kernel (``csrc/rms_norm.cu``) is bound by memory bytes; at the
serving shapes ((<=32) x 4096 bf16) by its launch's latency.  Its design:
one CTA a row, one read of the row into registers (16-byte packs), the
scale loaded before the reduction, one barrier.

:func:`rms_norm` and :func:`add_rms_norm` are the wrappers: on a CPU
tensor they run :func:`rms_norm_plain` / :func:`add_rms_norm_plain` (the
plain PyTorch versions of the same functions); on a CUDA tensor they
launch the kernel or raise — they never fall back.  Both count their
launches on ``rms_norm.launches``.

Training: the reference differentiates its jnp norm; on a CUDA tensor the
port's launch writes an output without a ``grad_fn``, so when grad mode
is on and an input requires grad the wrappers go through
``torch.autograd.Function``s whose forward is the same launch and whose
backward is the hand-written :func:`rms_norm_bwd` (``rms_norm_bwd`` in the
same source; it has no TPU counterpart).  It counts its launches on
``rms_norm_bwd.launches``; :func:`rms_norm_bwd_plain` is its plain
version.  Without grad (serving) the wrappers launch directly, as before;
on a CPU tensor autograd runs through the plain forward.

On a DTensor (a model under a mesh) both wrappers run on each local shard
with the normalised last dim whole (:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .grad import wants_grad
from .sharded import as_dtensor, is_dtensor, kept, on_shards, replicated

__all__ = ["rms_norm", "rms_norm_plain", "add_rms_norm",
           "add_rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch RMS norm (the kernel's reference and CPU path)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def add_rms_norm_plain(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-5):
    """Plain residual add + RMS norm: ``(x + r, rms_norm_plain(x + r))``."""
    s = x + r
    return s, rms_norm_plain(s, scale, eps)


def rms_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                       scale: torch.Tensor, eps: float = 1e-5,
                       gs: Optional[torch.Tensor] = None):
    """Plain PyTorch backward of :func:`rms_norm_plain` at input ``x``
    given the gradient ``g`` of its output: returns (dx in x's dtype,
    dscale float32 (d,)).  ``gs`` (the fused call's gradient of ``s = x +
    r``) is added into dx before the rounding."""
    d = x.shape[-1]
    xf, gf = x.float(), g.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = gf * scale.float()
    c = (gw * xf).mean(dim=-1, keepdim=True)
    dx = rstd * gw - xf * (rstd * rstd * rstd * c)
    if gs is not None:
        dx = dx + gs.float()
    dscale = (gf * xf * rstd).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale


def _lib(name: str = "rms_norm_launch"):
    from .build import load
    fn = getattr(load("rms_norm.cu"), name)
    if fn.argtypes is None:
        if name == "rms_norm_launch":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, r, scale, eps):
    """One kernel launch on CUDA tensors: returns ``(out, s)``, ``s = x +
    r`` (None without ``r``)."""
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise TypeError(f"rms_norm kernel needs a float32 scale of shape "
                        f"({d},), got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device or not scale.is_contiguous():
        raise ValueError("rms_norm: scale must be contiguous on x's device")
    if not x.is_contiguous() or (r is not None and not r.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous inputs")
    out = torch.empty_like(x)
    s = None if r is None else torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out, s
    rc = _lib()(x.data_ptr(), None if r is None else r.data_ptr(),
                scale.data_ptr(), out.data_ptr(),
                None if s is None else s.data_ptr(), rows, d, float(eps),
                _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    rms_norm.launches += 1
    return out, s


def _check_device(x):
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")


#: input rows a CTA of the backward takes, at most: about 512 CTAs (four
#: an SM) at a training batch's rows, one row a CTA at decode sizes
BWD_TARGET_CTAS = 512


def bwd_rows_per_cta(rows: int) -> int:
    """Input rows a CTA of :func:`rms_norm_bwd` takes."""
    return max(1, -(-rows // BWD_TARGET_CTAS))


def rms_norm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5, gs: Optional[torch.Tensor] = None):
    """The backward of the norm at input ``x`` (the sum ``s`` for the
    fused call) given the gradient ``g`` of its output, and with ``gs``
    the gradient of ``s`` added into dx.  Returns (dx in x's dtype,
    dscale float32 (d,)).  The kernel on a CUDA tensor (two launches from
    one call: the rows, then the column sums of the CTAs' dscale partials
    in a fixed order), its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, g, scale, eps, gs)
    _check_device(x)
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm_bwd kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("g", g), ("gs", gs)):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"rms_norm_bwd: {name} {t.dtype} "
                             f"{tuple(t.shape)} does not match x {x.dtype} "
                             f"{tuple(x.shape)}, or is not contiguous")
    if scale.dtype != torch.float32 or scale.shape != (d,) \
            or scale.device != x.device or not scale.is_contiguous():
        raise TypeError(f"rms_norm_bwd kernel needs a contiguous float32 "
                        f"scale of shape ({d},) on x's device, got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if not x.is_contiguous():
        raise ValueError("rms_norm_bwd kernel needs a contiguous x")
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    rpb = bwd_rows_per_cta(rows)
    partial = torch.empty((-(-rows // rpb), d), dtype=torch.float32,
                          device=x.device)
    dscale = torch.empty_like(scale)
    rc = _lib("rms_norm_bwd_launch")(
        x.data_ptr(), g.data_ptr(), None if gs is None else gs.data_ptr(),
        scale.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), rows, d, rpb, float(eps), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    rms_norm_bwd.launches += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """K2's launch with :func:`rms_norm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out = _launch(x, None, scale, eps)[0]
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, g.contiguous(), scale, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


class _AddRMSNorm(torch.autograd.Function):
    """K2's fused launch (``s = x + r`` and the norm of s) with
    :func:`rms_norm_bwd` as its backward: the gradient of s, from the norm
    and from s's own uses, is the gradient of both x and r."""

    @staticmethod
    def forward(ctx, x, r, scale, eps):
        out, s = _launch(x, r, scale, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, out

    @staticmethod
    def backward(ctx, gs, gout):
        s, scale = ctx.saved_tensors
        if gout is None:
            return gs, gs, None, None
        ds, dscale = rms_norm_bwd(
            s, gout.contiguous(), scale, ctx.eps,
            None if gs is None else gs.contiguous())
        return ds, ds, dscale if ctx.needs_input_grad[2] else None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32/bfloat16; scale: (d,) float32 (any float dtype
    when autograd takes the kernel's Function, which widens it).  Returns
    x's shape and dtype."""
    if is_dtensor(x):
        return _on_shards(x, None, scale, eps)
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    _check_device(x)
    if wants_grad(x, scale):
        return _RMSNorm.apply(x.contiguous(), scale.float(), eps)
    return _launch(x, None, scale, eps)[0]


def add_rms_norm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5):
    """``s = x + r`` and ``rms_norm(s)`` from one launch: returns ``(s,
    normed)``.  x, r: (..., d) of one shape and dtype.  ``s`` is rounded to
    that dtype before the norm reads it, so on aligned rows the result
    equals ``rms_norm(x + r)`` through the kernel bit for bit."""
    if is_dtensor(x) or is_dtensor(r):
        return _on_shards(x, r, scale, eps)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, r, scale, eps)
    _check_device(x)
    if r.shape != x.shape or r.device != x.device or r.dtype != x.dtype:
        raise ValueError(f"add_rms_norm: r {r.dtype} {tuple(r.shape)} on "
                         f"{r.device} does not match x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if wants_grad(x, r, scale):
        return _AddRMSNorm.apply(x.contiguous(), r.contiguous(),
                                 scale.float(), eps)
    out, s = _launch(x, r, scale, eps)
    return s, out


def _on_shards(x, r, scale, eps):
    """The wrappers on DTensors: every dim but the last may stay sharded."""
    mesh = (x if is_dtensor(x) else r).device_mesh
    x, r, scale = (as_dtensor(t, mesh) for t in (x, r, scale))
    pl = kept(x, {i: i for i in range(x.dim() - 1)})
    rep = replicated(mesh)
    if r is None:
        return on_shards(lambda a, s: rms_norm(a, s, eps), (x, scale),
                         (pl, rep), pl, mesh)
    return on_shards(lambda a, b, s: add_rms_norm(a, b, s, eps),
                     (x, r, scale), (pl, pl, rep), (pl, pl), mesh)


rms_norm.launches = 0
rms_norm_bwd.launches = 0
