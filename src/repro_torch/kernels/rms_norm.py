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
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["rms_norm", "rms_norm_plain", "add_rms_norm",
           "add_rms_norm_plain"]

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


def _lib():
    from .build import load
    lib = load("rms_norm.cu")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32/bfloat16; scale: (d,) float32.  Returns x's
    shape and dtype."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    _check_device(x)
    return _launch(x, None, scale, eps)[0]


def add_rms_norm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5):
    """``s = x + r`` and ``rms_norm(s)`` from one launch: returns ``(s,
    normed)``.  x, r: (..., d) of one shape and dtype.  ``s`` is rounded to
    that dtype before the norm reads it, so on aligned rows the result
    equals ``rms_norm(x + r)`` through the kernel bit for bit."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, r, scale, eps)
    _check_device(x)
    if r.shape != x.shape or r.device != x.device or r.dtype != x.dtype:
        raise ValueError(f"add_rms_norm: r {r.dtype} {tuple(r.shape)} on "
                         f"{r.device} does not match x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    out, s = _launch(x, r, scale, eps)
    return s, out


rms_norm.launches = 0
