"""Fused RMS norm: ``x * rsqrt(mean(x^2) + eps) * scale`` per row, fp32
accumulation, output in x's dtype.

Replaces the Pallas TPU kernel ``repro/kernels/rms_norm.py:
rms_norm_pallas``.  On an H100 the kernel (``csrc/rms_norm.cu``) is bound
by memory bytes at large row counts; at the serving shapes ((<=32) x 4096
bf16, about 0.5 MB) it is bound by its launch.  Its design: one block per
row, 16-byte vector loads, a warp-shuffle plus shared-memory fp32 sum of
squares, and one write of the scaled row — a single device-memory round
trip.

:func:`rms_norm` is the wrapper: on a CPU tensor it runs
:func:`rms_norm_plain` (the plain PyTorch version of the same function);
on a CUDA tensor it launches the kernel or raises — it never falls back.
``rms_norm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["rms_norm", "rms_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch RMS norm (the kernel's reference and CPU path)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _lib():
    from .build import load
    lib = load("rms_norm.cu")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32/bfloat16; scale: (d,) float32.  Returns x's
    shape and dtype."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise TypeError(f"rms_norm kernel needs a float32 scale of shape "
                        f"({d},), got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device or not scale.is_contiguous():
        raise ValueError("rms_norm: scale must be contiguous on x's device")
    if not x.is_contiguous():
        raise ValueError("rms_norm kernel needs a contiguous x")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    pack = 16 // x.element_size()
    vectorized = int(d % pack == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    rc = _lib()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                float(eps), _DTYPES[x.dtype], vectorized,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
