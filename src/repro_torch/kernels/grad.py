"""Where autograd meets a kernel wrapper.

On a CPU tensor every wrapper runs its plain PyTorch version, which
autograd differentiates as it stands.  On a CUDA tensor a wrapper
launches its kernel through ctypes into a fresh output that has no
``grad_fn``, so a wrapper whose kernel has no backward refuses to run
when autograd would need one, rather than cut the gradient silently.
K2 (``rms_norm``, backward ``rms_norm_bwd``) and K5 (``ssm_chunk_scan``,
backward ``ssm_chunk_scan_bwd``) take the autograd path instead.  The
decode attentions, K1 and K3, refuse: they serve inference only, and
training attends through ``models/attention.blocked_causal_attention``.
"""
from __future__ import annotations

import torch

__all__ = ["wants_grad", "refuse_grad"]


def wants_grad(*tensors) -> bool:
    """True when grad mode is on and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need the backward of kernel ``name``, which
    it does not have on the card."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the Hopper kernel has no backward, and an input "
            f"requires grad with grad mode on (it serves inference only, "
            f"as ROADMAP Queue A item 14 settled); call it under "
            f"torch.no_grad(), or on CPU tensors, whose plain path autograd "
            f"differentiates")
