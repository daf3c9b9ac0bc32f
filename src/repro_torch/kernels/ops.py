"""Public kernel dispatch for the port.

``on_cuda()`` takes the place of the reference's ``on_tpu()``: the
reference picks Pallas interpret mode off the TPU, while here each wrapper
picks by the device of the tensor it is given — the hand-written Hopper
kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
There is no silent fallback: a CUDA tensor that the kernel cannot take
raises.
"""
from __future__ import annotations

import torch

from .bfio_swap import swap_best
from .paged_attention import paged_decode_attention
from .rms_norm import rms_norm

__all__ = ["on_cuda", "rms_norm", "paged_decode_attention", "swap_best"]


def on_cuda() -> bool:
    return torch.cuda.is_available()
