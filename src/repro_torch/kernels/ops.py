"""Public kernel dispatch for the port.

``on_cuda()`` takes the place of the reference's ``on_tpu()``: the
reference picks Pallas interpret mode off the TPU, while here each wrapper
picks by the device of the tensor it is given — the hand-written Hopper
kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
There is no silent fallback: a CUDA tensor that the kernel cannot take
raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .bfio_swap import swap_best
from .decode_attention import decode_attention
from .paged_attention import paged_decode_attention
from .rms_norm import add_rms_norm, rms_norm
from .sharded import is_dtensor
from .ssm_scan import on_shards as _ssm_on_shards
from .ssm_scan import ssm_chunk_scan as _ssm_chunk_scan

__all__ = ["on_cuda", "rms_norm", "add_rms_norm", "paged_decode_attention",
           "swap_best", "decode_attention", "ssm_chunk_scan"]


def on_cuda() -> bool:
    return torch.cuda.is_available()


def ssm_chunk_scan(q, k, v, log_decay, gate, *, chunk: int = 128,
                   initial_state: Optional[torch.Tensor] = None):
    """Gated linear-attention scan (see ssm_scan.py) on any S: pads S with
    zero steps (no decay, no input) up to a multiple of ``chunk``, as the
    reference's ``ops.ssm_chunk_scan`` does, and drops them from y.  On
    DTensors the whole of it runs on each local shard (the batch rows as
    v shards them)."""
    if is_dtensor(q) or is_dtensor(v):
        return _ssm_on_shards(ssm_chunk_scan, q, k, v, log_decay, gate,
                              chunk=chunk, initial_state=initial_state)
    S = q.shape[1]
    pad = (-S) % chunk
    if pad:
        def padseq(x):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        q, k, v = padseq(q), padseq(k), padseq(v)
        log_decay, gate = padseq(log_decay), padseq(gate)
    y, state = _ssm_chunk_scan(q, k, v, log_decay, gate, chunk=chunk,
                               initial_state=initial_state)
    return y[:, :S], state
