"""Weights across: the reference package's parameter tree, given as nested
dicts of numpy arrays, into the port's parameters.

The reference stores parameters in exactly the layout the port keeps
(stacked layers on a leading axis, ``wq (d, Hq, hd)``, ``wo (Hq, hd,
d)``), so the bridge is a leaf-by-leaf map.  numpy has no bfloat16 of its
own: a bf16 leaf arrives as the ml_dtypes ``bfloat16`` numpy dtype (or
already widened), goes through float32 — which is exact — and is narrowed
back on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .transformer import resolve_device, torch_dtype

__all__ = ["params_from_numpy"]


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a private, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype=None):
    """Map a nested dict of numpy arrays onto tensors on ``device``
    (``cuda`` unless asked otherwise).  ``dtype`` (a torch dtype or its
    name) casts every floating-point leaf; None keeps each leaf's own."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dt) for k, v in tree.items()}
    return _leaf(tree, dev, dt)
