"""Weights across: the reference package's parameter tree, given as nested
dicts of numpy arrays, into the port's parameters.

The reference stores parameters in exactly the layout the port keeps
(each group of ``layer_pattern`` stacked on a leading axis — ``blocks``,
xlstm's ``m{i}``/``s{i}``, zamba2's ``m{i}``/``m_tail`` — zamba2's
unstacked ``shared_attn``, ``wq (d, Hq, hd)``, ``wo (Hq, hd, d)``), so
the bridge is a leaf-by-leaf map; tuples (a cache's sLSTM ``hcnm``) map
element by element.  numpy has no bfloat16 of its
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
    """Map nested dicts (and tuples) of numpy arrays onto tensors on ``device``
    (``cuda`` unless asked otherwise).  ``dtype`` (a torch dtype or its
    name) casts every floating-point leaf; None keeps each leaf's own."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dt) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, dev, dt) for v in tree)
    return _leaf(tree, dev, dt)
