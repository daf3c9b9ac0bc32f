"""Minimal checkpointing: flat-key .npz snapshots of (params, opt state,
step) with a JSON sidecar, in the reference's format
(``repro/training/checkpoint.py``): a leaf's key is the ``"/"``-joined
path of dict keys and sequence indices, so a checkpoint written by either
package loads in the other.  numpy has no bfloat16, so a bfloat16 leaf is
written as float32 (exact) and cast back on load, as every leaf is cast to
the dtype of its place in ``like``.  A DTensor leaf (training under a
mesh) is written whole (``full_tensor``) and a leaf whose place in
``like`` is a DTensor is placed like it, so a checkpoint written under a
mesh loads with none, and the reverse."""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

PyTree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _with_paths(tree: PyTree, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _rebuild(tree: PyTree, leaves: dict, prefix: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {_key(p): _numpy(leaf) for p, leaf in _with_paths(tree)}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    np.savez(path, **flat)
    meta = {"step": step, "keys": sorted(flat.keys())}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(ckpt_dir: str, like: PyTree, step: int | None = None
                    ) -> tuple[PyTree, int]:
    """Restore into the structure of ``like`` (shapes must match): each
    leaf a tensor of the dtype and on the device of its place in
    ``like``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    leaves = {}
    with np.load(path) as data:
        for p, leaf in _with_paths(like):
            key = _key(p)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(np.array(arr, dtype=np.float32)
                                 if arr.dtype.name == "bfloat16" else arr)
            leaves[p] = _placed_like(t, leaf)
    return _rebuild(like, leaves), step


def _placed_like(t: torch.Tensor, like):
    """``t`` (whole) with the dtype, device and, for a DTensor ``like``,
    the mesh and placements of ``like``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(like, DTensor):
        t = t.to(device=like.to_local().device, dtype=like.dtype)
        return distribute_tensor(t, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t.to(device=like.device, dtype=like.dtype)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[5:13]) for f in os.listdir(ckpt_dir)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None
