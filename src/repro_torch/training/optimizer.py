"""AdamW with gradient clipping and a cosine schedule, on tensors in
float32: the reference's formula (``repro/training/optimizer.py``), not
``torch.optim.AdamW``, whose update and rounding differ.

State mirrors the params: fp32 m and v trees and a step counter.  Under
a mesh (DTensor params) m and v are placed like the params and the step
is replicated; each rank updates its own shards.  The
update is functional by default, as the reference's; ``donate=True``
writes the new params, m and v into the given tensors instead (the
port's counterpart of donating buffers to a jitted step), which keeps a
full-size train step from holding two copies of the optimizer state.
Every operation of one leaf's update is the reference's, in its order,
so the roundings are its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models.layers import tree_leaves, tree_map

PyTree = Any

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    m: PyTree               # fp32, like params
    v: PyTree               # fp32, like params


def init_opt_state(params: PyTree) -> OptState:
    """Zero m and v (float32, on each leaf's device; DTensors placed like
    their params) and step 0 (replicated over the params' mesh)."""
    from torch.distributed.tensor import DTensor, Replicate

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    leaf = tree_leaves(params)[0]
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        step = DTensor.from_local(
            torch.zeros((), dtype=torch.int32, device=leaf.to_local().device),
            mesh, [Replicate()] * mesh.ndim, run_check=False)
    else:
        step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return OptState(step=step, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac * lr`` at ``total_steps``; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: PyTree):
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in the reference's (sorted-key) order.  On DTensors each leaf's
    sum is a pending sum over its shards, reduced across the ranks before
    the square root."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params: PyTree, grads: PyTree,
                 state: OptState, *, donate: bool = False
                 ) -> tuple[PyTree, OptState]:
    """One AdamW step (params fp32 master copies; a leaf of another dtype
    is updated in float32 and rounded back).  ``donate``: update params,
    m and v in place and return them (see the module docstring)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        if not donate:
            m, v = m.clone(), v.clone()
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        del g
        u = m / b1c                             # m hat
        u.div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        if p32 is p and not donate:
            p32 = p.clone()
        u.add_(cfg.weight_decay * p32)
        p32.sub_(lr * u)
        if donate and p32 is not p:
            p.copy_(p32)
        return (p if donate else p32.to(p.dtype)), m, v

    out = tree_map(upd, params, grads, state.m, state.v)

    def part(i):
        return tree_map(lambda t: t[i], out,
                        is_leaf=lambda x: isinstance(x, tuple)
                        and len(x) == 3 and isinstance(x[0], torch.Tensor))
    return part(0), OptState(step=step, m=part(1), v=part(2))
