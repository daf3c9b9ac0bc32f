"""Training loop: the train step (loss, gradients, AdamW) and a host loop
with logging and checkpointing, the reference's
(``repro/training/train_loop.py``) on tensors.

The reference jits its step; here it runs eagerly, gradients by autograd
through :func:`repro_torch.models.loss_fn` (on a card: K2 with its
backward kernel at every norm).  Training runs on one card, so the mesh
arguments must be None: training under a mesh is ROADMAP Queue A item
12c (item 12b ported the mesh for serving).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..models import loss_fn, torch_dtype
from ..models.layers import tree_leaves, tree_map
from .checkpoint import save_checkpoint
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

PyTree = Any

__all__ = ["TrainState", "make_train_step", "train"]


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt: OptState


def _value_and_grad(lf, params, batch):
    """(loss, grads) of ``lf(params, batch)``: each floating leaf a
    detached view that requires grad (no copy); a leaf the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives."""
    def leaf(t):
        return t.detach().requires_grad_(t.is_floating_point())
    ps = tree_map(leaf, params)
    flat = [t for t in tree_leaves(ps) if t.requires_grad]
    loss = lf(ps, batch)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, gs)}
    return loss.detach(), tree_map(
        lambda t: by_id.get(id(t), torch.zeros_like(t)), ps)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, mesh=None,
                    batch_axes=("data",), act_spec=None,
                    compute_dtype="bfloat16", grad_accum: int = 1,
                    grad_shardings=None, remat: bool = True,
                    donate: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (loss, params, opt).

    Mixed precision: fp32 master params are cast to ``compute_dtype``
    inside the loss (float32 leaves of more than one dimension only: norm
    scales and biases stay float32), so the matmuls run in that dtype;
    grads flow back into fp32 Adam state.  ``grad_accum`` > 1 splits the
    batch into that many microbatches, one after another, summing their
    gradients in float32 and dividing by the count.  ``donate``: the step
    updates params and opt_state in place (see ``adamw_update``).
    ``mesh``, ``act_spec`` and ``grad_shardings`` must be None (training
    under a mesh is ROADMAP Queue A item 12c); ``batch_axes`` only names a
    mesh's axes."""
    if mesh is not None or act_spec is not None or grad_shardings is not None:
        raise NotImplementedError(
            "make_train_step: training under a mesh is not ported yet "
            "(ROADMAP Queue A item 12c; item 12b ported the mesh for "
            "serving); pass mesh=None, act_spec=None, grad_shardings=None")
    cdt = torch_dtype(compute_dtype)

    def cast(p):
        return p.to(cdt) if (p.dtype == torch.float32 and p.dim() > 1) \
            else p

    def lf(p, mb):
        return loss_fn(cfg, tree_map(cast, p), mb, remat=remat)

    def train_step(params, opt_state, batch):
        if grad_accum <= 1:
            loss, grads = _value_and_grad(lf, params, batch)
        else:
            B = tree_leaves(batch)[0].shape[0]
            assert B % grad_accum == 0, (B, grad_accum)
            mbsz = B // grad_accum
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                mb = tree_map(lambda x: x[i * mbsz:(i + 1) * mbsz], batch)
                l, g = _value_and_grad(lf, params, mb)
                grads = tree_map(lambda a, b: a.add_(b.float()), grads, g)
                lsum = lsum + l
                del g
            loss = lsum / grad_accum
            grads = tree_map(lambda g: g.div_(grad_accum), grads)
        new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state,
                                           donate=donate)
        return loss, new_params, new_opt

    return train_step


def train(
    cfg: ModelConfig,
    *,
    params: PyTree,
    batches,
    opt_cfg: Optional[AdamWConfig] = None,
    mesh=None,
    log_every: int = 10,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    log_fn=print,
    compute_dtype: str = "bfloat16",
) -> tuple[PyTree, list[float]]:
    """Host training loop over an iterable of batches (dicts of numpy
    arrays or tensors, moved to the params' device); returns the trained
    params and the loss history.

    ``params`` are updated in place, as buffers donated to a jitted step
    are: the returned tree holds the same tensors.  ``compute_dtype``
    (the reference's train step default, bfloat16, unless asked) is the
    one argument the reference's ``train`` does not take."""
    opt_cfg = opt_cfg or AdamWConfig()
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                              compute_dtype=compute_dtype, donate=True)
    device = tree_leaves(params)[0].device
    losses = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss, params, opt_state = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            log_fn(f"step {i:5d} loss {losses[-1]:.4f} "
                   f"({time.time() - t0:.1f}s)")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1,
                            {"params": params, "opt_m": opt_state.m,
                             "opt_v": opt_state.v})
    return params, losses
