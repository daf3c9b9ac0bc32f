"""Mixture-of-Experts FFN: top-k routing and fixed-capacity expert dispatch.

The reference's ``moe_ffn`` runs its expert compute inside ``shard_map``
over a (data, model) mesh, in expert-parallel or tensor-parallel mode.
The port runs on one card, which is the reference's path at a (1, 1)
mesh: no expert parallelism (every expert is local, ``E_loc = E``), the
capacity computed from the whole call's ``T = B * S`` token rows, and no
``psum``.  So ``mesh``, ``batch_axes`` and ``model_axis`` are dropped from
the signature.

Dispatch, as in the reference: the ``(token, k)`` picks are laid out
token-major, each expert's picks numbered in that order by a cumulative
sum, and a pick whose number reaches the capacity ``C`` is dropped
(standard Switch behaviour; the capacity has a floor so small decode
batches drop nothing).  Padding rows are routed and take capacity like
real rows, as in the reference.  The kept picks gather their tokens into
an (E, C, d) buffer, the expert SwiGLU runs as batched matrix products
over the experts, and each token's output is the sum of its k weighted
expert outputs.

Two points where PyTorch differs from JAX and the port pins the
reference's behaviour down:

* ``jax.lax.top_k`` returns equal values in ascending index order;
  ``torch.topk`` promises no order among ties.  The router takes a stable
  descending sort and its first k columns.  The order of the k picks
  fixes the capacity count's order, and so which picks are dropped.
* The reference scatter-adds the weighted outputs into zeros in y's
  dtype.  A scatter-add on the card sums in a different order on every
  run, so the port gathers each token's k contributions (a dropped pick
  reads a zero row) and adds them one after another in the order of the
  k picks, pick 0 first, in y's dtype.  The result is the same on every
  run; against the reference it differs only by the order of the sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import linear

__all__ = ["router_topk", "aux_load_balance_loss", "moe_ffn"]


def router_topk(x, w_router, k: int):
    """x: (B, S, d); w_router: (d, E), float32 in the reference's models.
    The logits and the softmax are float32.  Returns (probs (B, S, E)
    float32, top_w (B, S, k) in x's dtype, renormalised over the k picks,
    top_idx (B, S, k) int64), the picks in descending probability, equal
    probabilities in ascending expert index."""
    logits = linear(x, w_router).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :k], top_idx[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w.to(x.dtype), top_idx


def aux_load_balance_loss(probs, top_idx, n_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * p_e, with f_e the
    share of the (token, k) picks that go to expert e and p_e its mean
    router probability.  The counts are whole numbers, so the
    scatter-add gives the same float32 sum in any order."""
    E = n_experts
    flat = top_idx.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    f = counts / counts.sum().clamp_min(1.0)
    p = probs.reshape(-1, E).mean(dim=0)
    return E * torch.sum(f * p)


def _dispatch(x2, top_idx, top_w, w1, w3, w2, *, capacity: int):
    """The reference's ``_local_moe`` with every expert local.  x2: (T, d);
    top_idx/top_w: (T, k); w1/w3 (E, d, f); w2 (E, f, d).  Returns (T, d)
    in x2's dtype."""
    T, d = x2.shape
    E = w1.shape[0]
    k = top_idx.shape[-1]
    n_slots = E * capacity
    flat_e = top_idx.reshape(-1)                           # (T*k,)
    flat_w = top_w.reshape(-1)
    # each pick's number among its expert's picks, in (token, k) order
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    pos_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    ok = pos_e < capacity
    slot = torch.where(ok, flat_e * capacity + pos_e,
                       torch.full_like(flat_e, n_slots))   # n_slots: dropped
    tok_id = torch.arange(T * k, device=x2.device) // k
    # every kept pick owns its slot; the dropped ones all write the spare
    # entry n_slots, which is never read
    tok_for_slot = torch.zeros((n_slots + 1,), dtype=torch.long,
                               device=x2.device)
    tok_for_slot.scatter_(0, slot, torch.where(ok, tok_id, 0))
    buf = x2[tok_for_slot[:n_slots]].reshape(E, capacity, d)
    h = F.silu(torch.bmm(buf, w3)) * torch.bmm(buf, w1)    # (E, C, f)
    y = torch.bmm(h, w2).reshape(n_slots, d)
    y = torch.cat([y, y.new_zeros((1, d))])                # row n_slots: 0
    w = torch.where(ok, flat_w, torch.zeros_like(flat_w))
    contrib = (y[slot] * w[:, None]).reshape(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):                                  # pick order
        out = out + contrib[:, j]
    return out


def moe_ffn(x, params, *, n_experts: int, k: int,
            capacity_factor: float = 1.25, min_capacity: int = 4,
            aux_loss: bool = True):
    """Top-k MoE FFN on one device.  x: (B, S, d).  params: router (d, E),
    w1/w3 (E, d, f), w2 (E, f, d).  Returns (out (B, S, d) in x's dtype,
    aux_loss), the reference's return without its mesh arguments (see the
    module docstring).  ``aux_loss=False`` skips the load-balance loss
    and returns None in its place: the serving paths discard it, as the
    reference's jitted serving calls do."""
    B, S, d = x.shape
    probs, top_w, top_idx = router_topk(x, params["router"], k)
    aux = aux_load_balance_loss(probs, top_idx, n_experts) if aux_loss \
        else None
    T = B * S
    capacity = max(int(capacity_factor * T * k / n_experts) + 1,
                   min_capacity)
    out = _dispatch(x.reshape(T, d), top_idx.reshape(T, k),
                    top_w.reshape(T, k), params["w1"], params["w3"],
                    params["w2"], capacity=capacity)
    return out.reshape(B, S, d).to(x.dtype), aux
