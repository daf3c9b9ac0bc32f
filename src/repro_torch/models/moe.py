"""Mixture-of-Experts FFN: top-k routing and fixed-capacity expert dispatch.

Without a mesh (``mesh=None``) the FFN runs on one device: every expert is
local, the capacity comes from the whole call's ``T = B * S`` token rows,
and nothing is reduced.  That is the reference's path at a (1, 1) mesh.

Under a mesh (a torch ``DeviceMesh`` with a ``model`` axis of size M) the
expert compute runs on each rank's shards through ``local_map``, as the
reference's runs inside ``shard_map``:

* **EP mode** (E divisible by M > 1): each model rank owns E_loc = E/M
  experts, ``e0 = rank * E_loc`` the first; a pick for another rank's
  expert goes to the trash bucket E_loc and is dropped.  One sum
  all-reduce over the model axis combines the (disjoint) contributions:
  the paper's synchronized EP phase.
* **TP mode** (otherwise): every rank holds all experts with the hidden
  dim f sharded; the same dispatch runs with E_loc = E, and the
  all-reduce sums the f-partial products.

The router runs on each rank's batch rows with the whole router weight,
and the capacity comes from the rows of one data shard, ``T_loc =
max(B // dsize, 1) * S`` (dsize the product of the batch axes' sizes), so
under a data axis > 1 it differs from the mesh-free capacity, as in the
reference.

Dispatch, as in the reference: the ``(token, k)`` picks are laid out
token-major, each expert's picks numbered in that order by a cumulative
sum, and a pick whose number reaches the capacity ``C`` is dropped
(standard Switch behaviour; the capacity has a floor so small decode
batches drop nothing).  Padding rows are routed and take capacity like
real rows, as in the reference.  The kept picks gather their tokens into
an (E_loc, C, d) buffer, the expert SwiGLU runs as batched matrix
products over the experts, and each token's output is the sum of its k
weighted expert outputs.

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
  k picks, pick 0 first, in y's dtype, inside each shard.  The result is
  the same on every run; against the reference it differs only by the
  order of the sum.
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


def _dispatch(x2, top_idx, top_w, w1, w3, w2, *, capacity: int,
              e0: int = 0):
    """The reference's ``_local_moe`` on one rank's shards.  x2: (T, d);
    top_idx/top_w: (T, k); w1/w3 (E_loc, d, f); w2 (E_loc, f, d), the
    experts ``e0 .. e0 + E_loc - 1`` (all of them, e0 = 0, without a mesh
    and in TP mode).  Returns (T, d) in the experts' output dtype."""
    T, d = x2.shape
    E_loc = w1.shape[0]
    k = top_idx.shape[-1]
    n_slots = E_loc * capacity
    flat_e = top_idx.reshape(-1)                           # (T*k,)
    flat_w = top_w.reshape(-1)
    local = (flat_e >= e0) & (flat_e < e0 + E_loc)
    le = torch.where(local, flat_e - e0, E_loc)            # E_loc: trash
    # each pick's number among its expert's picks, in (token, k) order
    # (the one-hot by comparison: F.one_hot checks its classes on the CPU
    # with a host read, which the captured decode cannot hold)
    onehot = (le[:, None] == torch.arange(E_loc + 1, device=le.device)).long()
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_e = torch.gather(pos, 1, le[:, None])[:, 0]
    ok = local & (pos_e < capacity)
    slot = torch.where(ok, le * capacity + pos_e,
                       torch.full_like(flat_e, n_slots))   # n_slots: dropped
    tok_id = torch.arange(T * k, device=x2.device) // k
    # every kept pick owns its slot; the dropped ones all write the spare
    # entry n_slots, which is never read
    tok_for_slot = torch.zeros((n_slots + 1,), dtype=torch.long,
                               device=x2.device)
    tok_for_slot.scatter_(0, slot, torch.where(ok, tok_id, 0))
    buf = x2[tok_for_slot[:n_slots]].reshape(E_loc, capacity, d)
    h = F.silu(torch.bmm(buf, w3)) * torch.bmm(buf, w1)    # (E_loc, C, f)
    y = torch.bmm(h, w2).reshape(n_slots, d)
    y = torch.cat([y, y.new_zeros((1, d))])                # row n_slots: 0
    w = torch.where(ok, flat_w, torch.zeros_like(flat_w))
    contrib = (y[slot] * w[:, None]).reshape(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):                                  # pick order
        out = out + contrib[:, j]
    return out


def _capacity(T: int, k: int, n_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    return max(int(capacity_factor * T * k / n_experts) + 1, min_capacity)


def moe_ffn(x, params, *, n_experts: int, k: int, mesh=None,
            batch_axes=("data",), capacity_factor: float = 1.25,
            min_capacity: int = 4, model_axis: str = "model",
            aux_loss: bool = True):
    """Top-k MoE FFN.  x: (B, S, d).  params: router (d, E), w1/w3 (E, d,
    f), w2 (E, f, d).  Returns (out (B, S, d) in x's dtype, aux_loss).
    ``aux_loss=False`` skips the load-balance loss and returns None in
    its place: the serving paths discard it, as the reference's jitted
    serving calls do.  ``mesh``: run expert- or tensor-parallel over its
    ``model_axis``, the batch over ``batch_axes`` (see the module
    docstring); DTensors are redistributed to that layout, plain tensors
    count as the same on every rank and plain tensors come back."""
    if mesh is not None:
        return _moe_ffn_sharded(
            x, params, n_experts=n_experts, k=k, mesh=mesh,
            batch_axes=batch_axes, capacity_factor=capacity_factor,
            min_capacity=min_capacity, model_axis=model_axis,
            aux_loss=aux_loss)
    B, S, d = x.shape
    probs, top_w, top_idx = router_topk(x, params["router"], k)
    aux = aux_load_balance_loss(probs, top_idx, n_experts) if aux_loss \
        else None
    T = B * S
    capacity = _capacity(T, k, n_experts, capacity_factor, min_capacity)
    out = _dispatch(x.reshape(T, d), top_idx.reshape(T, k),
                    top_w.reshape(T, k), params["w1"], params["w3"],
                    params["w2"], capacity=capacity)
    return out.reshape(B, S, d).to(x.dtype), aux


def _moe_ffn_sharded(x, params, *, n_experts: int, k: int, mesh, batch_axes,
                     capacity_factor: float, min_capacity: int,
                     model_axis: str, aux_loss: bool):
    from torch.distributed.tensor import Partial

    from ..kernels.sharded import as_dtensor, is_dtensor, on_shards
    from ..kernels.sharded import replicated
    from ..launch.mesh import NamedSharding, mesh_shape

    plain = not is_dtensor(x)
    x = as_dtensor(x, mesh)
    w = {n: as_dtensor(params[n], mesh)
         for n in ("router", "w1", "w3", "w2")}
    B, S, d = x.shape
    shape = mesh_shape(mesh)
    msize = shape[model_axis]
    ep_mode = n_experts % msize == 0 and msize > 1
    E_loc = n_experts // msize if ep_mode else n_experts
    dsize = 1
    for a in batch_axes:
        dsize *= shape[a]
    T_loc = max(B // max(dsize, 1), 1) * S
    capacity = _capacity(T_loc, k, n_experts, capacity_factor, min_capacity)

    def pl(*spec):
        return NamedSharding(mesh, spec).placements

    bp = pl(tuple(batch_axes) if batch_axes else None, None, None)
    rep = replicated(mesh)
    probs, top_w, top_idx = on_shards(
        lambda xl, r: router_topk(xl, r, k), (x, w["router"]), (bp, rep),
        (bp, bp, bp), mesh)
    aux = None
    if aux_loss:
        aux = on_shards(
            lambda p, i: aux_load_balance_loss(p, i, n_experts),
            (probs, top_idx), (rep, rep), rep, mesh)

    def local(xl, il, gl, w1, w3, w2):
        e0 = mesh.get_local_rank(model_axis) * E_loc if ep_mode else 0
        Bl = xl.shape[0]
        out = _dispatch(xl.reshape(-1, d), il.reshape(-1, k),
                        gl.reshape(-1, k), w1, w3, w2, capacity=capacity,
                        e0=e0)
        return out.reshape(Bl, S, d).to(xl.dtype)

    if ep_mode:                          # experts sharded
        w13 = w2p = pl(model_axis, None, None)
    else:                                # hidden dim sharded (TP)
        w13, w2p = pl(None, None, model_axis), pl(None, model_axis, None)
    # each model rank's output is its experts' (or hidden slice's) part of
    # the sum: a pending sum, reduced over the model axis (the reference's
    # psum), which autograd differentiates as DTensor's redistribution
    mdim = mesh.mesh_dim_names.index(model_axis)
    part = tuple(Partial() if i == mdim else p for i, p in enumerate(bp))
    out = on_shards(local, (x, top_idx, top_w, w["w1"], w["w3"], w["w2"]),
                    (bp, bp, bp, w13, w13, w2p), part, mesh)
    out = out.redistribute(mesh, bp)
    if plain:
        out = out.full_tensor()
        aux = None if aux is None else aux.full_tensor()
    return out, aux
