"""Production meshes and sharding rules on a torch ``DeviceMesh``.

``make_production_mesh`` builds the 16x16 single-pod (256 cards) or
2x16x16 multi-pod (512 cards) mesh over the default process group, as a
FUNCTION, so importing this module starts no group and reads no
environment variable.  ``make_cpu_mesh`` builds the (1, 1) mesh on the
CPU, starting a one-rank gloo group when there is none.

``ShardingRules`` maps the *logical* parameter axes of the model's
parameters (:func:`repro_torch.models.param_axes`, the reference's
``Param`` axes) to mesh axes, divisibility-aware per architecture, with
the reference's logic:

  * attention is sharded by (q+kv) heads when both divide the model axis,
    else by head_dim (always 128/64 -> divisible), the variant that keeps
    qwen2-72b's 8 KV heads sharded 16 ways at decode;
  * MoE experts shard over model when E % M == 0 (qwen3: 128/16), else the
    per-expert hidden dim (granite-moe: 40 experts, f=512/16=32);
  * train mode adds FSDP: the d_model ("embed") axis of every weight is
    sharded over "data";
  * activations carry (batch, None, "model") through the layer loop.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names (sharded over all of them, the first outermost) or None, trailing
Nones trimmed (the reference's ``PartitionSpec``).  :class:`NamedSharding`
pairs it with the mesh and gives DTensor ``placements`` and the local
``shard_shape``; :func:`distribute_tree` places a tree of tensors as
DTensors under a tree of shardings (the reference's jit ``in_shardings``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..configs.base import ModelConfig
from ..models.layers import tree_map

__all__ = [
    "make_production_mesh",
    "make_cpu_mesh",
    "batch_axes_for",
    "ShardingRules",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "activation_spec",
    "NamedSharding",
    "distribute_tree",
    "mesh_shape",
]


def _make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the mesh's size."""
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a process group of {n} ranks; "
            "none is initialized (world size 0)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a process group of {n} ranks; "
            f"the default group has world size {world}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod (512 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_cpu_mesh() -> DeviceMesh:
    """The (1, 1) mesh on the CPU, same axis names; starts a one-rank gloo
    group (on an in-memory store) when no group exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return _make_mesh((1, 1), ("data", "model"), "cpu")


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes_for(mesh, global_batch: Optional[int] = None) -> tuple:
    """Mesh axes used for batch sharding: ("pod","data") when the pod axis
    exists; trimmed so the product divides the global batch."""
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    if global_batch is None:
        return tuple(axes)
    # drop axes (outermost first) until divisible
    while axes:
        prod = 1
        for a in axes:
            prod *= shape[a]
        if global_batch % prod == 0:
            return tuple(axes)
        axes.pop(0)
    return ()


def _trim(spec: list) -> tuple:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical-axis -> mesh-axes mapping for (config, mesh)."""

    table: dict

    @classmethod
    def build(cls, cfg: ModelConfig, mesh, *, mode: str = "serve",
              attn_pref: str = "auto") -> "ShardingRules":
        """attn_pref:
        * "auto": heads-first for train/prefill, hd-first for serve (the
          KV cache must shard);
        * "heads_first" / "hd_first": force a variant.
        """
        shape = mesh_shape(mesh)
        M = int(shape.get("model", 1))
        D = int(shape.get("data", 1))

        def div(n, m=M):
            return m > 1 and n % m == 0

        if attn_pref == "auto":
            attn_pref = "hd_first" if mode == "serve" else "heads_first"

        # attention sharding variant
        if div(cfg.n_heads) and div(cfg.n_kv_heads):
            heads, kv_heads, hd = "model", "model", None
        elif attn_pref == "heads_first" and div(cfg.n_heads):
            heads, kv_heads, hd = "model", None, None
        elif div(cfg.hd):
            heads, kv_heads, hd = None, None, "model"
        elif div(cfg.n_heads):
            heads, kv_heads, hd = "model", None, None
        else:
            heads = kv_heads = hd = None

        # MoE sharding variant (EP vs TP-within-expert): must agree with
        # repro_torch.models.moe.moe_ffn's mode switch
        if div(cfg.n_experts):
            experts, expert_mlp = "model", None
        elif cfg.is_moe and div(cfg.moe_d_ff):
            experts, expert_mlp = None, "model"
        else:
            experts = expert_mlp = None

        di = cfg.d_inner
        table = {
            "layers": None,
            "vocab": "model" if div(cfg.vocab_size) else None,
            "embed": "data" if (mode == "train" and div(cfg.d_model, D))
                     else None,
            "heads": heads,
            "kv_heads": kv_heads,
            "hd": hd,
            "hd2": None,
            "mlp": "model" if div(cfg.d_ff or 0) else None,
            "experts": experts,
            "expert_mlp": expert_mlp,
            "ssm_in": None,
            "ssm_inner": "model" if div(di) else None,
            "ssm_inner2": "model" if div(di) else None,
            "ssm_heads": None,
            "ssm_heads2": None,
            "gates": None,
            "conv_k": None,
            "enc_seq": None,
        }
        return cls(table=table)

    def spec_for(self, axes: tuple) -> tuple:
        phys = []
        used = set()
        for a in axes:
            m = self.table.get(a)
            if m is not None and m in used:
                m = None  # a mesh axis can appear only once per spec
            if m is not None:
                used.add(m)
            phys.append(m)
        return _trim(phys)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dim: a tensor dim
        whose entry names several mesh axes is sharded over each of them,
        in mesh order (the pod axis outermost)."""
        where = {}
        for dim, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                where[a] = dim
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def shard_shape(self, global_shape) -> tuple:
        """The local shard's shape of a tensor of ``global_shape``; a dim
        must divide by the mesh axes it is sharded over."""
        shape = mesh_shape(self.mesh)
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            n = 1
            for a in _entry_axes(entry):
                n *= shape[a]
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not divide by {n} (spec {self.spec})")
            out[dim] //= n
        return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def param_shardings(axes_tree, cfg: ModelConfig, mesh, *,
                    mode: str = "serve", attn_pref: str = "auto"):
    """NamedSharding tree matching the params tree (its logical axes from
    :func:`repro_torch.models.param_axes`)."""
    rules = ShardingRules.build(cfg, mesh, mode=mode, attn_pref=attn_pref)
    return tree_map(lambda axes: NamedSharding(mesh, rules.spec_for(axes)),
                    axes_tree, is_leaf=_is_axes)


def activation_spec(cfg: ModelConfig, mesh, global_batch: int):
    """Sharding for the residual stream (B, S, d) through the layers."""
    baxes = batch_axes_for(mesh, global_batch)
    M = int(mesh_shape(mesh).get("model", 1))
    d_ok = M > 1 and cfg.d_model % M == 0
    return NamedSharding(mesh, (baxes if baxes else None, None,
                                "model" if d_ok else None))


def batch_shardings(batch_specs: dict, mesh, global_batch: int):
    """Shardings for a train/prefill batch dict: batch dim sharded."""
    baxes = batch_axes_for(mesh, global_batch)
    b = baxes if baxes else None
    return tree_map(
        lambda leaf: NamedSharding(
            mesh, _trim([b] + [None] * (leaf.dim() - 1))), batch_specs)


def _walk_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _walk_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def cache_shardings(cache_specs, cfg: ModelConfig, mesh, global_batch: int,
                    kv_shard: str = "heads"):
    """Shardings for the decode cache tree (leaves stacked on a leading
    layer axis; batch is dim 1), by the path names of the
    :func:`repro_torch.models.init_cache` tree: ``k``/``v`` (the
    self-attention and audio's ``cross_kv``), ``state``, ``conv``,
    ``hcnm``; a 1-d leaf (``lengths``) is sharded over the batch axes.

    kv_shard="length": the KV length dim is sharded over the model axis
    (distributed flash-decode: attention.decode_attention_lsharded); any
    other value: the KV head/hd dims per the rules."""
    rules = ShardingRules.build(cfg, mesh, mode="serve")
    baxes = batch_axes_for(mesh, global_batch)
    b = baxes if baxes else None
    kv = rules.table["kv_heads"]
    hd = rules.table["hd"]
    M = int(mesh_shape(mesh).get("model", 1))

    def one(names, leaf):
        nd = leaf.dim()
        if nd == 1:            # lengths (B,)
            return NamedSharding(mesh, (b,))
        if "k" in names or "v" in names:       # (L, B, Lkv, Hkv, hd)
            if (kv_shard == "length" and nd >= 3
                    and leaf.shape[2] % max(M, 1) == 0 and M > 1):
                spec = [None, b, "model", None, None][:nd]
            else:
                spec = [None, b, None, kv, hd][:nd]
        elif "state" in names:                  # (L, B, H, dk, dv)
            spec = [None, b, None, None, None][:nd]
        elif "conv" in names:                   # (L, B, K-1, di)
            spec = [None, b, None, rules.table["ssm_inner"]][:nd]
        elif "hcnm" in names:                   # (L, B, H, hd)
            spec = [None, b, None, None][:nd]
        else:
            spec = [None, b] + [None] * (nd - 2)
        return NamedSharding(mesh, _trim(spec))

    return _walk_with_path(one, cache_specs)


def distribute_tree(tree, shardings):
    """Place every tensor leaf of ``tree`` as a DTensor under the
    NamedSharding at the same place in ``shardings``, as jit's
    ``in_shardings`` place a global array: every rank holds the same
    global values (one seed, zeros), so each keeps its own shard and
    nothing is sent.  A leaf that is already a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(t, sh.mesh, sh.placements,
                                 src_data_rank=None)

    return tree_map(one, tree, shardings)
