"""The port's meshes and sharding rules (repro_torch.launch.mesh) against
the reference's (repro.launch.mesh).

The reference's side runs on ``jax.sharding.AbstractMesh``es of the
production shapes, so no device is needed; the port's side builds the
same meshes as ``DeviceMesh``es over a fake process group of 1, 256 or
512 ranks (``torch.testing._internal.distributed.fake_pg``), destroyed
after each test.  For every arch, mode and attention preference the
rules' table, every parameter leaf's spec and local shard shape, the
decode cache's shardings (both ``kv_shard`` values), the batch and
activation shardings and ``batch_axes_for`` are the reference's.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.launch import mesh as rmesh
from repro.models import init_params as jax_init_params
from repro.models import split_params as jax_split_params
from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.launch import mesh as pmesh
from repro_torch.models import init_params, param_axes
from repro_torch.models.layers import tree_leaves

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(name):
    """The port's mesh of ``name`` over a fake group; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = MESHES[name]
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield pmesh._make_mesh(shape, axes, "cpu")
    finally:
        dist.destroy_process_group()


def jax_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def norm_spec(spec):
    """A spec as a tuple, a one-name tuple entry as the name (the
    reference's PartitionSpec writes ("data",) as "data")."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    cfg = jax_get_config(arch)
    tree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    return jax_split_params(tree)


def jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_match_reference(arch):
    _, want = jax_params(arch)
    got = param_axes(get_config(arch))
    assert jax.tree.structure(got, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.structure(want, is_leaf=lambda x: isinstance(x, tuple))
    assert jax_leaves(got) == jax_leaves(want)
    # the port's own init has the reference's shapes and dtypes (xlstm's
    # sLSTM r_h is float32 in a bf16 model there)
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in
           tree_leaves(init_params(get_config(arch), device="meta"))]
    ref_vals, _ = jax_params(arch)
    assert got == [(tuple(v.shape), str(v.dtype))
                   for v in jax.tree.leaves(ref_vals)]


@pytest.mark.parametrize("mode", ["serve", "prefill", "train"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_and_param_shardings_match_reference(arch, mesh_name, mode):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jm = jax_mesh(mesh_name)
    ref_vals, ref_axes = jax_params(arch)
    meta = tree_leaves(init_params(cfg, device="meta"))
    with fake_mesh(mesh_name) as mesh:
        for pref in ("auto", "heads_first", "hd_first"):
            want = rmesh.ShardingRules.build(jcfg, jm, mode=mode,
                                             attn_pref=pref)
            got = pmesh.ShardingRules.build(cfg, mesh, mode=mode,
                                            attn_pref=pref)
            assert got.table == want.table, pref
            for axes in set(map(tuple, jax_leaves(ref_axes))):
                assert norm_spec(got.spec_for(axes)) == norm_spec(
                    want.spec_for(axes)), (pref, axes)
            gsh = tree_leaves(pmesh.param_shardings(
                param_axes(cfg), cfg, mesh, mode=mode, attn_pref=pref),
                is_leaf=lambda x: isinstance(x, pmesh.NamedSharding))
            wsh = jax.tree.leaves(rmesh.param_shardings(
                ref_axes, jcfg, jm, mode=mode, attn_pref=pref))
            assert len(gsh) == len(wsh) == len(meta)
            for g, w, t in zip(gsh, wsh, meta):
                assert norm_spec(g.spec) == norm_spec(w.spec)
                assert g.shard_shape(t.shape) == w.shard_shape(
                    tuple(t.shape))
                assert len(g.placements) == len(MESHES[mesh_name][0])


@pytest.mark.parametrize("kv_shard", ["heads", "length"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_shardings_match_reference(arch, mesh_name, kv_shard):
    shape = SHAPES["decode_32k"]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jm = jax_mesh(mesh_name)
    jspecs = jax_input_specs(jcfg, JAX_SHAPES["decode_32k"])["cache"]
    wsh = jax.tree.leaves(rmesh.cache_shardings(
        jspecs, jcfg, jm, shape.global_batch, kv_shard=kv_shard))
    wshape = [s.shape for s in jax.tree.leaves(jspecs)]
    specs = input_specs(cfg, shape)["cache"]
    with fake_mesh(mesh_name) as mesh:
        gsh = tree_leaves(pmesh.cache_shardings(
            specs, cfg, mesh, shape.global_batch, kv_shard=kv_shard),
            is_leaf=lambda x: isinstance(x, pmesh.NamedSharding))
        leaves = tree_leaves(specs)
        assert len(gsh) == len(wsh) == len(leaves)
        for g, w, t, ws in zip(gsh, wsh, leaves, wshape):
            assert tuple(t.shape) == tuple(ws)
            assert norm_spec(g.spec) == norm_spec(w.spec)
            assert g.shard_shape(t.shape) == w.shard_shape(ws)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_activation_shardings_match_reference(arch, mesh_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jm = jax_mesh(mesh_name)
    with fake_mesh(mesh_name) as mesh:
        for sname in ("train_4k", "prefill_32k"):
            shape = SHAPES[sname]
            jspecs = jax_input_specs(jcfg, JAX_SHAPES[sname])
            want = rmesh.batch_shardings(jspecs, jm, shape.global_batch)
            got = pmesh.batch_shardings(input_specs(cfg, shape), mesh,
                                        shape.global_batch)
            assert sorted(got) == sorted(want)
            for k in want:
                assert norm_spec(got[k].spec) == norm_spec(want[k].spec), k
                assert got[k].shard_shape(jspecs[k].shape) == \
                    want[k].shard_shape(jspecs[k].shape)
            for gb in (1, 2, 16, 32, 128, 256, 512):
                ga = pmesh.activation_spec(cfg, mesh, gb)
                wa = rmesh.activation_spec(jcfg, jm, gb)
                assert norm_spec(ga.spec) == norm_spec(wa.spec), gb
                assert ga.shard_shape((gb, 8, cfg.d_model)) == \
                    wa.shard_shape((gb, 8, cfg.d_model))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_axes_for_matches_reference(mesh_name):
    jm = jax_mesh(mesh_name)
    with fake_mesh(mesh_name) as mesh:
        assert pmesh.batch_axes_for(mesh) == rmesh.batch_axes_for(jm)
        for gb in (1, 2, 16, 32, 128, 256, 512):
            assert pmesh.batch_axes_for(mesh, gb) == \
                rmesh.batch_axes_for(jm, gb), gb


def test_placements_pod_outer_and_shard_shape():
    with fake_mesh("2x16x16") as mesh:
        sh = pmesh.NamedSharding(mesh, (("pod", "data"), None, "model"))
        assert [type(p).__name__ for p in sh.placements] == \
            ["Shard", "Shard", "Shard"]
        assert [p.dim for p in sh.placements] == [0, 0, 2]
        assert sh.shard_shape((64, 3, 4096)) == (2, 3, 256)
        with pytest.raises(ValueError, match="divide"):
            sh.shard_shape((64, 3, 100))
        # the local shard of a placed fake tensor has the shard shape
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import distribute_tensor
        with FakeTensorMode():
            t = torch.empty((64, 3, 4096), dtype=torch.bfloat16)
            d = distribute_tensor(t, mesh, sh.placements)
            assert tuple(d.to_local().shape) == (2, 3, 256)


def test_production_mesh_needs_its_world_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world size 0"):
        pmesh.make_production_mesh(device_type="cpu")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        with pytest.raises(RuntimeError, match="512 ranks.*world size 256"):
            pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        mesh = pmesh.make_production_mesh(device_type="cpu")
        assert pmesh.mesh_shape(mesh) == {"data": 16, "model": 16}
    finally:
        dist.destroy_process_group()


def test_cpu_mesh_starts_and_reuses_a_one_rank_group():
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_cpu_mesh()
        assert pmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert mesh.device_type == "cpu"
        assert pmesh.make_cpu_mesh().mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()


def test_chunked_and_paged_entry_points_under_the_cpu_mesh():
    """``chunk_prefill_fn``, ``paged_chunk_prefill_fn`` and
    ``paged_decode_fn`` take the mesh for the MoE FFN alone (their other
    tensors plain): at the (1, 1) CPU mesh every output and every pool
    equals ``mesh=None``'s bit for bit."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (
        chunk_prefill_fn,
        paged_chunk_prefill_fn,
        paged_decode_fn,
    )

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    n, C, BS, L = 3, 8, 4, 16
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(n, C)).astype(np.int32))
    offs = torch.tensor([0, 4, 8], dtype=torch.int32)
    clens = torch.tensor([8, 5, 0], dtype=torch.int32)
    kv_shape = (cfg.n_layers, n, L, cfg.n_kv_heads, cfg.hd)
    kv = {k: torch.from_numpy(rng.normal(size=kv_shape).astype(np.float32))
          for k in ("k", "v")}
    mb = L // BS
    n_pool = n * mb + 2
    tables = torch.from_numpy(rng.permutation(n_pool)[:n * mb].reshape(
        n, mb).astype(np.int32))
    pools = {k: torch.from_numpy(rng.normal(size=(
        cfg.n_layers, n_pool, BS, cfg.n_kv_heads, cfg.hd)).astype(np.float32))
        for k in ("k", "v")}
    posmat = offs.long()[:, None] + torch.arange(C)[None, :]
    wblk = tables.long().gather(1, (posmat // BS).clamp(max=mb - 1))
    wblk = torch.where(torch.arange(C)[None, :] < clens.long()[:, None],
                       wblk, n_pool).to(torch.int32)
    woff = (posmat % BS).to(torch.int32)
    length = torch.tensor([9, 5, 16], dtype=torch.int32)
    pos = length.long() - 1
    blk = tables.long()[torch.arange(n), pos // BS].to(torch.int32)
    off = (pos % BS).to(torch.int32)

    def run(mesh):
        cache = {"lengths": offs.clone(),
                 "blocks": {k: v.clone() for k, v in kv.items()}}
        kw = {} if mesh is None else {"mesh": mesh}
        with torch.no_grad():
            lc, cache = chunk_prefill_fn(cfg, params, cache, toks, offs,
                                         clens, **kw)
            kp, vp = pools["k"].clone(), pools["v"].clone()
            lp, kp, vp = paged_chunk_prefill_fn(
                cfg, params, kp, vp, tables, toks, offs, clens, wblk, woff,
                block_size=BS, **kw)
            nxt, kp, vp = paged_decode_fn(
                cfg, params, kp, vp, tables, length, blk, off,
                lc.argmax(-1).to(torch.int32), block_size=BS, **kw)
        return lc, cache["blocks"]["k"], lp, nxt, kp, vp

    want = run(None)
    assert not dist.is_initialized()
    try:
        got = run(pmesh.make_cpu_mesh())
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert type(g) is torch.Tensor
        assert torch.equal(g, w)
