"""The port's dry run (repro_torch.launch.dryrun) at full size on a fake
process group of 256 ranks.

Each pair runs one decode step of a production config under
``FakeTensorMode`` on the (16, 16) mesh.  Its record's argument bytes
are rank 0's local shards of params, cache and tokens, which must equal
the bytes of the reference's ``NamedSharding(AbstractMesh, spec)
.shard_shape`` over the same trees (the reference's rules on an abstract
mesh, no device).  The collectives are those the step runs: one sum
all-reduce per MoE layer for qwen3-moe-30b-a3b's experts, and for
granite-8b with ``--decode-opt`` one max and two sum all-reduces per
layer (the length-sharded flash-decode).  granite-8b's ``train_4k``
pair runs the FSDP train step (forward, backward and AdamW) at a cut
depth, and its placed inputs at full depth hold the reference's bytes;
no process group outlives a pair.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import config_for_shape as jax_config_for_shape
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import input_specs as jax_input_specs
from repro.launch import mesh as rmesh
from repro.models import init_params as jax_init_params
from repro.models import split_params as jax_split_params
from repro_torch.launch import dryrun, roofline

PAIRS = {"granite": ("granite-8b", False),
         "granite_opt": ("granite-8b", True),
         "qwen3": ("qwen3-moe-30b-a3b", False)}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for name, (arch, opt) in PAIRS.items():
        recs[name] = dryrun.run_pair(arch, "decode_32k", "single",
                                     out_dir=str(out), verbose=False,
                                     tag="opt" if opt else "",
                                     decode_opt=opt)
        assert not dist.is_initialized()
    return recs, out


def _ref_argument_bytes(arch, decode_opt):
    """The reference's decode step's inputs as its dry run shards them:
    rank 0's bytes of params, cache and tokens."""
    shape = jax_get_shape("decode_32k")
    cfg = jax_config_for_shape(jax_get_config(arch), shape)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    M = 16
    use_len = (decode_opt and not cfg.sliding_window
               and shape.seq_len % M == 0 and cfg.n_heads % M == 0)
    vals, axes = jax_split_params(jax.eval_shape(
        lambda: jax_init_params(cfg, jax.random.PRNGKey(0))))
    pshard = rmesh.param_shardings(
        axes, cfg, mesh, mode="serve",
        attn_pref="heads_first" if use_len else "auto")
    specs = jax_input_specs(cfg, shape)
    cshard = rmesh.cache_shardings(specs["cache"], cfg, mesh,
                                   shape.global_batch,
                                   kv_shard="length" if use_len else "heads")
    tshard = rmesh.batch_shardings({"tokens": specs["tokens"]}, mesh,
                                   shape.global_batch)

    def nbytes(leaves, shardings):
        tot = 0
        for leaf, sh in zip(jax.tree.leaves(leaves), jax.tree.leaves(
                shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
            tot += int(np.prod(sh.shard_shape(leaf.shape))) \
                * np.dtype(leaf.dtype).itemsize
        return tot

    return (nbytes(vals, pshard) + nbytes(specs["cache"], cshard)
            + nbytes({"tokens": specs["tokens"]}, tshard))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_pair_ok_with_reference_argument_bytes(records, name):
    recs, _ = records
    rec = recs[name]
    assert rec["ok"], rec.get("traceback")
    arch, opt = PAIRS[name]
    assert rec["chips"] == 256
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_argument_bytes(arch, opt)
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert "temp_size_in_bytes" not in rec["memory"]
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert coll["total_count"] == sum(coll["counts_by_op"].values()) \
        == rec["comm_debug_count"]
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values())
    assert set(coll["counts_by_op"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_moe_all_reduce_per_layer(records):
    recs, _ = records
    coll = recs["qwen3"]["collectives"]
    assert coll["all_reduce_by_op"].get("sum", 0) >= 48


def test_length_sharded_decode_collectives(records):
    """--decode-opt: the flash-decode merge's max and two sums a layer;
    the attention no longer all-gathers the cache."""
    recs, _ = records
    opt, base = recs["granite_opt"]["collectives"], \
        recs["granite"]["collectives"]
    assert opt["all_reduce_by_op"].get("max", 0) >= 36
    assert opt["all_reduce_by_op"].get("sum", 0) >= 72
    assert "max" not in base["all_reduce_by_op"]
    assert opt["bytes_by_op"].get("all-gather", 0) \
        < base["bytes_by_op"]["all-gather"] / 100


def test_records_written_and_read_by_the_roofline(records):
    recs, out = records
    for name, (arch, opt) in PAIRS.items():
        tag = "__opt" if opt else ""
        path = out / f"{arch}__decode_32k__single{tag}.json"
        assert json.loads(path.read_text()) == recs[name]
        row = roofline.analyze_record(recs[name])
        assert row["ok"] and row["chips"] == 256
        assert row["collective_bytes"] == \
            recs[name]["collectives"]["total_bytes"]
        assert row["hlo_flops_per_device"] == recs[name]["cost"]["flops"]


def _ref_train_argument_bytes(layers=None):
    """The reference's ``train_4k`` step's inputs as its dry run shards
    them on the (16, 16) mesh: rank 0's bytes of the float32 params, AdamW
    m and v (like the params), the step (replicated) and the batch."""
    import dataclasses
    shape = jax_get_shape("train_4k")
    cfg = jax_config_for_shape(jax_get_config("granite-8b"), shape)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    tcfg = dataclasses.replace(cfg, dtype="float32")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    vals, axes = jax_split_params(jax.eval_shape(
        lambda: jax_init_params(tcfg, jax.random.PRNGKey(0))))
    pshard = rmesh.param_shardings(axes, tcfg, mesh, mode="train")
    specs = jax_input_specs(tcfg, shape)
    bshard = rmesh.batch_shardings(specs, mesh, shape.global_batch)

    def nbytes(leaves, shardings):
        tot = 0
        for leaf, sh in zip(jax.tree.leaves(leaves), jax.tree.leaves(
                shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
            tot += int(np.prod(sh.shard_shape(leaf.shape))) \
                * np.dtype(leaf.dtype).itemsize
        return tot

    return 3 * nbytes(vals, pshard) + 4 + nbytes(specs, bshard)


def test_train_pair_names_item_12c(tmp_path):
    """granite-8b's ``train_4k`` pair (formerly refused, naming ROADMAP
    item 12c) runs the FSDP train step, depth cut to 2 layers (the full
    depth takes ~10 minutes op by op; its record is in PERF.md): ok, rank
    0's argument bytes the reference's to the byte for the same cut, the
    weights gathered over the data axis and their gradients
    reduce-scattered back, and no process group left."""
    rec = dryrun.run_pair("granite-8b", "train_4k", "single",
                          out_dir=str(tmp_path), verbose=False, layers=2)
    assert rec["ok"], rec.get("traceback")
    assert rec["layers"] == 2
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_train_argument_bytes(layers=2)
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert coll["counts_by_op"]["all-gather"] > 0
    assert coll["counts_by_op"]["reduce-scatter"] > 0
    assert coll["total_count"] == rec["comm_debug_count"]
    assert not dist.is_initialized()
    row = roofline.analyze_record(rec)
    assert row["ok"] and row["chips"] == 256


def test_train_argument_bytes_at_full_depth():
    """The full-depth granite-8b ``train_4k`` step's placed inputs (fake
    shards, no step run): rank 0's bytes the reference's to the byte."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = dryrun.make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, args, cfg = dryrun.build_lowered("granite-8b", "train_4k",
                                                mesh)
            got = dryrun._nbytes(args)
    finally:
        dist.destroy_process_group()
    assert dryrun.grad_accum_for(cfg) == 4
    assert got == _ref_train_argument_bytes()


def test_import_starts_no_group_and_sets_no_environment():
    code = ("import os; before = dict(os.environ); "
            "import torch.distributed as dist; "
            "import repro_torch.launch, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh; "
            "assert not dist.is_initialized(); "
            "assert dict(os.environ) == before; print('clean')")
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"
