"""Dry run on a fake process group: run one step of every (architecture x
input shape x mesh) combination on the production mesh, with no card and
no allocation, proving the distribution config is coherent.

Per pair :func:`run_pair` starts a fake process group of 256 (single pod,
16x16) or 512 (multi pod, 2x16x16) ranks
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once with the right shapes) and builds the production mesh on it as
rank 0.  Under ``FakeTensorMode`` it places the params, the cache and the
batch as DTensors under the sharding rules (fake CPU tensors: each holds
only its local shard's shape), then runs one prefill or decode step.  A
dispatch mode under the DTensor layer sees what rank 0 runs: each local
op's FLOPs (``torch.utils.flop_counter``'s formulas) and each collective
with the bytes of its output, by the reference's op names
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``); ``CommDebugMode`` counts the same collectives as
a check.  The kernels run their plain versions on the fake CPU shards:
they give the shapes and the FLOPs, not a kernel's time.

The record keeps the reference's keys, with this card's (rank 0's)
numbers: ``memory.argument_size_in_bytes`` (the local shards of params,
cache and batch, exact), ``memory.output_size_in_bytes``, ``cost.flops``
and ``collectives`` ({bytes,counts}_by_op, total_bytes, total_count, and
the all-reduces by reduction, ``all_reduce_by_op``).  There is no
``memory.temp_size_in_bytes``: nothing here measures the step's
temporaries, so the key is absent.  Eager code runs every layer, so the
counts need no loop correction.  Training under a mesh is ROADMAP Queue A
item 12c: a ``train`` pair records ``ok: false`` naming it.

Nothing happens at import: no process group, no environment variable.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k --decode-opt
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import (
    SHAPES,
    config_for_shape,
    get_config,
    get_shape,
    input_specs,
    list_archs,
)
from ..models import decode_fn, init_params, param_axes, prefill_fn
from ..models.layers import tree_leaves, tree_map
from .mesh import (
    NamedSharding,
    batch_axes_for,
    batch_shardings,
    cache_shardings,
    make_production_mesh,
    mesh_shape,
    param_shardings,
)

__all__ = ["RESULTS_DIR", "collective_bytes", "build_lowered", "run_pair",
           "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

# functional collectives (what DTensor and the model's all-reduces call)
# under the reference's HLO op names; CommDebugMode's count in the record
# (``comm_debug_count``) would show any other
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(tree) -> int:
    """Bytes of every tensor in ``tree``; a DTensor counts its local
    shard."""
    tot = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            tot += t.numel() * t.element_size()
    return tot


class _StepMeter(TorchDispatchMode):
    """Counts what this rank runs: every local op's FLOPs and every
    collective's output bytes.  A DTensor op passes through
    (NotImplemented), so its local ops and collectives come back here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.coll: list[tuple[str, int, str]] = []   # (op, bytes, reduce)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is None:                 # a higher-order op
            return out
        name = _COLLECTIVES.get(packet.__name__)
        if name is not None and "c10d" in func.namespace:
            red = str(args[1]) if name == "all-reduce" else ""
            self.coll.append((name, _nbytes(out), red))
        elif packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        return out


def collective_bytes(records) -> dict:
    """Sum the bytes and counts of ``(op, bytes, reduction)`` collective
    records (the reference sums the output-shape bytes of every collective
    in its optimized HLO)."""
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    reds: dict[str, int] = {}
    for op, nbytes, red in records:
        totals[op] = totals.get(op, 0) + nbytes
        counts[op] = counts.get(op, 0) + 1
        if op == "all-reduce":
            reds[red] = reds.get(red, 0) + 1
    return {"bytes_by_op": totals, "counts_by_op": counts,
            "total_bytes": sum(totals.values()),
            "total_count": sum(counts.values()),
            "all_reduce_by_op": reds}


def _placed(meta_tree, shardings):
    """Fake DTensors of ``meta_tree``'s shapes and dtypes under
    ``shardings``: each rank's local shard alone is made (call under
    ``FakeTensorMode``)."""
    def one(t, sh):
        local = torch.empty(sh.shard_shape(t.shape), dtype=t.dtype,
                            device="cpu")
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    return tree_map(one, meta_tree, shardings)


def build_lowered(arch: str, shape_name: str, mesh, decode_opt: bool = False):
    """The step of one (arch, shape) on ``mesh``, its inputs placed: returns
    (step, args, cfg), ``step(*args)`` running it.  Call under
    ``FakeTensorMode`` (the inputs are fake shards).

    ``decode_opt``: length-sharded KV cache + heads-first weights +
    distributed flash-decode (the reference's perf-optimized serve
    step)."""
    shape = get_shape(shape_name)
    cfg = config_for_shape(get_config(arch), shape)
    if shape.kind == "train":
        raise NotImplementedError(
            "training under a mesh is not ported yet (ROADMAP Queue A item "
            "12c)")
    B = shape.global_batch
    baxes = batch_axes_for(mesh, B)
    specs = input_specs(cfg, shape)
    axes = param_axes(cfg)
    pmeta = init_params(cfg, device="meta")

    if shape.kind == "prefill":
        # prefill workers may take the heads-first layout (PD
        # disaggregation); the residual stays replicated on model
        params = _placed(pmeta, param_shardings(axes, cfg, mesh,
                                                mode="prefill"))
        batch = _placed(specs, batch_shardings(specs, mesh, B))
        act = NamedSharding(mesh, (baxes if baxes else None, None, None))

        def prefill_step(params, batch):
            return prefill_fn(cfg, params, batch, max_len=shape.seq_len,
                              mesh=mesh, batch_axes=baxes, act_spec=act)
        return prefill_step, (params, batch), cfg

    M = int(mesh_shape(mesh).get("model", 1))
    use_len = (decode_opt and not cfg.sliding_window
               and shape.seq_len % max(M, 1) == 0 and M > 1
               and cfg.n_heads % M == 0)
    kv_shard = "length" if use_len else "heads"
    pshard = param_shardings(axes, cfg, mesh, mode="serve",
                             attn_pref="heads_first" if use_len else "auto")
    params = _placed(pmeta, pshard)
    cache = _placed(specs["cache"], cache_shardings(
        specs["cache"], cfg, mesh, B, kv_shard=kv_shard))
    tokens = _placed(specs["tokens"], batch_shardings(
        {"tokens": specs["tokens"]}, mesh, B)["tokens"])

    def serve_step(params, cache, tokens):
        return decode_fn(cfg, params, cache, tokens, mesh=mesh,
                         batch_axes=baxes, kv_shard=kv_shard)
    return serve_step, (params, cache, tokens), cfg


def run_pair(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             tag: str = "", decode_opt: bool = False) -> dict:
    """One pair on a fake group of 256 or 512 ranks (destroyed at the end);
    writes and returns its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    multi = mesh_kind == "multi"
    n_chips = 512 if multi else 256
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "chips": n_chips, "ok": False}
    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, cfg = build_lowered(arch, shape_name, mesh,
                                            decode_opt=decode_opt)
            rec["memory"] = {"argument_size_in_bytes": _nbytes(args)}
            meter = _StepMeter()
            with torch.no_grad(), CommDebugMode() as comm, meter:
                out = step(*args)
            rec["memory"]["output_size_in_bytes"] = _nbytes(out)
        rec["cost"] = {"flops": float(meter.flops)}
        rec["collectives"] = collective_bytes(meter.coll)
        rec["comm_debug_count"] = int(comm.get_total_counts())
        rec["n_params"] = int(cfg.n_params())
        rec["n_active_params"] = int(cfg.active_params())
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - record and continue
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        dist.destroy_process_group()
    rec["total_s"] = round(time.time() - t0, 1)

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')})"
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status} "
              f"({rec['total_s']}s)", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--decode-opt", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_pair(arch, shape, mk, out_dir=args.out,
                               tag=args.tag, decode_opt=args.decode_opt)
                n_fail += 0 if rec["ok"] else 1
    print(f"[dryrun] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
