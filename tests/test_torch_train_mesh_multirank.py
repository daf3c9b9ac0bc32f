"""Training under a mesh of four ranks: the port's FSDP train step against
the reference's under the same meshes, on the CPU.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, on meshes from
``repro.launch.mesh._make_mesh`` (Auto axes), each call jitted with the
dry run's shardings: float32 params (and AdamW m and v) placed by
``param_shardings(..., mode="train")`` (FSDP over ``"data"``), the step
replicated, the batch by ``batch_shardings``, the residual stream by
``activation_spec`` and the gradient accumulator by the params'
shardings (``grad_shardings``).  Both start from the same weights (the
port's seeded init, written to an npz file first) and numpy-seeded
batches, and both start at once.  The port runs on four spawned
processes, a gloo group on localhost, each building
the same (data, model) meshes as a ``DeviceMesh`` and placing the same
values as DTensors; rank 0 writes the port's outputs.  Each spawn is
joined with a timeout of its own and killed past it.

Held equal, float32, at (2, 2) and (1, 4), for granite-8b-smoke,
qwen3-moe-30b-a3b-smoke (expert-parallel: 4 experts over the model axis)
and zamba2-1.2b-smoke:

* one ``loss_fn`` value within 1e-5 and the gradient of every leaf
  within 1e-4 of its largest entry (as ``tests/test_torch_loss.py``
  holds them without a mesh), each placed as its param;
* one step of ``make_train_step`` (``grad_accum=1``): the loss and every
  parameter within 1e-5;
* 3 steps of ``make_train_step`` with ``grad_accum=2``: every loss and
  every parameter after the last step within 1e-5.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = ((2, 2), (1, 4))
ARCHS = (("granite", "granite-8b"), ("qwen3", "qwen3-moe-30b-a3b"),
         ("zamba2", "zamba2-1.2b"))
B, S = 4, 32
STEPS = 3
ACCUM = 2
TOL = 1e-5
# a gradient leaf against its largest entry, as tests/test_torch_loss.py
# holds it: float32 sums over the batch's positions taken in other orders
# (zamba2's w_in gradient differs by ~1.3e-5 of its largest entry)
GRAD_TOL = 1e-4


def _batch(vocab, i):
    rng = np.random.default_rng(100 + i)
    toks = rng.integers(1, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


_REF = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_train_mesh_multirank as t
from repro.configs import get_smoke_config
from repro.launch.mesh import (_make_mesh, activation_spec, batch_axes_for,
                               batch_shardings, param_shardings)
from repro.models import init_params, loss_fn, split_params
from repro.training import AdamWConfig, init_opt_state, make_train_step

assert len(jax.devices()) == t.WORLD, jax.devices()
inputs = dict(np.load({inputs!r}))
out = {{}}
for s in t.MESHES:
    mesh = _make_mesh(s, ("data", "model"))
    tag = "%dx%d" % s
    rep = NamedSharding(mesh, P())
    for name, arch in t.ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        vals, axes = split_params(init_params(cfg, jax.random.PRNGKey(0)))
        # the shared inputs in place of the reference's own draw
        flat = t._flat(vals)
        vals = t._unflat({{k: inputs["in/%s/%s" % (name, k)] for k in flat}},
                         "")
        assert all(vals_k.shape == flat[k].shape and vals_k.dtype ==
                   flat[k].dtype for k, vals_k in t._flat(vals).items())
        pshard = param_shardings(axes, cfg, mesh, mode="train")
        baxes = batch_axes_for(mesh, t.B)
        act = activation_spec(cfg, mesh, t.B)
        batches = [t._batch(cfg.vocab_size, i) for i in range(t.STEPS)]
        bshard = batch_shardings(batches[0], mesh, t.B)
        vals = jax.device_put(vals, pshard)
        batches = [jax.device_put(b, bshard) for b in batches]
        key = "%s/%s" % (tag, name)
        with jax.set_mesh(mesh):
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: loss_fn(cfg, p, b, mesh=mesh, batch_axes=baxes,
                                     act_spec=act, remat=True)),
                in_shardings=(pshard, bshard), out_shardings=(rep, pshard))
            loss, grads = vg(vals, batches[0])
            out[key + "/loss"] = np.asarray(loss)
            for k, v in t._flat(grads).items():
                out[key + "/grad/" + k] = np.asarray(v)
            opt = init_opt_state(vals)
            oshard = type(opt)(step=rep, m=pshard, v=pshard)
            opt = jax.device_put(opt, oshard)
            one = jax.jit(make_train_step(
                cfg, AdamWConfig(), mesh=mesh, batch_axes=baxes,
                act_spec=act, compute_dtype="float32",
                grad_shardings=pshard),
                in_shardings=(pshard, oshard, bshard),
                out_shardings=(rep, pshard, oshard))
            l1, p1, _ = one(vals, opt, batches[0])
            out[key + "/step1_loss"] = np.asarray(l1)
            for k, v in t._flat(p1).items():
                out[key + "/step1/" + k] = np.asarray(v)
            step = jax.jit(make_train_step(
                cfg, AdamWConfig(), mesh=mesh, batch_axes=baxes,
                act_spec=act, compute_dtype="float32", grad_accum=t.ACCUM,
                grad_shardings=pshard),
                in_shardings=(pshard, oshard, bshard),
                out_shardings=(rep, pshard, oshard))
            p = vals
            for i, b in enumerate(batches):
                l, p, opt = step(p, opt, b)
                out[key + "/loss%d" % i] = np.asarray(l)
        for k, v in t._flat(p).items():
            out[key + "/param/" + k] = np.asarray(v)
np.savez({path!r}, **out)
print("ok")
"""


def _inputs(path):
    """The shared weights: the port's seeded init of each smoke config in
    float32 (its tree is the reference's), written to ``path``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    out = {}
    for name, arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        flat = _flat_leaves(init_params(cfg, 5, device="cpu"))
        out.update({f"in/{name}/{k}": v.numpy() for k, v in flat})
    np.savez(path, **out)


def _rank_main(rank, port, in_path, out_path):
    """One rank of the port's run (called in a spawned process)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as pm
    from repro_torch.models import loss_fn, param_axes, params_from_numpy
    from repro_torch.models.layers import tree_map
    from repro_torch.training import (
        AdamWConfig,
        init_opt_state,
        make_train_step,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        ref = dict(np.load(in_path))
        res = {}
        for s in MESHES:
            mesh = init_device_mesh("cpu", s,
                                    mesh_dim_names=("data", "model"))
            tag = "%dx%d" % s
            for name, arch in ARCHS:
                cfg = dataclasses.replace(get_smoke_config(arch),
                                          dtype="float32")
                key = f"{tag}/{name}"
                sh = pm.param_shardings(param_axes(cfg), cfg, mesh,
                                        mode="train")
                act = pm.activation_spec(cfg, mesh, B)
                baxes = pm.batch_axes_for(mesh, B)

                def params():
                    return pm.distribute_tree(params_from_numpy(
                        _unflat(ref, f"in/{name}/"), device="cpu"), sh)

                batches = []
                for i in range(STEPS):
                    b = {k: torch.from_numpy(v)
                         for k, v in _batch(cfg.vocab_size, i).items()}
                    batches.append(pm.distribute_tree(
                        b, pm.batch_shardings(b, mesh, B)))
                ps = tree_map(lambda t: t.detach().requires_grad_(True),
                              params())
                loss = loss_fn(cfg, ps, batches[0], mesh=mesh,
                               batch_axes=baxes, act_spec=act, remat=True)
                leaves = _flat_leaves(ps)
                with implicit_replication():
                    gs = torch.autograd.grad(loss, [v for _, v in leaves])
                res[key + "/loss"] = loss.detach().full_tensor().numpy()
                for (k, p), g in zip(leaves, gs):
                    g = g.redistribute(mesh, p.placements)
                    res[key + "/grad/" + k] = g.full_tensor().numpy()
                    res[key + "/gplace/" + k] = np.array(
                        [str(x) for x in g.placements])
                    res[key + "/pplace/" + k] = np.array(
                        [str(x) for x in p.placements])
                p = params()
                loss, p1, _ = make_train_step(
                    cfg, AdamWConfig(), mesh=mesh, batch_axes=baxes,
                    act_spec=act, compute_dtype="float32",
                    grad_shardings=sh)(p, init_opt_state(p), batches[0])
                res[key + "/step1_loss"] = loss.detach().full_tensor().numpy()
                for k, v in _flat_leaves(p1):
                    res[key + "/step1/" + k] = v.full_tensor().numpy()
                step = make_train_step(
                    cfg, AdamWConfig(), mesh=mesh, batch_axes=baxes,
                    act_spec=act, compute_dtype="float32",
                    grad_accum=ACCUM, grad_shardings=sh, donate=True)
                p = params()
                opt = init_opt_state(p)
                for i, b in enumerate(batches):
                    loss, p, opt = step(p, opt, b)
                    res[key + f"/loss{i}"] = loss.detach().full_tensor().numpy()
                for k, v in _flat_leaves(p):
                    res[key + "/param/" + k] = v.full_tensor().numpy()
                    res[key + "/mplace/" + k] = np.array(
                        [str(x) for x in v.placements])
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _flat_leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat_leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cmds, envs, timeout):
    """Start every command (each with its environment), wait for all
    within ``timeout`` seconds, kill the rest past it; returns [(rc,
    stderr tail)]."""
    procs = [subprocess.Popen(c, env=e, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port's four ranks, all started at once from
    the same weights."""
    tmp = tmp_path_factory.mktemp("train_multirank")
    in_path, ref_path, out_path = (str(tmp / f"{n}.npz")
                                   for n in ("in", "ref", "port"))
    _inputs(in_path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    ref_env = dict(env,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = _REF.format(tests=str(REPO / "tests"), inputs=in_path,
                         path=ref_path)
    port = _free_port()
    rank_code = ("import sys; sys.path.insert(0, {t!r}); "
                 "import test_torch_train_mesh_multirank as m; "
                 "m._rank_main({r}, {port}, {a!r}, {b!r})")
    cmds = [[sys.executable, "-c",
             rank_code.format(t=str(REPO / "tests"), r=r, port=port,
                              a=in_path, b=out_path)]
            for r in range(WORLD)]
    res = _run([[sys.executable, "-c", script]] + cmds,
               [ref_env] + [env] * WORLD, 400)
    assert res[0][0] == 0, res[0][1]
    assert all(rc == 0 for rc, _ in res[1:]), json.dumps(res[1:])[-6000:]
    return dict(np.load(ref_path)), dict(np.load(out_path))


CASES = [f"{m[0]}x{m[1]}/{name}" for m in MESHES for name, _ in ARCHS]


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match(runs, case):
    ref, port = runs
    np.testing.assert_allclose(port[case + "/loss"], ref[case + "/loss"],
                               atol=TOL, rtol=TOL)
    keys = [k for k in ref if k.startswith(case + "/grad/")]
    assert keys and sorted(keys) == sorted(
        k for k in port if k.startswith(case + "/grad/"))
    for k in keys:
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        err = float(np.abs(port[k] - ref[k]).max()) / scale
        assert err <= GRAD_TOL, (k, err)
        leaf = k[len(case + "/grad/"):]
        assert list(port[f"{case}/gplace/{leaf}"]) == list(
            port[f"{case}/pplace/{leaf}"]), k


@pytest.mark.parametrize("case", CASES)
def test_one_step_matches(runs, case):
    """One step of ``make_train_step`` without accumulation: the loss and
    every parameter after AdamW within 1e-5."""
    ref, port = runs
    np.testing.assert_allclose(port[case + "/step1_loss"],
                               ref[case + "/step1_loss"], atol=TOL, rtol=TOL)
    keys = [k for k in ref if k.startswith(case + "/step1/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_accumulated_steps_match(runs, case):
    ref, port = runs
    for i in range(STEPS):
        key = f"{case}/loss{i}"
        np.testing.assert_allclose(port[key], ref[key], atol=TOL, rtol=TOL,
                                   err_msg=key)
    keys = [k for k in ref if k.startswith(case + "/param/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_params_stay_fsdp_sharded(runs):
    """After the steps every parameter keeps its train-mode placement:
    granite-8b-smoke's wq (embed, heads, hd) at (2, 2) is cut over data
    (FSDP, d) and model (heads)."""
    _, port = runs
    assert list(port["2x2/granite/mplace/blocks/attn/wq"]) == ["S(1)",
                                                               "S(2)"]
    assert list(port["2x2/granite/mplace/embed"]) == ["S(1)", "S(0)"]
