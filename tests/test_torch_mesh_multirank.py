"""The port under a mesh of four ranks against the reference under the same
mesh, on the CPU.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, on meshes from
``repro.launch.mesh._make_mesh`` (Auto axes), each call jitted, and
writes its inputs (its own seeded weights, numpy-seeded activations) and
outputs to an npz file.
The port runs on four spawned processes, a gloo group on localhost, each
process building the same (data, model) meshes as a ``DeviceMesh``; rank
0 writes the port's outputs.  Each spawn is joined with a timeout of its
own and killed past it (no pytest-timeout here).

Held equal, float32, at ``atol = rtol = 1e-5``:

* ``decode_attention_lsharded`` at (1, 4) and (2, 2), ragged lengths
  including 1 and L;
* ``moe_ffn`` on the MoE smoke config at data 2: EP (4 experts over
  M = 2) and TP (5 experts at M = 2, which do not divide), the capacity
  from the data shard's rows; and TP at (1, 4) with 6 experts;
* ``prefill_fn`` and 4 ``decode_fn`` steps at (2, 2) for granite-8b-smoke
  (``kv_shard`` none and length) and qwen3-moe-30b-a3b-smoke, every step
  fed the reference's greedy token, with equal greedy tokens.
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
TOL = dict(atol=1e-5, rtol=1e-5)
WORLD = 4
MESHES = ((1, 4), (2, 2))
# (case name, arch, n_experts or None, mesh)
MOE_CASES = (("moe_ep_2x2", 4, (2, 2)), ("moe_tp_2x2", 5, (2, 2)),
             ("moe_tp_1x4", 6, (1, 4)))
MODEL_CASES = (("granite_none", "granite-8b", "none"),
               ("granite_length", "granite-8b", "length"),
               ("qwen3_none", "qwen3-moe-30b-a3b", "none"))
STEPS = 4
MAX_LEN = 16


def _inputs_lsharded():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((4, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((4, 32, 2, 16)).astype(np.float32)
    return q, k, v, np.array([1, 32, 17, 9], np.int32)


def _inputs_moe(d):
    rng = np.random.default_rng(1)
    return rng.standard_normal((4, 3, d)).astype(np.float32)


def _inputs_prompts(vocab):
    rng = np.random.default_rng(2)
    return (rng.integers(1, vocab, size=(4, 8)).astype(np.int32),
            np.array([5, 8, 3, 8], np.int32))


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
sys.path.insert(0, {tests!r})
import test_torch_mesh_multirank as t
from repro.configs import get_smoke_config
from repro.launch.mesh import _make_mesh
from repro.models import decode_fn, init_params, prefill_fn, split_params
from repro.models.attention import decode_attention_lsharded
from repro.models.moe import moe_ffn

assert len(jax.devices()) == t.WORLD, jax.devices()
out = {{}}
meshes = {{s: _make_mesh(s, ("data", "model")) for s in t.MESHES}}
q, k, v, lens = t._inputs_lsharded()
# jitted: op by op on 4 devices the reference takes minutes
for s, mesh in meshes.items():
    o = jax.jit(lambda *a, mesh=mesh: decode_attention_lsharded(
        *a, mesh=mesh, batch_axes=("data",)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    out["lsh_%dx%d" % s] = np.asarray(o)

def cfg_of(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)

def params_of(cfg, seed):
    vals, _ = split_params(init_params(cfg, jax.random.PRNGKey(seed)))
    return vals

for name, E, s in t.MOE_CASES:
    cfg = cfg_of("qwen3-moe-30b-a3b", n_experts=E)
    ffn = jax.tree.map(lambda a: a[0], params_of(cfg, 3)["blocks"]["ffn"])
    x = t._inputs_moe(cfg.d_model)
    o, aux = jax.jit(lambda x, p, E=E, cfg=cfg, mesh=meshes[s]: moe_ffn(
        x, p, n_experts=E, k=cfg.experts_per_token, mesh=mesh,
        batch_axes=("data",), capacity_factor=cfg.capacity_factor))(
        jnp.asarray(x), ffn)
    out[name] = np.asarray(o)
    out[name + "/aux"] = np.asarray(aux)
    for key, val in ffn.items():
        out["in/%s/%s" % (name, key)] = np.asarray(val)

mesh = meshes[(2, 2)]
for name, arch, kv in t.MODEL_CASES:
    cfg = cfg_of(arch)
    params = params_of(cfg, 4)
    toks, plens = t._inputs_prompts(cfg.vocab_size)
    prefill = jax.jit(lambda p, b, cfg=cfg: prefill_fn(
        cfg, p, b, max_len=t.MAX_LEN, mesh=mesh, batch_axes=("data",)))
    decode = jax.jit(lambda p, c, tok, cfg=cfg, kv=kv: decode_fn(
        cfg, p, c, tok, mesh=mesh, batch_axes=("data",), kv_shard=kv))
    logits, cache = prefill(params, {{"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(plens)}})
    out[name + "/logits0"] = np.asarray(logits)
    for i in range(t.STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        out[name + "/tok%d" % i] = tok
        logits, cache = decode(params, cache, jnp.asarray(tok))
        out[name + "/logits%d" % (i + 1)] = np.asarray(logits)
    for key, val in t._flat(params).items():
        out["in/%s/%s" % (name, key)] = val
np.savez({path!r}, **out)
print("ok")
"""


def _rank_main(rank, port, ref_path, out_path):
    """One rank of the port's run (called in a spawned process)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as pm
    from repro_torch.models import (
        decode_fn,
        param_axes,
        params_from_numpy,
        prefill_fn,
    )
    from repro_torch.models.attention import decode_attention_lsharded
    from repro_torch.models.moe import moe_ffn

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        ref = dict(np.load(ref_path))
        res = {}
        meshes = {s: init_device_mesh("cpu", s,
                                      mesh_dim_names=("data", "model"))
                  for s in MESHES}
        t = torch.from_numpy
        with torch.no_grad():
            q, k, v, lens = _inputs_lsharded()
            for s, mesh in meshes.items():
                o = decode_attention_lsharded(t(q), t(k), t(v), t(lens),
                                              mesh=mesh,
                                              batch_axes=("data",))
                res["lsh_%dx%d" % s] = o.full_tensor().numpy()
            for name, E, s in MOE_CASES:
                cfg = dataclasses.replace(
                    get_smoke_config("qwen3-moe-30b-a3b"), dtype="float32",
                    n_experts=E)
                ffn = params_from_numpy(_unflat(ref, f"in/{name}/"),
                                        device="cpu")
                o, aux = moe_ffn(t(_inputs_moe(cfg.d_model)), ffn,
                                 n_experts=E, k=cfg.experts_per_token,
                                 mesh=meshes[s], batch_axes=("data",),
                                 capacity_factor=cfg.capacity_factor)
                res[name] = o.numpy()
                res[name + "/aux"] = aux.numpy()
            mesh = meshes[(2, 2)]
            for name, arch, kv in MODEL_CASES:
                cfg = dataclasses.replace(get_smoke_config(arch),
                                          dtype="float32")
                params = params_from_numpy(_unflat(ref, f"in/{name}/"),
                                           device="cpu")
                params = pm.distribute_tree(
                    params, pm.param_shardings(param_axes(cfg), cfg, mesh))
                toks, plens = _inputs_prompts(cfg.vocab_size)
                batch = {"tokens": t(toks), "lengths": t(plens)}
                batch = pm.distribute_tree(
                    batch, pm.batch_shardings(batch, mesh, 4))
                logits, cache = prefill_fn(cfg, params, batch,
                                           max_len=MAX_LEN, mesh=mesh,
                                           batch_axes=("data",))
                res[name + "/logits0"] = logits.full_tensor().numpy()
                for i in range(STEPS):
                    tok = t(ref[name + "/tok%d" % i])
                    logits, cache = decode_fn(cfg, params, cache, tok,
                                              mesh=mesh, batch_axes=("data",),
                                              kv_shard=kv)
                    res[name + "/logits%d" % (i + 1)] = \
                        logits.full_tensor().numpy()
                res[name + "/lengths"] = \
                    cache["lengths"].full_tensor().numpy()
                res[name + "/kv_placements"] = np.array(
                    [str(p) for p in cache["blocks"]["k"].placements])
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cmds, env, timeout):
    """Start every command, wait for all within ``timeout`` seconds, kill
    the rest past it; returns [(rc, stderr tail)]."""
    procs = [subprocess.Popen(c, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
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
    tmp = tmp_path_factory.mktemp("multirank")
    ref_path, out_path = str(tmp / "ref.npz"), str(tmp / "port.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = _REF.format(tests=str(REPO / "tests"), path=ref_path)
    [(rc, err)] = _run([[sys.executable, "-c", script]], env, 100)
    assert rc == 0, err
    port = _free_port()
    rank_code = ("import sys; sys.path.insert(0, {t!r}); "
                 "import test_torch_mesh_multirank as m; "
                 "m._rank_main({r}, {port}, {a!r}, {b!r})")
    cmds = [[sys.executable, "-c",
             rank_code.format(t=str(REPO / "tests"), r=r, port=port,
                              a=ref_path, b=out_path)]
            for r in range(WORLD)]
    env.pop("XLA_FLAGS")
    res = _run(cmds, env, 100)
    assert all(rc == 0 for rc, _ in res), json.dumps(res)[-6000:]
    return dict(np.load(ref_path)), dict(np.load(out_path))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_decode_attention_lsharded_matches(runs, mesh):
    ref, port = runs
    np.testing.assert_allclose(port["lsh_" + mesh], ref["lsh_" + mesh],
                               **TOL)


@pytest.mark.parametrize("name", [c[0] for c in MOE_CASES])
def test_moe_ffn_matches(runs, name):
    ref, port = runs
    np.testing.assert_allclose(port[name], ref[name], **TOL)
    np.testing.assert_allclose(port[name + "/aux"], ref[name + "/aux"],
                               **TOL)


@pytest.mark.parametrize("name", [c[0] for c in MODEL_CASES])
def test_prefill_and_decode_match(runs, name):
    ref, port = runs
    for i in range(STEPS + 1):
        key = f"{name}/logits{i}"
        np.testing.assert_allclose(port[key], ref[key], err_msg=key, **TOL)
        top2 = np.sort(ref[key], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        assert clear.all(), f"{key}: a near tie; pick another seed"
        np.testing.assert_array_equal(port[key].argmax(-1),
                                      ref[key].argmax(-1))
    np.testing.assert_array_equal(port[name + "/lengths"],
                                  np.array([5, 8, 3, 8]) + STEPS)


def test_length_sharded_cache_layout(runs):
    """kv_shard="length" moved the KV to the length-sharded layout: batch
    over data, the length over model."""
    _, port = runs
    assert list(port["granite_length/kv_placements"]) == [
        "S(1)", "S(2)"]
    assert list(port["granite_none/kv_placements"]) == ["S(1)", "S(3)"]
