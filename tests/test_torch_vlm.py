"""The port's vlm family (llava-next-mistral-7b) against the reference on
bridged weights.

The smoke config in float32, the reference's init carried over with
``params_from_numpy``: the parameter tree (the ``projector`` MLP
included), prefill logits and cache with numpy-seeded ``patches`` spliced
over the first ``patch_tokens`` positions, three decode steps, the paged
decode and paged chunked-prefill entry points (which embed tokens only,
as in the reference), and the engine on both backends, whose stats and
generations must equal the reference's vec engine with ``==``.  A prompt
shorter than ``patch_tokens`` fails in the reference; the port raises a
``ValueError`` there.
"""
import dataclasses
import warnings

warnings.filterwarnings("ignore")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import make_policy as jax_make_policy
from repro.launch.mesh import make_cpu_mesh
from repro.models import decode_fn as jax_decode_fn
from repro.models import init_params as jax_init_params
from repro.models import paged_chunk_prefill_fn as jax_paged_chunk_prefill_fn
from repro.models import paged_decode_fn as jax_paged_decode_fn
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import split_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_policy
from repro_torch.models import (
    decode_fn,
    init_params,
    layer_pattern,
    paged_chunk_prefill_fn,
    paged_decode_fn,
    params_from_numpy,
    prefill_fn,
    supports_paged_stack,
)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
BS, MAX_LEN = 8, 64                    # paged block size, cache length


@pytest.fixture(scope="module")
def mesh():
    return make_cpu_mesh()


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, B=3, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size,
                                   size=(B, S)).astype(np.int32),
            "lengths": np.array([S, 17, 21][:B], np.int32),
            "patches": rng.normal(size=(B, cfg.patch_tokens, cfg.d_model)
                                  ).astype(np.float32)}


def _prefill(models, batch):
    _, tcfg, _, tparams = models
    return prefill_fn(tcfg, tparams,
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      max_len=MAX_LEN)


@pytest.fixture(scope="module")
def reference_prefill(models, mesh):
    """The reference's prefill of :func:`_batch`: (batch, logits, cache)."""
    jcfg, _, jparams, _ = models
    batch = _batch(models[1])
    jl, jc = jax_prefill_fn(jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            max_len=MAX_LEN, mesh=mesh)
    return batch, jl, jc


def test_param_tree_matches_reference(models):
    """The port's own init builds the reference's tree (projector
    included), and the bridge carries every leaf over unchanged."""
    jcfg, tcfg, jparams, tparams = models
    own = init_params(tcfg, 0, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert "projector" in own and sorted(own) == sorted(jparams)
    for path, leaf in leaves:
        t, o = tparams, own
        for k in path:
            t, o = t[k.key], o[k.key]
        assert tuple(o.shape) == leaf.shape == tuple(t.shape), path
        assert str(o.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert layer_pattern(tcfg) == [("blocks", "attn", tcfg.n_layers)]
    assert supports_paged_stack(tcfg)


def test_prefill_matches_reference(models, reference_prefill):
    batch, jl, jc = reference_prefill
    tl, tc = _prefill(models, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(), batch["lengths"])
    # the patches changed the result: without them the logits move
    plain = prefill_fn(models[1], models[3],
                       {k: torch.from_numpy(v) for k, v in batch.items()
                        if k != "patches"}, max_len=MAX_LEN)[0]
    assert (plain - tl).abs().max() > 1e-3


def test_three_decode_steps_match(models, mesh, reference_prefill):
    jcfg, tcfg, jparams, tparams = models
    batch, jl, jc = reference_prefill
    tl, tc = _prefill(models, batch)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = jax_decode_fn(jcfg, jparams, jc, jnp.asarray(tok),
                               mesh=mesh)
        tl, tc = decode_fn(tcfg, tparams, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["blocks"]["k"].numpy(),
                               np.asarray(jc["blocks"]["k"]), **TOL)


def _pools(cache_k, cache_v, lens, n_pool, seed=1):
    """Each row's prefill KV in permuted pool blocks, with room to decode
    in place."""
    layers, B = cache_k.shape[:2]
    mb = MAX_LEN // BS
    perm = np.random.default_rng(seed).permutation(n_pool)
    tables = perm[:B * mb].reshape(B, mb).astype(np.int32)
    kp = np.zeros((layers, n_pool, BS) + cache_k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(-(-int(lens[b]) // BS)):
            kp[:, tables[b, j]] = cache_k[:, b, j * BS:(j + 1) * BS]
            vp[:, tables[b, j]] = cache_v[:, b, j * BS:(j + 1) * BS]
    return kp, vp, tables


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_paged_decode_matches(models, mesh, reference_prefill, attn_impl):
    """Paged decode after a patch-spliced prefill: greedy tokens and the
    pool equal to the reference's for 4 steps."""
    jcfg, tcfg, jparams, tparams = models
    batch, jl, jc = reference_prefill
    lens = batch["lengths"]
    B = lens.size
    kp, vp, tables = _pools(np.asarray(jc["blocks"]["k"]),
                            np.asarray(jc["blocks"]["v"]), lens,
                            B * (MAX_LEN // BS) + 3)
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok, length = jtok.copy(), lens.copy()
    for _ in range(4):
        length = length + 1
        pos = length - 1
        blk = tables[np.arange(B), pos // BS].astype(np.int32)
        off = (pos % BS).astype(np.int32)
        jtok, jkp, jvp = jax_paged_decode_fn(
            jcfg, jparams, jkp, jvp, jnp.asarray(tables),
            jnp.asarray(length), jnp.asarray(blk), jnp.asarray(off),
            jnp.asarray(jtok), block_size=BS, attn_impl="gather", mesh=mesh)
        jtok = np.asarray(jtok)
        tnext, tkp, tvp = paged_decode_fn(
            tcfg, tparams, tkp, tvp, torch.from_numpy(tables),
            torch.from_numpy(length), torch.from_numpy(blk),
            torch.from_numpy(off), torch.from_numpy(ttok), block_size=BS,
            attn_impl=attn_impl)
        ttok = tnext.numpy()
        np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), **TOL)


def test_paged_chunk_prefill_matches(models, mesh):
    """Two chunks of each row's prompt over the paged pool (one padding
    row, one padding column run): logits and pools as the reference's."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(6)
    n, C, mb = 3, 8, MAX_LEN // BS
    n_pool = n * mb + 2
    tables = rng.permutation(n_pool)[:n * mb].reshape(n, mb).astype(np.int32)
    shape = (jcfg.n_layers, n_pool, BS, jcfg.n_kv_heads, jcfg.hd)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    offs = np.zeros(n, np.int32)
    for clens in (np.array([8, 5, 0], np.int32),
                  np.array([8, 3, 0], np.int32)):
        toks = rng.integers(1, tcfg.vocab_size, size=(n, C)).astype(np.int32)
        pos = offs[:, None] + np.arange(C)[None, :]
        live = np.arange(C)[None, :] < clens[:, None]
        wblk = np.where(live, tables[np.arange(n)[:, None], pos // BS],
                        n_pool).astype(np.int32)
        woff = (pos % BS).astype(np.int32)
        args = (tables, toks, offs, clens, wblk, woff)
        jl, jkp, jvp = jax_paged_chunk_prefill_fn(
            jcfg, jparams, jkp, jvp, *map(jnp.asarray, args),
            block_size=BS, mesh=mesh)
        tl, tkp, tvp = paged_chunk_prefill_fn(
            tcfg, tparams, tkp, tvp, *map(torch.from_numpy, args),
            block_size=BS)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
        offs = offs + clens
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), **TOL)


def _requests(cls, n=10, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, 128,
                                           size=int(rng.integers(4, 30))),
                max_new_tokens=int(rng.integers(3, 10)))
            for i in range(n)]


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_engine_matches_reference(models, mesh, backend):
    """The vec engine on each backend (the stub front end's zero patches
    over the first ``patch_tokens`` positions): stats, generations and
    workers equal to the reference's vec engine."""
    jcfg, tcfg, jparams, tparams = models
    kw = dict(n_workers=2, slots_per_worker=4, max_seq_len=MAX_LEN,
              cache_backend=backend)
    je = JaxServingEngine(jcfg, jparams, JaxEngineConfig(**kw),
                          jax_make_policy("bfio_h8"), mesh=mesh)
    te = ServingEngine(tcfg, tparams, EngineConfig(**kw),
                       make_policy("bfio_h8"), device="cpu")
    jr, tr = _requests(JaxServeRequest), _requests(ServeRequest)
    for e, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            e.submit(r)
    js, ts = je.run(), te.run()
    assert ts == js and js["tokens"] > 0
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert [r.worker for r in tr] == [r.worker for r in jr]


def test_chunked_prefill_refused_like_reference(models, mesh):
    jcfg, tcfg, jparams, tparams = models
    ec = dict(n_workers=2, slots_per_worker=4, max_seq_len=MAX_LEN,
              cache_backend="paged", prefill_chunk=8)
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jcfg, jparams, JaxEngineConfig(**ec),
                         jax_make_policy("fcfs"), mesh=mesh)
    with pytest.raises(ValueError) as got:
        ServingEngine(tcfg, tparams, EngineConfig(**ec), make_policy("fcfs"),
                      device="cpu")
    assert str(got.value) == str(want.value)


def test_prompt_shorter_than_the_patches_raises(models, mesh):
    """S < patch_tokens: the reference fails (its splice makes the
    sequence longer than the rope tables); the port says why."""
    jcfg, tcfg, jparams, tparams = models
    batch = _batch(tcfg, S=tcfg.patch_tokens - 4)
    batch["lengths"] = np.minimum(batch["lengths"], tcfg.patch_tokens - 4)
    with pytest.raises(Exception):
        jax_prefill_fn(jcfg, jparams,
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       max_len=MAX_LEN, mesh=mesh)
    with pytest.raises(ValueError, match="image-patch positions"):
        prefill_fn(tcfg, tparams,
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   max_len=MAX_LEN)
