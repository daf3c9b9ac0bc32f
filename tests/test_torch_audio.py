"""The port's audio family (whisper-tiny) against the reference on bridged
weights.

The smoke config in float32 with the reference's init carried over by
``params_from_numpy``: the parameter tree (encoder, ``enc_pos``,
``enc_norm``, the stacked ``cross_blocks``), the encoder's output and
every decoder layer's cross K/V on numpy-seeded ``frames``, prefill and
three decode steps, the decode cache's tree, the slot backend's row
moves over the two cache leaves audio adds, and the slot engine in vec
and in ref mode.  The engines are held against the reference's ``ref``
engine: the reference's vec engine cannot serve this family (its
``init_cache`` binds one array to both ``cross_kv`` leaves, and its
jitted install donates that buffer twice).  The paged backend and chunked
prefill are refused with the reference's ``ValueError``.  The
reference's ``layer_norm`` and ``gelu_mlp``, which no model path calls,
are held against the port's too.
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
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import split_params
from repro.models import transformer as jax_transformer
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_policy
from repro_torch.models import (
    chunk_prefill_fn,
    decode_fn,
    init_cache,
    init_params,
    layer_pattern,
    layers,
    paged_decode_fn,
    params_from_numpy,
    prefill_fn,
    transformer,
)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine
from repro_torch.serving.cache_backend import (
    SlotCacheBackend,
    gather_rows,
    scatter_rows,
)

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 64


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


def _frames(cfg, B=3, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_param_tree_matches_reference(models):
    """The port's own init builds the reference's tree, and the bridge
    carries every leaf over unchanged."""
    jcfg, tcfg, jparams, tparams = models
    own = init_params(tcfg, 0, device="cpu")
    assert sorted(own) == sorted(jparams)
    assert {"enc_blocks", "enc_pos", "enc_norm", "cross_blocks"} <= set(own)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t, o = tparams, own
        for k in path:
            t, o = t[k.key], o[k.key]
        assert tuple(o.shape) == leaf.shape == tuple(t.shape), path
        assert str(o.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert layer_pattern(tcfg) == jax_transformer.layer_pattern(jcfg)


def test_encoder_and_cross_kv_match(models):
    jcfg, tcfg, jparams, tparams = models
    frames = _frames(tcfg)
    jenc = jax_transformer._encode_audio(jcfg, jparams, jnp.asarray(frames),
                                         remat=False)
    tenc = transformer._encode_audio(tcfg, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    jkv = jax_transformer._cross_kv_from_encoder(jcfg, jparams, jenc)
    tkv = transformer._cross_kv_from_encoder(
        tcfg, tparams, tenc, init_cache(tcfg, 3, 8, device="cpu")["cross_kv"])
    for name in ("k", "v"):
        assert tuple(tkv[name].shape) == jkv[name].shape == (
            tcfg.n_layers, 3, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.hd)
        np.testing.assert_allclose(tkv[name].numpy(),
                                   np.asarray(jkv[name]), **TOL)


def test_prefill_and_three_decode_steps_match(models, mesh):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, tcfg.vocab_size,
                                    size=(3, 24)).astype(np.int32),
             "lengths": np.array([24, 9, 17], np.int32),
             "frames": _frames(tcfg)}
    jl, jc = jax_prefill_fn(jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            max_len=MAX_LEN, mesh=mesh)
    tl, tc = prefill_fn(tcfg, tparams,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["cross_kv"][name].numpy(),
                                   np.asarray(jc["cross_kv"][name]), **TOL)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = jax_decode_fn(jcfg, jparams, jc, jnp.asarray(tok),
                               mesh=mesh)
        tl, tc = decode_fn(tcfg, tparams, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["blocks"]["k"].numpy(),
                               np.asarray(jc["blocks"]["k"]), **TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_tree_matches_reference(dtype):
    """Keys, shapes and dtypes as the reference's, with ``cross_kv`` k and
    v in storage of their own (the reference binds one array to both)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jc = jax_init_cache(jcfg, 5, 40)
    tc = init_cache(tcfg, 5, 40, device="cpu")
    jl, tl = list(_leaves(jc)), list(_leaves(tc))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    k, v = tc["cross_kv"]["k"], tc["cross_kv"]["v"]
    assert (k.untyped_storage().data_ptr()
            != v.untyped_storage().data_ptr())
    assert tc["enc_lengths"].dtype == torch.int32


def test_slot_backend_carries_the_cross_leaves(models):
    """The slot backend's install, gather and scatter move ``cross_kv``
    (layers-major) and ``enc_lengths`` (batch-major) row by row, k and v
    each from its own source; a padding destination is dropped."""
    _, tcfg, _, tparams = models
    N = 6
    be = SlotCacheBackend(tcfg, tparams, EngineConfig(
        n_workers=2, slots_per_worker=3, max_seq_len=MAX_LEN), "cpu")
    rng = np.random.default_rng(2)
    mini = init_cache(tcfg, 3, 32, device="cpu")
    for leaf in (mini["cross_kv"]["k"], mini["cross_kv"]["v"],
                 mini["blocks"]["k"]):
        leaf.copy_(torch.from_numpy(rng.normal(size=leaf.shape)))
    mini["enc_lengths"].copy_(torch.tensor([7, 8, 9], dtype=torch.int32))
    mini["lengths"].copy_(torch.tensor([3, 4, 5], dtype=torch.int32))
    be.write_prefill(mini, np.array([2, 0]), np.array([4, 1]))
    c = be.cache
    for name in ("k", "v"):
        assert torch.equal(c["cross_kv"][name][:, [4, 1]],
                           mini["cross_kv"][name][:, [2, 0]])
        assert not c["cross_kv"][name][:, [0, 2, 3, 5]].any()
    assert not torch.equal(c["cross_kv"]["k"], c["cross_kv"]["v"])
    assert c["enc_lengths"].tolist() == [tcfg.encoder_seq, 7,
                                         tcfg.encoder_seq,
                                         tcfg.encoder_seq, 9,
                                         tcfg.encoder_seq]
    assert torch.equal(c["blocks"]["k"][:, 4, :32], mini["blocks"]["k"][:, 2])
    sub = gather_rows(c, torch.tensor([4, 1]))
    assert torch.equal(sub["cross_kv"]["v"], c["cross_kv"]["v"][:, [4, 1]])
    assert sub["enc_lengths"].tolist() == [9, 7]
    sub["cross_kv"]["k"].add_(1.0)
    sub["enc_lengths"].add_(100)
    before = c["cross_kv"]["k"][:, 1].clone()
    scatter_rows(c, sub, torch.tensor([5, N]))      # the second is padding
    assert torch.equal(c["cross_kv"]["k"][:, 5], sub["cross_kv"]["k"][:, 0])
    assert torch.equal(c["cross_kv"]["k"][:, 1], before)
    assert c["enc_lengths"].tolist()[5] == 109
    assert c["enc_lengths"].tolist()[1] == 7


def _requests(cls, n=10, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, 128,
                                           size=int(rng.integers(4, 30))),
                max_new_tokens=int(rng.integers(3, 10)))
            for i in range(n)]


ENGINE = dict(n_workers=2, slots_per_worker=4, max_seq_len=MAX_LEN,
              cache_backend="slot")


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return (engine.run(), [r.generated for r in reqs],
            [r.worker for r in reqs])


@pytest.fixture(scope="module")
def reference_run(models, mesh):
    """The reference's ref engine on the stream: (stats, generations,
    workers)."""
    jcfg, _, jparams, _ = models
    return _serve(JaxServingEngine(
        jcfg, jparams, JaxEngineConfig(engine_mode="ref", **ENGINE),
        jax_make_policy("bfio_h8"), mesh=mesh), _requests(JaxServeRequest))


@pytest.mark.parametrize("mode", ["vec", "ref"])
def test_slot_engine_matches_reference_ref_engine(models, reference_run,
                                                  mode):
    """The stub front end's zero frames: stats, generations and workers of
    the port's engine equal to the reference's ref engine."""
    _, tcfg, _, tparams = models
    got = _serve(ServingEngine(
        tcfg, tparams, EngineConfig(engine_mode=mode, **ENGINE),
        make_policy("bfio_h8"), device="cpu"), _requests(ServeRequest))
    assert got == reference_run
    assert reference_run[0]["tokens"] > 0


@pytest.mark.parametrize("kw", [dict(cache_backend="paged"),
                                dict(cache_backend="slot", prefill_chunk=8)],
                         ids=["paged", "chunked"])
def test_paged_and_chunked_refused_like_reference(models, mesh, kw):
    jcfg, tcfg, jparams, tparams = models
    ec = dict(n_workers=2, slots_per_worker=4, max_seq_len=MAX_LEN, **kw)
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jcfg, jparams, JaxEngineConfig(**ec),
                         jax_make_policy("fcfs"), mesh=mesh)
    with pytest.raises(ValueError) as got:
        ServingEngine(tcfg, tparams, EngineConfig(**ec), make_policy("fcfs"),
                      device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="attention-family"):
        chunk_prefill_fn(tcfg, tparams, None, None, None, None)
    with pytest.raises(ValueError, match="attention-family"):
        paged_decode_fn(tcfg, tparams, *([None] * 7), block_size=8)


def test_layer_norm_and_gelu_mlp_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32) * 3 + 1
    sc, b = (rng.normal(size=48).astype(np.float32) for _ in range(2))
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(sc),
                                 jnp.asarray(b))
    got = layers.layer_norm(*map(torch.from_numpy, (x, sc, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w_in = rng.normal(size=(48, 96)).astype(np.float32) / 7
    b_in = rng.normal(size=96).astype(np.float32)
    w_out = rng.normal(size=(96, 48)).astype(np.float32) / 10
    b_out = rng.normal(size=48).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    want = jax_layers.gelu_mlp(*map(jnp.asarray, args))
    got = layers.gelu_mlp(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.layer_norm(xb, *map(torch.from_numpy, (sc, b))
                             ).dtype == torch.bfloat16
