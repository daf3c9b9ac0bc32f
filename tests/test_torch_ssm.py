"""The port's recurrent cores (repro_torch.models.ssm) and its ssm / hybrid
model assembly against the reference (repro.models) in float32.

Every function of ``models/ssm.py`` is held against the reference's on
the same numpy-seeded inputs: the chunked gated linear-attention scan with
the Mamba2 H=1 broadcast, the mLSTM normalizer, an initial state and a
ragged S; the single-step update; the causal conv with per-row lengths and
its step; the sLSTM scan with padding steps and its step.  Then
xlstm-350m-smoke and zamba2-1.2b-smoke, on the reference's weights carried
over by ``params_from_numpy``: prefill logits and six decode steps within
1e-4, equal greedy tokens, and equal caches.  float32 on the CPU is where
the two frameworks' rounding differences stay below any logit gap.
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
from repro.models import decode_fn as jax_decode_fn
from repro.models import init_params as jax_init_params
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import split_params
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import (
    decode_fn,
    init_cache,
    init_params,
    layer_pattern,
    params_from_numpy,
    prefill_fn,
)
from repro_torch.models import ssm

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["xlstm-350m", "zamba2-1.2b"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _scan_inputs(B, S, H, dk, dv, *, hk=None, seed=0):
    rng = np.random.default_rng(seed)
    hk = H if hk is None else hk
    return (rng.normal(size=(B, S, hk, dk)).astype(np.float32),
            rng.normal(size=(B, S, hk, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(B, S, H))).astype(np.float32),
            np.abs(rng.normal(size=(B, S, H))).astype(np.float32))


@pytest.mark.parametrize("case", [
    dict(S=64, hk=1, chunk=16),                       # Mamba2 broadcast
    dict(S=37, chunk=16),                             # ragged S
    dict(S=40, chunk=128),                            # chunk = min(chunk, S)
    dict(S=48, chunk=16, normalize=True),             # mLSTM normalizer
    dict(S=33, chunk=8, normalize=True, init=True),   # carried state
    dict(S=24, hk=1, chunk=8, init=True),
], ids=["broadcast", "ragged", "one-chunk", "normalize", "norm-init",
        "broadcast-init"])
def test_chunked_linear_attention(case):
    B, H, dk, dv = 2, 3, 8, 5
    q, k, v, a, g = _scan_inputs(B, case["S"], H, dk, dv, hk=case.get("hk"),
                                 seed=1)
    kw = dict(chunk=case["chunk"], normalize=case.get("normalize", False))
    s0 = None
    if case.get("init"):
        s0 = np.random.default_rng(2).normal(
            size=(B, H, dk, dv)).astype(np.float32)
    y0, st0 = jax_ssm.chunked_linear_attention(
        *(jnp.asarray(x) for x in (q, k, v, a, g)),
        initial_state=None if s0 is None else jnp.asarray(s0), **kw)
    y, st = ssm.chunked_linear_attention(
        *(_t(x) for x in (q, k, v, a, g)),
        initial_state=None if s0 is None else _t(s0), **kw)
    assert y.shape == y0.shape and st.shape == st0.shape
    np.testing.assert_allclose(_np(y), np.asarray(y0), **TOL)
    np.testing.assert_allclose(_np(st), np.asarray(st0), **TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_linear_attention_step(normalize):
    rng = np.random.default_rng(3)
    B, H, dk, dv = 3, 2, 8, 6
    q, k = (rng.normal(size=(B, H, dk)).astype(np.float32) for _ in "qk")
    v = rng.normal(size=(B, H, dv)).astype(np.float32)
    a = -np.abs(rng.normal(size=(B, H))).astype(np.float32)
    g = np.abs(rng.normal(size=(B, H))).astype(np.float32)
    st = rng.normal(size=(B, H, dk, dv + normalize)).astype(np.float32)
    y0, s0 = jax_ssm.linear_attention_step(
        *(jnp.asarray(x) for x in (q, k, v, a, g, st)), normalize=normalize)
    y, s = ssm.linear_attention_step(*(_t(x) for x in (q, k, v, a, g, st)),
                                     normalize=normalize)
    np.testing.assert_allclose(_np(y), np.asarray(y0), **TOL)
    np.testing.assert_allclose(_np(s), np.asarray(s0), **TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_causal_conv1d(ragged):
    rng = np.random.default_rng(4)
    B, S, D, K = 3, 10, 6, 4
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(K, D)).astype(np.float32)
    init = rng.normal(size=(B, K - 1, D)).astype(np.float32)
    lens = np.array([10, 1, 6], np.int32) if ragged else None
    y0, s0 = jax_ssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), initial_state=jnp.asarray(init),
        lengths=None if lens is None else jnp.asarray(lens))
    y, s = ssm.causal_conv1d(_t(x), _t(w), initial_state=_t(init),
                             lengths=None if lens is None else _t(lens))
    np.testing.assert_allclose(_np(y), np.asarray(y0), **TOL)
    np.testing.assert_array_equal(_np(s), np.asarray(s0))
    y0, s1 = jax_ssm.causal_conv1d_step(jnp.asarray(x[:, 0]),
                                        jnp.asarray(w), s0)
    y, s2 = ssm.causal_conv1d_step(_t(x[:, 0]), _t(w), s)
    np.testing.assert_allclose(_np(y), np.asarray(y0), **TOL)
    np.testing.assert_array_equal(_np(s2), np.asarray(s1))


def test_slstm_scan_and_step():
    rng = np.random.default_rng(5)
    B, S, H, hd = 3, 9, 2, 4
    xg = rng.normal(size=(B, S, H, 4, hd)).astype(np.float32)
    r = (0.5 * rng.normal(size=(H, 4, hd, hd))).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array([9, 4, 1])[:, None]
    h0, f0 = jax_ssm.slstm_scan(jnp.asarray(xg), jnp.asarray(r),
                                valid=jnp.asarray(valid))
    h, f = ssm.slstm_scan(_t(xg), _t(r), valid=_t(valid))
    np.testing.assert_allclose(_np(h), np.asarray(h0), **TOL)
    for a, b in zip(f, f0):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    y0, g0 = jax_ssm.slstm_step(jnp.asarray(xg[:, 0]), jnp.asarray(r), f0)
    y, g = ssm.slstm_step(_t(xg[:, 0]), _t(r), f)
    np.testing.assert_allclose(_np(y), np.asarray(y0), **TOL)
    for a, b in zip(g, g0):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_layer_pattern_and_bridge(model):
    """The groups of the reference (``m{i}``/``s{i}``, ``shared{i}``),
    every leaf of the reference's tree carried over with its shape and
    dtype, and the port's own init in the same tree."""
    from repro.models import layer_pattern as jax_layer_pattern
    jcfg, tcfg, jparams, tparams = model
    assert layer_pattern(tcfg) == jax_layer_pattern(jcfg)
    own = init_params(tcfg, 0, device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t, o = tparams, own
        for p in path:
            t, o = t[p.key], o[p.key]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), path
        assert t.dtype == o.dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        n += 1
    assert n == sum(1 for _ in jax.tree_util.tree_leaves(tparams))
    if tcfg.family == "hybrid":
        assert "shared_attn" in tparams and "shared0" not in tparams
        assert tparams["shared_attn"]["attn"]["wq"].dim() == 3


def _cache_leaves(cache):
    out = []
    for k in sorted(cache):
        v = cache[k]
        if isinstance(v, dict):
            for kk in sorted(v):
                leaf = v[kk]
                out.extend(leaf if isinstance(leaf, tuple) else [leaf])
        else:
            out.append(v)
    return out


def test_prefill_and_decode_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jcfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 5, 11], np.int32)
    jlog, jc = jax_prefill_fn(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)},
                              max_len=64)
    tlog, tc = prefill_fn(tcfg, tparams, {"tokens": _t(toks),
                                          "lengths": _t(lens)}, max_len=64)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    for a, b in zip(_cache_leaves(tc), _cache_leaves(jc)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)
    tt = tlog.argmax(-1).to(torch.int32)
    for _ in range(6):
        jlog, jc = jax_decode_fn(jcfg, jparams, jc, jt)
        tlog, tc2 = decode_fn(tcfg, tparams, tc, tt)
        assert tc2 is tc                     # updated in place
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        tt = tlog.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(_cache_leaves(tc), _cache_leaves(jc)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_init_cache_layout(model):
    """init_cache matches the reference's tree: group names, shapes and
    dtypes, the sLSTM stabilizer starting at -1e30."""
    from repro.models import init_cache as jax_init_cache
    jcfg, tcfg, _, _ = model
    jc = jax_init_cache(jcfg, 3, 40)
    tc = init_cache(tcfg, 3, 40, device="cpu")
    assert sorted(tc) == sorted(jc)
    for a, b in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


def test_unported_families_raise():
    """vlm and audio are ported: their decoder stacks are the reference's
    (audio's encoder is not part of the pattern)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.transformer import layer_pattern as jax_layer_pattern
    from repro_torch.configs import get_smoke_config as smoke
    for arch in ("llava-next-mistral-7b", "whisper-tiny"):
        assert layer_pattern(smoke(arch)) == jax_layer_pattern(
            jax_smoke(arch))
