"""The port's dense decoder (repro_torch.models) against the reference
model (repro.models) on bridged weights.

The granite-8b smoke config in float32: the reference's init goes
through ``split_params`` and numpy into ``params_from_numpy``; prefill
logits must agree within 1e-4 and paged decode must produce the same
greedy tokens for 8 steps, with the port's ``"gather"`` oracle and with
its ``"kernel"`` path (the plain version on the CPU).  The same checks run
on the other dense arches, each of which carries a path granite-8b does
not: granite-34b (one KV head, GELU MLP), minitron-4b (GELU MLP) and
qwen2-72b (QKV biases, randomised before bridging; rope theta 1e6).  float32 on the
CPU is where the two frameworks' rounding differences stay below any
logit gap; bf16 is held kernel-against-plain on the card instead.
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
from repro.launch.mesh import make_cpu_mesh
from repro.models import chunk_prefill_fn as jax_chunk_prefill_fn
from repro.models import init_params as jax_init_params
from repro.models import paged_decode_fn as jax_paged_decode_fn
from repro.models import prefill_fn as jax_prefill_fn
from repro.models import split_params
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import (
    chunk_prefill_fn,
    init_cache,
    init_params,
    paged_decode_fn,
    params_from_numpy,
    prefill_fn,
    resolve_device,
)
from repro_torch.models.attention import decode_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "granite-8b"
TOL = dict(atol=1e-4, rtol=1e-4)
BS, MAX_LEN = 8, 64                    # paged block size, cache length


# the other dense arches, each with a code path of its own
OTHER_DENSE = ["granite-34b", "minitron-4b", "qwen2-72b"]


def _bridged(arch):
    """The reference's float32 smoke model and the port's on the same
    weights.  The reference inits QKV biases at zero; they are drawn at
    random first, so that the bias path is compared."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    attn = tree["blocks"]["attn"]
    rng = np.random.default_rng(7)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = rng.normal(scale=0.5, size=attn[name].shape
                                    ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    return _bridged(ARCH)


@pytest.fixture(scope="module", params=OTHER_DENSE)
def other_models(request):
    return _bridged(request.param)


def _prompts(vocab, B=3, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(B, S)).astype(np.int32)
    lens = np.array([S, 5, 11][:B], np.int32)
    return toks, lens


def test_bridge_keeps_layout(models):
    jcfg, tcfg, jparams, tparams = models
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    own = init_params(tcfg, 0, device="cpu")
    for path, leaf in jl:
        keys = [p.key for p in path]
        t, o = tparams, own
        for k in keys:
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_bridge_bf16_goes_through_f32_exactly():
    a = jnp.asarray(np.random.default_rng(0).normal(size=(4, 8)),
                    jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_prefill_logits_match(models):
    _check_prefill(models)


def _check_prefill(models):
    jcfg, tcfg, jparams, tparams = models
    toks, lens = _prompts(tcfg.vocab_size)
    jl, jc = jax_prefill_fn(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                           "lengths": jnp.asarray(lens)},
                            max_len=MAX_LEN, mesh=make_cpu_mesh())
    tl, tc = prefill_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(), lens)


def _paged_setup(cache_k, cache_v, lens, n_pool, seed=1):
    """Scatter each row's prefill KV into permuted pool blocks."""
    layers, B = cache_k.shape[:2]
    mb = MAX_LEN // BS
    perm = np.random.default_rng(seed).permutation(n_pool)
    tables = np.full((B, mb), -1, np.int32)
    kp = np.zeros((layers, n_pool, BS) + cache_k.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    ptr = 0
    for b in range(B):
        n = mb                              # room to decode in place
        tables[b] = perm[ptr:ptr + n]
        ptr += n
        for j in range(-(-int(lens[b]) // BS)):
            kp[:, tables[b, j]] = cache_k[:, b, j * BS:(j + 1) * BS]
            vp[:, tables[b, j]] = cache_v[:, b, j * BS:(j + 1) * BS]
    return kp, vp, tables


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_paged_decode_greedy_tokens_match(models, attn_impl):
    _check_paged_decode(models, attn_impl)


def _check_paged_decode(models, attn_impl):
    jcfg, tcfg, jparams, tparams = models
    mesh = make_cpu_mesh()
    toks, lens = _prompts(tcfg.vocab_size)
    jl, jc = jax_prefill_fn(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                           "lengths": jnp.asarray(lens)},
                            max_len=MAX_LEN, mesh=mesh)
    B = toks.shape[0]
    n_pool = B * (MAX_LEN // BS) + 3
    kp, vp, tables = _paged_setup(np.asarray(jc["blocks"]["k"]),
                                  np.asarray(jc["blocks"]["v"]), lens,
                                  n_pool)
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok = jtok.copy()
    length = lens.copy()
    for _ in range(8):
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


def test_padding_rows_drop_their_writes(models):
    """Rows with ``blk == n_blocks`` (bucket padding, frozen KV) must not
    write anywhere: JAX drops such scatters, the port masks them."""
    _, tcfg, _, tparams = models
    L, hkv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.hd
    n_pool = 6
    kp = torch.zeros((L, n_pool, BS, hkv, hd))
    vp = torch.zeros_like(kp)
    tables = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    blk = torch.tensor([0, n_pool], dtype=torch.int32)
    off = torch.tensor([2, 0], dtype=torch.int32)
    toks = torch.tensor([5, 0], dtype=torch.int32)
    _, kp2, _ = paged_decode_fn(tcfg, tparams, kp, vp, tables, lens, blk,
                                off, toks, block_size=BS)
    written = (kp2.abs().sum(dim=(0, 3, 4)) > 0).nonzero().tolist()
    assert written == [[0, 2]]


def test_gather_and_kernel_attention_agree(models):
    """Inside the port: the kernel path's attention and the gather
    oracle's agree within float32 2e-5."""
    rng = np.random.default_rng(4)
    B, hq, hkv, hd, mb = 3, 4, 2, 64, MAX_LEN // BS
    n_pool = B * mb
    q = torch.from_numpy(rng.normal(size=(B, hq, hd)).astype(np.float32))
    kp = torch.from_numpy(
        rng.normal(size=(n_pool, BS, hkv, hd)).astype(np.float32))
    vp = torch.from_numpy(
        rng.normal(size=(n_pool, BS, hkv, hd)).astype(np.float32))
    tables = torch.from_numpy(
        rng.permutation(n_pool).reshape(B, mb).astype(np.int32))
    lens = torch.tensor([1, 37, MAX_LEN], dtype=torch.int32)
    got = ops.paged_decode_attention(q, kp, vp, tables, lens, block_size=BS)
    bt = tables.long()
    want = decode_attention(q, kp[bt].reshape(B, MAX_LEN, hkv, hd),
                            vp[bt].reshape(B, MAX_LEN, hkv, hd), lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    assert pa.paged_decode_attention.launches == 0


def test_chunk_prefill_matches(models):
    _check_chunk_prefill(models)


def _check_chunk_prefill(models):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(6)
    n, C = 3, 8
    toks = rng.integers(1, tcfg.vocab_size, size=(n, C)).astype(np.int32)
    offs = np.array([0, 8, 16], np.int32)
    clens = np.array([8, 5, 0], np.int32)     # last row is padding
    jcache = jax.tree.map(np.asarray, {
        "lengths": jnp.asarray(offs),
        "blocks": {k: jnp.asarray(rng.normal(
            size=(jcfg.n_layers, n, MAX_LEN, jcfg.n_kv_heads,
                  jcfg.hd)).astype(np.float32)) for k in ("k", "v")}})
    jl, jc = jax_chunk_prefill_fn(
        jcfg, jparams, jax.tree.map(jnp.asarray, jcache),
        jnp.asarray(toks), jnp.asarray(offs), jnp.asarray(clens),
        mesh=make_cpu_mesh())
    tcache = {"lengths": torch.from_numpy(offs),
              "blocks": {k: torch.from_numpy(v.copy())
                         for k, v in jcache["blocks"].items()}}
    tl, tc = chunk_prefill_fn(tcfg, tparams, tcache, torch.from_numpy(toks),
                              torch.from_numpy(offs),
                              torch.from_numpy(clens))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
    np.testing.assert_allclose(tc["blocks"]["k"].numpy(),
                               np.asarray(jc["blocks"]["k"]), **TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_other_dense_prefill_logits_match(other_models):
    _check_prefill(other_models)


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_other_dense_paged_decode_greedy_tokens_match(other_models,
                                                      attn_impl):
    _check_paged_decode(other_models, attn_impl)


def test_other_dense_chunk_prefill_matches(other_models):
    _check_chunk_prefill(other_models)


def test_other_dense_paths_are_taken(other_models):
    """Each arch reaches the path it is here for."""
    _, tcfg, _, tparams = other_models
    attn = tparams["blocks"]["attn"]
    if tcfg.name.startswith("granite-34b"):
        assert tcfg.n_kv_heads == 1 and tcfg.mlp_variant == "gelu"
    elif tcfg.name.startswith("minitron"):
        assert tcfg.mlp_variant == "gelu"
    else:
        assert tcfg.qkv_bias and tcfg.rope_theta == 1e6
        assert all(attn[b].abs().min() > 0 for b in ("bq", "bk", "bv"))
    assert ("w_gate" in tparams["blocks"]["ffn"]) == (
        tcfg.mlp_variant == "swiglu")


def test_init_cache_shape(models):
    _, tcfg, _, _ = models
    c = init_cache(tcfg, 2, MAX_LEN, device="cpu")
    assert tuple(c["blocks"]["k"].shape) == (
        tcfg.n_layers, 2, MAX_LEN, tcfg.n_kv_heads, tcfg.hd)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "xlstm-350m",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_unported_families_raise(arch):
    """Every family is ported.  vlm pages as the dense decoder it is (the
    paged and chunked entry points embed tokens only, as in the
    reference; tests/test_torch_vlm.py holds them against it).  The ssm,
    hybrid and audio families keep the reference's limit: no chunked or
    paged path (tests/test_torch_ssm.py, tests/test_torch_audio.py)."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")
    if cfg.family in ("ssm", "hybrid", "audio"):
        with pytest.raises(ValueError, match="attention-family"):
            chunk_prefill_fn(cfg, params, None, None, None, None)
        with pytest.raises(ValueError, match="attention-family"):
            paged_decode_fn(cfg, params, *([None] * 7), block_size=8)
        return
    n, mb = 2, MAX_LEN // BS
    pool = torch.zeros((cfg.n_layers, n * mb, BS, cfg.n_kv_heads, cfg.hd),
                       dtype=torch.bfloat16)
    tables = torch.arange(n * mb, dtype=torch.int32).reshape(n, mb)
    nxt, kp, _ = paged_decode_fn(
        cfg, params, pool, pool.clone(), tables,
        torch.tensor([1, 5], dtype=torch.int32),
        torch.tensor([0, mb], dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32),
        torch.tensor([3, 7], dtype=torch.int32), block_size=BS)
    assert nxt.shape == (n,) and kp[:, 0, 0].abs().sum() > 0
    cache = init_cache(cfg, n, MAX_LEN, device="cpu")
    logits, cache = chunk_prefill_fn(
        cfg, params, cache, torch.ones((n, 4), dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32),
        torch.tensor([4, 2], dtype=torch.int32))
    assert logits.shape == (n, cfg.vocab_size)
    assert cache["lengths"].tolist() == [4, 2]


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(get_smoke_config(ARCH), 0)
