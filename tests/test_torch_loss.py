"""The port's training loss (``repro_torch.models.loss_fn``) and its
pieces against the reference, on the CPU in float32.

For one smoke config of each of the six families, and for the other
four archs (granite-34b's one KV head, minitron-4b, qwen2-72b's QKV
biases, granite-moe-3b-a800m), the reference's
weights carried over with ``params_from_numpy``: the loss value and its
gradient on every leaf, the port's by autograd (each block under
``torch.utils.checkpoint``), the reference's by ``jax.value_and_grad``
(MoE at the one-device mesh from ``make_cpu_mesh()``).  The blocked
causal attention's outputs and gradients against ``jax.grad`` through the
reference's ``causal_attention``, with and without a sliding window and
ragged ``lengths``; ``cross_entropy_loss``; both branches of
``_chunked_lm_loss``.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of the leaf's largest entry (float32 sums taken in another order;
the MoE's router gradient is a sum over every token's picks); attention
outputs and gradients within 1e-5 (float32) and 2e-2 (bfloat16, the
reference's kernel tolerance).
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
from repro.models import attention as jax_attn
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import loss_fn as jax_loss_fn
from repro.models import split_params
from repro.models import transformer as jax_tf
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import layers, loss_fn, params_from_numpy
from repro_torch.models import transformer as tf

ARCHS = ["granite-8b", "qwen3-moe-30b-a3b", "xlstm-350m", "zamba2-1.2b",
         "llava-next-mistral-7b", "whisper-tiny", "granite-34b",
         "minitron-4b", "qwen2-72b", "granite-moe-3b-a800m"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, S - 5:] = 0.0
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            size=(B, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _port_value_and_grad(cfg, params, batch, remat=True):
    leaves = []

    def req(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t
    ps = layers.tree_map(req, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = loss_fn(cfg, ps, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    return float(loss.detach()), layers.tree_map(lambda t: by_id[id(t)], ps)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else got.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    batch = _batch(jcfg)
    mesh = make_cpu_mesh()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jb, mesh=mesh)))(jparams)
    tloss, tgrads = _port_value_and_grad(tcfg, tparams, batch)
    assert tloss == pytest.approx(float(jloss), rel=LOSS_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(layers.tree_leaves(tgrads))
    for path, jg in flat:
        t = tgrads
        for p in path:
            t = t[p.key if hasattr(p, "key") else p.idx]
        _close(t, jg, GRAD_TOL, f"{arch} grad {jax.tree_util.keystr(path)}")


def test_remat_changes_nothing():
    """Checkpointed blocks give the same loss and gradients, bit for bit,
    as the plain graph."""
    _, tcfg, _, tparams = _models("granite-8b")
    batch = _batch(tcfg, seed=1)
    l1, g1 = _port_value_and_grad(tcfg, tparams, batch, remat=True)
    l2, g2 = _port_value_and_grad(tcfg, tparams, batch, remat=False)
    assert l1 == l2
    for a, b in zip(layers.tree_leaves(g1), layers.tree_leaves(g2)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# blocked causal attention
# --------------------------------------------------------------------------

ATTN_CASES = [  # (sliding_window, ragged lengths)
    (0, False), (12, False), (0, True), (12, True)]
ATTN_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
               "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _attn_inputs(seed=0, Bq=2, Sq=40, Hq=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Bq, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(Bq, Sq, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, Hkv, hd)).astype(np.float32)
    cot = rng.normal(size=(Bq, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("window,ragged", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
def test_blocked_attention_matches_reference(window, ragged, dtype):
    """Output and (q, k, v) gradients of a weighted sum of the output:
    several query chunks, several key chunks, keys padded to the chunk."""
    jdt, tdt, tol = ATTN_DTYPES[dtype]
    q, k, v, cot = _attn_inputs()
    lens = np.array([40, 29], np.int32) if ragged else None
    kw = dict(sliding_window=window, kv_chunk=16, q_chunk=16)

    def jf(q_, k_, v_):
        o = jax_attn.causal_attention(
            q_, k_, v_, lengths=None if lens is None else jnp.asarray(lens),
            **kw)
        return jnp.sum(o.astype(jnp.float32) * cot), o

    (_, jo), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    to = attn.blocked_causal_attention(
        *ts, lengths=None if lens is None else torch.from_numpy(lens), **kw)
    (to.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo, np.float32), atol=tol,
                               rtol=tol)
    for name, t, g in zip("qkv", ts, jg):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g, np.float32), atol=tol,
                                   rtol=tol, err_msg=f"d{name}")


def test_blocked_attention_forward_equals_serving_attention():
    """Without autograd the blocked attention computes what the serving
    path's direct masked softmax computes, in float32."""
    q, k, v, _ = _attn_inputs(seed=2)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    lens = torch.tensor([40, 23], dtype=torch.int32)
    got = attn.blocked_causal_attention(*ts, lengths=lens, kv_chunk=16,
                                        q_chunk=16)
    want = attn.causal_attention(*ts, lengths=lens)
    # rows past a ragged length attend to nothing valid in both; compare
    # the valid ones
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1, :23], want[1, :23], atol=1e-5,
                               rtol=1e-5)


# --------------------------------------------------------------------------
# the LM loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = jax_layers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("S,chunk", [(24, 8), (24, 5), (24, 24)])
@pytest.mark.parametrize("tied", [False, True])
def test_chunked_lm_loss_matches_reference(S, chunk, tied):
    """The scanned branch (S a multiple of the chunk and longer than it)
    and the one-pass branch; the port's pending residual ``r`` added in
    the final norm equals the reference's summed stream."""
    jcfg, tcfg, jparams, tparams = _models("granite-8b")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=tied)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=tied)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    r = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    mask = (rng.random((2, S)) > 0.2).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda xx: jax_tf._chunked_lm_loss(
            jcfg, jparams, xx, jnp.asarray(targets), jnp.asarray(mask),
            chunk=chunk))(jnp.asarray(x + r))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tf._chunked_lm_loss(tcfg, tparams, tx, torch.from_numpy(r),
                              torch.from_numpy(targets),
                              torch.from_numpy(mask), chunk=chunk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    _close(tx.grad, jg, 1e-5, "d x")
