"""The port's train step against the reference's on one smoke config of
each model family, on the CPU in float32; and the batches of
the port's training launcher (``launch.train.train_batches``, which
``launch/profile_train.py`` also takes) against what the reference's
launcher feeds each family.

Each family case runs 3 steps of the port's ``make_train_step`` at
``grad_accum`` 2 from the reference's weights (through
``params_from_numpy``) beside the reference's jitted ``make_train_step``
under ``make_cpu_mesh()``, both in float32 compute, on the same 3 batches:
4 x 32 tokens, about a fifth of the loss mask zeroed at random, seeded
normal ``patches`` (vlm) and ``frames`` (audio).

Tolerances: each step's loss within 1e-5 relative; the parameters as
``test_torch_training.py``'s ``TestTrain`` holds them: each entry within
twice the sum of the learning rates, the mean difference of a leaf within
1e-7.  xlstm-350m is held to its float32 spread instead: the loss within
2e-5 relative (twice the 1.08e-5 measured at step 3 of ``grad_accum`` 2 on
another batch) and the mean difference within 1e-6 (twice the 4.3e-7
these batches give).  Its gradients agree with the reference's within a
few 1e-5 of a leaf's largest entry, and AdamW moves an entry whose
gradient is that small by a whole learning rate, in the direction of
its sign, so entries of opposite sign on the two sides end up 2 lr apart
and the next losses move with them.
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
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_batches
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step)
from test_torch_training import _assert_trees_close, _bridged, _lr_sum

FAMILIES = {"dense": "granite-8b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "xlstm-350m", "hybrid": "zamba2-1.2b",
            "vlm": "llava-next-mistral-7b", "audio": "whisper-tiny"}
LOSS_RTOL = {"xlstm-350m": 2e-5}
MEAN_TOL = {"xlstm-350m": 1e-6}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
B, S, STEPS, ACCUM = 4, 32, 3, 2


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(
            np.int32)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.random((B, S)) >= 0.2).astype(np.float32)}
        if cfg.family == "vlm":
            b["patches"] = rng.normal(
                size=(B, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["frames"] = rng.normal(
                size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("arch", list(FAMILIES.values()),
                         ids=list(FAMILIES))
def test_train_steps_match_reference(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams, params = _bridged(jcfg)
    batches = _batches(cfg)
    step = make_train_step(cfg, AdamWConfig(**OPT), grad_accum=ACCUM,
                           compute_dtype="float32")
    jstep = jax.jit(jloop.make_train_step(
        jcfg, jopt.AdamWConfig(**OPT), mesh=make_cpu_mesh(),
        grad_accum=ACCUM, compute_dtype="float32"))
    opt, jstate = init_opt_state(params), jopt.init_opt_state(jparams)
    losses, jlosses = [], []
    for b in batches:
        loss, params, opt = step(params, opt, {
            k: torch.from_numpy(v) for k, v in b.items()})
        jloss, jparams, jstate = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        jlosses.append(float(jloss))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses,
                               rtol=LOSS_RTOL.get(arch, 1e-5))
    _assert_trees_close(params, jparams,
                        2 * _lr_sum(jopt.AdamWConfig(**OPT), STEPS),
                        f"{arch} params after {STEPS} steps",
                        mean_tol=MEAN_TOL.get(arch, 1e-7))


@pytest.mark.parametrize("arch", list(FAMILIES.values()),
                         ids=list(FAMILIES))
def test_profile_batches_match_the_launchers(arch):
    """``train_batches`` gives each family the keys, shapes and dtypes the
    reference's launcher (``repro.launch.train``) gives it: the token
    batch, plus float32 zeros of (B, patch_tokens, d) for vlm and of (B,
    encoder_seq, d) for audio."""
    from repro.data import token_batches as jax_token_batches
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    got = list(train_batches(cfg, batch=3, seq_len=16, n_batches=2, seed=5))
    want = list(jax_token_batches(vocab_size=jcfg.vocab_size, batch=3,
                                  seq_len=16, n_batches=2, seed=5))
    stubs = {"vlm": ("patches", jcfg.patch_tokens),
             "audio": ("frames", jcfg.encoder_seq)}
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        if jcfg.family in stubs:
            key, n = stubs[jcfg.family]
            w[key] = np.zeros((3, n, jcfg.d_model), np.float32)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
