"""The port's training substrate (``repro_torch.training``) against the
reference's, on the CPU.

The reference's own cases (``tests/test_training.py``: ``TestOptimizer``,
``TestGradAccum``, ``TestCheckpoint``) run on the port and are held
against the reference's values on the same inputs; then the loss history
and the parameters after 5 steps of ``train`` on granite-8b-smoke from
bridged weights, checkpoints written by either package loading in the
other, and the launcher with ``--smoke --device cpu``.

Tolerances: optimizer arithmetic within 1e-6 relative (the same float32
formula; ``pow`` and ``cos`` may round an ulp apart); train steps in
float32 compute within 1e-5 relative on the loss; in the reference's
default bfloat16 compute within 2e-2 on the loss (the bfloat16 matmuls
round differently in XLA and in PyTorch).  On the parameters, each
entry within twice the sum of the learning rates (AdamW moves a
parameter by about the learning rate a step whatever its gradient's
size, so a component whose tiny gradient the two sides' sums give
opposite signs ends up that far apart), and the mean difference of a
leaf within 1e-7 (float32) or 1e-4 (bfloat16).
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
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data import token_batches
from repro.launch.mesh import make_cpu_mesh
from repro.models import init_params as jax_init_params
from repro.models import split_params as jax_split_params
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import save_checkpoint as jax_save_checkpoint
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import params_from_numpy
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.training import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    train,
)
from repro_torch.training import optimizer as topt
from repro_torch.training.checkpoint import latest_step

CFG = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
OPT_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _n(t):
    return t.detach().float().numpy()


def _bridged(jcfg, seed=0):
    jp, _ = jax_split_params(jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_trees_close(tparams, jparams, atol, what, mean_tol=None):
    """Every leaf within ``atol``; with ``mean_tol``, also the mean
    absolute difference over all entries of a leaf."""
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(tparams))
    for path, jl in flat:
        t = tparams
        for p in path:
            t = t[p.key]
        where = f"{what} {jax.tree_util.keystr(path)}"
        diff = np.abs(_n(t) - np.asarray(jl, np.float32))
        assert diff.max() <= atol, (where, diff.max())
        if mean_tol is not None:
            assert diff.mean() <= mean_tol, (where, diff.mean())


def _lr_sum(opt, n):
    """The sum of the first ``n`` steps' learning rates: AdamW moves a
    parameter by at most about this much whatever its gradient."""
    return sum(float(jopt.cosine_schedule(opt, jnp.asarray(i + 1)))
               for i in range(n))


class TestOptimizer:
    def test_adamw_decreases_quadratic(self):
        """The reference's case, and every step's params equal to the
        reference's."""
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
        jcfg = jopt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
        params, jparams = {"w": _t([3.0, -2.0])}, {"w": jnp.array([3.0, -2.0])}
        state, jstate = init_opt_state(params), jopt.init_opt_state(jparams)
        for _ in range(200):
            params, state = adamw_update(cfg, params, {"w": 2 * params["w"]},
                                         state)
            jparams, jstate = jopt.adamw_update(
                jcfg, jparams, {"w": 2 * jparams["w"]}, jstate)
            np.testing.assert_allclose(_n(params["w"]), jparams["w"],
                                       rtol=1e-5, atol=1e-6)
        assert float(params["w"].abs().max()) < 0.05
        assert int(state.step) == 200

    def test_grad_clipping(self):
        cfg = AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        p2, s2 = adamw_update(cfg, params, {"w": torch.full((4,), 1e9)},
                              init_opt_state(params))
        # clipped grad -> m bounded by (1-b1) * clip_norm
        assert float(s2.m["w"].abs().max()) <= 0.1 + 1e-6
        jp2, js2 = jopt.adamw_update(
            jopt.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0),
            {"w": jnp.zeros(4)}, {"w": jnp.full(4, 1e9)},
            jopt.init_opt_state({"w": jnp.zeros(4)}))
        np.testing.assert_allclose(_n(s2.m["w"]), js2.m["w"], rtol=OPT_RTOL)
        np.testing.assert_allclose(_n(s2.v["w"]), js2.v["w"], rtol=OPT_RTOL)
        np.testing.assert_allclose(_n(p2["w"]), jp2["w"], rtol=OPT_RTOL)

    @pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 64, 99, 100, 150])
    def test_schedule_warmup_and_decay(self, step):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
        jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_frac=0.1)
        got = float(topt.cosine_schedule(cfg, torch.tensor(step)))
        want = float(jopt.cosine_schedule(jcfg, jnp.asarray(step)))
        assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-7)
        if step == 0:
            assert got == 0.0
        if step == 10:
            assert got == pytest.approx(1.0)
        if step == 100:
            assert got == pytest.approx(0.1, rel=1e-3)

    def test_weight_decay_pulls_to_zero(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
        jcfg = jopt.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
        params, jparams = {"w": _t([5.0])}, {"w": jnp.array([5.0])}
        state, jstate = init_opt_state(params), jopt.init_opt_state(jparams)
        for _ in range(50):
            params, state = adamw_update(cfg, params, {"w": torch.zeros(1)},
                                         state)
            jparams, jstate = jopt.adamw_update(
                jcfg, jparams, {"w": jnp.zeros(1)}, jstate)
        assert float(params["w"][0]) < 5.0
        np.testing.assert_allclose(_n(params["w"]), jparams["w"],
                                   rtol=OPT_RTOL)

    def test_global_norm(self):
        tree = {"b": _t([4.0]), "a": _t([3.0]), "c": {"d": _t([[1.0, 2.0]])}}
        want = jopt.global_norm(jax.tree.map(jnp.asarray, tree_map(
            _n, tree)))
        got = topt.global_norm(tree)
        assert float(got) == pytest.approx(float(want), rel=OPT_RTOL)
        assert float(topt.global_norm({"a": _t([3.0]), "b": _t([4.0])})) \
            == pytest.approx(5.0)

    def test_update_on_random_tree_matches_reference(self):
        """A multi-leaf update with clipping active, a bfloat16 leaf and a
        few steps into the schedule; and ``donate=True`` (in place) equals
        the functional update bit for bit."""
        rng = np.random.default_rng(0)
        shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}}
        params = tree_map(lambda s: _t(rng.normal(size=s)), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
        params["b"]["d"] = params["b"]["d"].to(torch.bfloat16)
        jparams = jax.tree.map(jnp.asarray, tree_map(_n, params))
        jparams["b"]["d"] = jparams["b"]["d"].astype(jnp.bfloat16)
        cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                          clip_norm=0.5)
        jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                                clip_norm=0.5)
        state, jstate = init_opt_state(params), jopt.init_opt_state(jparams)
        for i in range(4):
            g = tree_map(lambda p: _t(rng.normal(size=tuple(p.shape))),
                         params)
            jg = jax.tree.map(jnp.asarray, tree_map(_n, g))
            donated = tree_map(torch.clone, params)
            dstate = topt.OptState(state.step, tree_map(torch.clone, state.m),
                                   tree_map(torch.clone, state.v))
            params, state = adamw_update(cfg, params, g, state)
            dp, ds = adamw_update(cfg, donated, g, dstate, donate=True)
            assert all(a is b for a, b in zip(tree_leaves(dp),
                                              tree_leaves(donated)))
            for a, b in zip(tree_leaves((params, state.m, state.v)),
                            tree_leaves((dp, ds.m, ds.v))):
                assert torch.equal(a, b)
            jparams, jstate = jopt.adamw_update(jcfg, jparams, jg, jstate)
            assert params["b"]["d"].dtype == torch.bfloat16
            for t, j, tol in ((params["a"], jparams["a"], 1e-6),
                              (params["b"]["c"], jparams["b"]["c"], 1e-6),
                              (params["b"]["d"], jparams["b"]["d"], 1e-2)):
                np.testing.assert_allclose(_n(t), np.asarray(j, np.float32),
                                           rtol=tol, atol=tol)
            np.testing.assert_allclose(_n(state.v["a"]), jstate.v["a"],
                                       rtol=1e-5)


class TestGradAccum:
    @pytest.mark.parametrize("accum", [2, 4])
    def test_accum_matches_full_batch(self, accum):
        """grad_accum gives the same update as the full batch, and as the
        reference's accumulated step."""
        jcfg = JaxModelConfig(**CFG)
        cfg = ModelConfig(**CFG)
        jparams, params = _bridged(jcfg)
        batch = next(token_batches(vocab_size=64, batch=4, seq_len=16,
                                   n_batches=1, seed=0))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        ocfg = AdamWConfig(warmup_steps=0)
        s1 = make_train_step(cfg, ocfg, grad_accum=1, compute_dtype="float32")
        s2 = make_train_step(cfg, ocfg, grad_accum=accum,
                             compute_dtype="float32")
        opt = init_opt_state(params)
        l1, p1, _ = s1(params, opt, tb)
        l2, p2, _ = s2(params, opt, tb)
        assert float(l1) == pytest.approx(float(l2), rel=1e-5)
        for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        js = jloop.make_train_step(jcfg, jopt.AdamWConfig(warmup_steps=0),
                                   mesh=make_cpu_mesh(), grad_accum=accum,
                                   compute_dtype="float32")
        jl, jp, _ = jax.jit(js)(jparams, jopt.init_opt_state(jparams),
                                {k: jnp.asarray(v) for k, v in batch.items()})
        assert float(l2) == pytest.approx(float(jl), rel=1e-5)
        _assert_trees_close(p2, jp, 1e-5, "params")

    def test_mesh_arguments_raise(self):
        """The mesh arguments (formerly refused, naming ROADMAP item 12c)
        on the port's one-rank CPU mesh, params placed by the train-mode
        rules and the batch by ``batch_shardings``: one step with and
        without ``grad_accum`` equals ``mesh=None``'s bit for bit (the
        same ops on the same local tensors), the loss replicated and m
        and v placed like the params."""
        from torch.distributed.tensor import Replicate

        from repro_torch.launch import mesh as pm
        from repro_torch.models import param_axes
        cfg = ModelConfig(**CFG)
        _, params = _bridged(JaxModelConfig(**CFG))
        batch = {k: torch.from_numpy(v) for k, v in next(token_batches(
            vocab_size=64, batch=4, seq_len=16, n_batches=1,
            seed=0)).items()}
        started = not torch.distributed.is_initialized()
        mesh = pm.make_cpu_mesh()
        try:
            sh = pm.param_shardings(param_axes(cfg), cfg, mesh,
                                    mode="train")
            for accum in (1, 2):
                ocfg = AdamWConfig(warmup_steps=0)
                l0, p0, o0 = make_train_step(cfg, ocfg, grad_accum=accum)(
                    params, init_opt_state(params), batch)
                dp = pm.distribute_tree(params, sh)
                step = make_train_step(
                    cfg, ocfg, mesh=mesh, grad_accum=accum,
                    act_spec=pm.activation_spec(cfg, mesh, 4),
                    grad_shardings=sh)
                l1, p1, o1 = step(dp, init_opt_state(dp), pm.distribute_tree(
                    batch, pm.batch_shardings(batch, mesh, 4)))
                assert tuple(l1.placements) == (Replicate(), Replicate())
                assert torch.equal(l0, l1.full_tensor())
                for a, b in zip(tree_leaves((p0, o0.m, o0.v)),
                                tree_leaves((p1, o1.m, o1.v))):
                    assert torch.equal(a, b.full_tensor())
                for p, m in zip(tree_leaves(p1), tree_leaves(o1.m)):
                    assert p.placements == m.placements
        finally:
            if started:
                torch.distributed.destroy_process_group()


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.ones(4, dtype=torch.int32),
                      "e": torch.full((3,), 1.5, dtype=torch.bfloat16)}}
        save_checkpoint(str(tmp_path), 7, tree)
        like = tree_map(torch.zeros_like, tree)
        loaded, step = load_checkpoint(str(tmp_path), like)
        assert step == 7
        for x, y in zip(tree_leaves(tree), tree_leaves(loaded)):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)

    def test_latest_of_many(self, tmp_path):
        tree = {"w": torch.zeros(2)}
        for s in (1, 5, 3):
            save_checkpoint(str(tmp_path), s, tree)
        _, step = load_checkpoint(str(tmp_path), tree)
        assert step == 5
        assert latest_step(str(tmp_path / "none")) is None
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "none"), tree)

    def test_shape_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
        with pytest.raises(ValueError):
            load_checkpoint(str(tmp_path), {"w": torch.zeros(3)})

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_loads_in_the_other_package(self, tmp_path, writer):
        """A train checkpoint tree (params, opt m and v) written by one
        package loads in the other, every leaf equal, under the same
        keys."""
        jcfg = dataclasses.replace(jax_smoke_config("zamba2-1.2b"),
                                   dtype="float32")
        jparams, params = _bridged(jcfg)
        jtree = {"params": jparams, "opt_m": jax.tree.map(
            lambda a: a * 0.5, jparams), "opt_v": jparams}
        ttree = {"params": params, "opt_m": tree_map(lambda a: a * 0.5,
                                                     params),
                 "opt_v": params}
        if writer == "reference":
            jax_save_checkpoint(str(tmp_path), 3, jtree)
            got, step = load_checkpoint(str(tmp_path), tree_map(
                torch.zeros_like, ttree))
            assert step == 3
            for a, b in zip(tree_leaves(got), tree_leaves(ttree)):
                assert torch.equal(a, b)
        else:
            save_checkpoint(str(tmp_path), 3, ttree)
            got, step = jax_load_checkpoint(str(tmp_path), jax.tree.map(
                jnp.zeros_like, jtree))
            assert step == 3
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        keys = sorted(np.load(next(tmp_path.glob("*.npz"))).files)
        assert "params/m0/ssm/w_in" in keys and "opt_v/shared_attn/norm1" \
            in keys


def _stream(cfg, n=5, seed=3):
    return list(token_batches(vocab_size=cfg.vocab_size, batch=2,
                              seq_len=32, n_batches=n, seed=seed))


class TestTrain:
    OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)

    def test_five_steps_float32_match_reference(self):
        """The port's ``train`` in float32 compute against the reference's
        train step (jitted, float32 compute) over the same 5 batches."""
        jcfg = dataclasses.replace(jax_smoke_config("granite-8b"),
                                   dtype="float32")
        cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                                  dtype="float32")
        jparams, params = _bridged(jcfg)
        batches = _stream(cfg, n=1) * 5          # one batch, memorised
        logs = []
        params, losses = train(cfg, params=params, batches=batches,
                               opt_cfg=AdamWConfig(**self.OPT), log_every=2,
                               log_fn=logs.append, compute_dtype="float32")
        step = jax.jit(jloop.make_train_step(
            jcfg, jopt.AdamWConfig(**self.OPT), mesh=make_cpu_mesh(),
            compute_dtype="float32"))
        jopt_state = jopt.init_opt_state(jparams)
        jlosses = []
        for b in batches:
            loss, jparams, jopt_state = step(
                jparams, jopt_state, {k: jnp.asarray(v) for k, v in b.items()})
            jlosses.append(float(loss))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert losses[-1] < losses[0]
        _assert_trees_close(params, jparams,
                            2 * _lr_sum(jopt.AdamWConfig(**self.OPT), 5),
                            "params after 5 steps", mean_tol=1e-7)
        assert [m.split()[1] for m in logs] == ["0", "2", "4"]

    def test_five_steps_default_precision_match_reference(self, tmp_path):
        """``train`` as the reference calls it (bfloat16 compute from
        float32 masters), beside the reference's ``train``; checkpoints
        every 2 steps."""
        jcfg = dataclasses.replace(jax_smoke_config("granite-8b"),
                                   dtype="float32")
        cfg = dataclasses.replace(get_smoke_config("granite-8b"),
                                  dtype="float32")
        jparams, params = _bridged(jcfg)
        batches = _stream(cfg, seed=4)
        params, losses = train(cfg, params=params, batches=batches,
                               opt_cfg=AdamWConfig(**self.OPT), log_every=0,
                               ckpt_dir=str(tmp_path), ckpt_every=2)
        jparams, jlosses = jloop.train(
            jcfg, params=jparams, batches=batches,
            opt_cfg=jopt.AdamWConfig(**self.OPT), mesh=make_cpu_mesh(),
            log_every=0)
        np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
        _assert_trees_close(params, jparams,
                            2 * _lr_sum(jopt.AdamWConfig(**self.OPT), 5),
                            "params after 5 steps", mean_tol=1e-4)
        assert latest_step(str(tmp_path)) == 4
        saved, _ = load_checkpoint(str(tmp_path), {"params": params})
        assert all(t.dtype == torch.float32
                   for t in tree_leaves(saved["params"]))


def test_launcher_smoke_cpu(capsys):
    losses = launch_train.main(["--arch", "granite-8b", "--smoke",
                                "--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] granite-8b-smoke" in out and "done: loss" in out


def test_launcher_refuses_multi_pod():
    """``--multi-pod`` asks for the reference's 2 x 16 x 16 production mesh
    (formerly refused, naming ROADMAP item 12c): on one rank it raises,
    naming the world size it needs, never falling back to one rank, and
    leaves no process group behind."""
    with pytest.raises(RuntimeError, match="512 ranks"):
        launch_train.main(["--arch", "granite-8b", "--smoke", "--device",
                           "cpu", "--multi-pod"])
    assert not torch.distributed.is_initialized()
