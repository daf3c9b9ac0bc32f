"""The port's per-slot reference engine (``EngineConfig(engine_mode="ref")``)
against the reference package's ``ref`` engine and against the port's own
``vec`` engine, on the same request stream.

The setup is the reference's own ref/vec gate (tests/test_engine_vectorized
.py): the tiny dense config in float32, G=2 workers x B=4 slots, its
policies and its drift models.  The reference engine's weights are bridged
into the port, so ``stats()`` is held equal with ``==`` (time and energy
are modelled), and so are every request's generation and worker.  The
tiny SSM config runs on the slot backend too.  The ``ref`` mode keeps the
reference's scope: the paged backend and chunked prefill are refused with
its ``ValueError``.
"""
import warnings

warnings.filterwarnings("ignore")

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import make_policy as jax_make_policy
from repro.core.workload import constant_drift as jax_constant_drift
from repro.core.workload import fractional_drift as jax_fractional_drift
from repro.core.workload import unit_drift as jax_unit_drift
from repro.launch.mesh import make_cpu_mesh
from repro.models import init_params as jax_init_params
from repro.models import split_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_policy
from repro_torch.core.workload import (
    constant_drift,
    fractional_drift,
    unit_drift,
)
from repro_torch.models import params_from_numpy
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
SSM = dict(name="tiny-ssm", family="ssm", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=128, ssm_state=16,
           dtype="float32")
G, B, MAX_SEQ = 2, 4, 64
# (reference factory, port factory) of each drift model of the gate
DRIFTS = {
    "unit": (jax_unit_drift, unit_drift),
    "constant": (jax_constant_drift, constant_drift),
    "fractional": (lambda: jax_fractional_drift(6.0 / 38.0),
                   lambda: fractional_drift(6.0 / 38.0)),
}


@pytest.fixture(scope="module")
def mesh():
    return make_cpu_mesh()


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port params) by name."""
    out = {}
    for name, kw in (("tiny", TINY), ("ssm", SSM)):
        jcfg = JaxModelConfig(**kw)
        jparams, _ = split_params(jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        out[name] = (jcfg, ModelConfig(**kw), jparams, tparams)
    return out


def _requests(cls, n=14, seed=3, max_new=(3, 10), plen=(4, 30)):
    """The gate's stream (tests/test_engine_vectorized.py)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, 128,
                                           size=int(rng.integers(*plen))),
                max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run(max_steps=1000), reqs


def _three_runs(models, mesh, name, policy, drift="unit"):
    """The reference's ref engine, the port's ref engine and the port's
    vec engine on one stream: [(stats, generations, workers)] x 3."""
    jcfg, tcfg, jparams, tparams = models[name]
    jdrift, tdrift = DRIFTS[drift]
    kw = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              cache_backend="slot")
    runs = [_run(JaxServingEngine(
        jcfg, jparams, JaxEngineConfig(engine_mode="ref", **kw),
        jax_make_policy(policy), mesh=mesh, drift=jdrift()),
        _requests(JaxServeRequest))]
    for mode in ("ref", "vec"):
        runs.append(_run(ServingEngine(
            tcfg, tparams, EngineConfig(engine_mode=mode, **kw),
            make_policy(policy), device="cpu", drift=tdrift()),
            _requests(ServeRequest)))
    return [(stats, [r.generated for r in reqs], [r.worker for r in reqs])
            for stats, reqs in runs]


def _assert_equal(runs):
    (js, jg, jw), (rs, rg, rw), (vs, vg, vw) = runs
    assert rs == js, "port ref stats differ from the reference's ref"
    assert vs == rs, "port vec stats differ from the port's ref"
    assert rg == jg and vg == rg, "generations diverged"
    assert rw == jw and vw == rw, "workers differ"
    assert js["tokens"] > 0


@pytest.mark.parametrize("policy", ["fcfs", "jsq", "pod2", "bfio_h0"])
def test_ref_engine_policies(models, mesh, policy):
    _assert_equal(_three_runs(models, mesh, "tiny", policy))


@pytest.mark.parametrize("drift", list(DRIFTS))
def test_ref_engine_drift_models(models, mesh, drift):
    _assert_equal(_three_runs(models, mesh, "tiny", "bfio_h0", drift))


def test_ref_engine_ssm(models, mesh):
    """A recurrent family on the slot backend: the full-batch decode
    carries every slot's recurrent state, idle ones included."""
    _assert_equal(_three_runs(models, mesh, "ssm", "bfio_h8"))


@pytest.mark.parametrize("kw", [dict(cache_backend="paged"),
                                dict(prefill_chunk=8),
                                dict(prefill_budget=8)],
                         ids=["paged", "chunked", "budget"])
def test_ref_scope_refused_like_reference(models, mesh, kw):
    jcfg, tcfg, jparams, tparams = models["tiny"]
    ec = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              engine_mode="ref", **kw)
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jcfg, jparams, JaxEngineConfig(**ec),
                         jax_make_policy("fcfs"), mesh=mesh)
    with pytest.raises(ValueError) as got:
        ServingEngine(tcfg, tparams, EngineConfig(**ec), make_policy("fcfs"),
                      device="cpu")
    assert str(got.value) == str(want.value)
