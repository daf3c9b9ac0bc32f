"""The port's serving simulator and closed-form theory (repro_torch.core.
simulator, repro_torch.core.theory) against the reference's.

Both are host-side numpy, so they are held exactly: ``dataclasses.asdict``
of ``SimMetrics`` equal with ``==`` for every policy ``make_policy``
accepts, under all three dispatch modes (``central``, ``instant`` and the
kept oracle ``instant_ref``), with arrivals revealed by step and by
wall-clock time (the reference's fixtures, tests/test_simulator.py); the
``SimTrace`` lists equal element for element with per-worker load
snapshots on; and every function of ``theory`` equal with ``==`` over a
small grid.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import ArrivalInstance as JaxArrivalInstance
from repro.core import Request as JaxRequest
from repro.core import SimConfig as JaxSimConfig
from repro.core import SimTrace as JaxSimTrace
from repro.core import make_policy as jax_make_policy
from repro.core import simulate as jax_simulate
from repro.core import theory as jax_theory
from repro.core.energy import A100_POWER as JAX_A100_POWER
from repro.core.energy import TPU_V5E_POWER as JAX_TPU_V5E_POWER
from repro.data import LONGBENCH_LIKE as JAX_LONGBENCH_LIKE
from repro.data import poisson_trace as jax_poisson_trace
from repro_torch.core import (
    A100_POWER,
    TPU_V5E_POWER,
    ArrivalInstance,
    Request,
    SimConfig,
    SimTrace,
    make_policy,
    simulate,
    theory,
)
from repro_torch.data import LONGBENCH_LIKE, poisson_trace

POLICIES = ["fcfs", "jsq", "rr", "pod2", "bfio_h0", "bfio_h8"]
DISPATCH = ["central", "instant", "instant_ref"]


def _staggered(request_cls, instance_cls, n=200, seed=11):
    """The reference's instant-mode fixture: arrivals over 40 steps."""
    rng = np.random.default_rng(seed)
    reqs = [request_cls(rid=i, arrival_step=int(rng.integers(0, 40)),
                        prefill=float(rng.integers(1, 80)),
                        decode_len=int(rng.geometric(0.15)))
            for i in range(n)]
    return instance_cls(requests=reqs)


def _both(policy, dispatch, timed, trace_every=0):
    """(reference, port) metrics dicts and traces for one grid point."""
    out = []
    for sim, cfg_cls, pol, trace_cls, inst in (
            (jax_simulate, JaxSimConfig, jax_make_policy, JaxSimTrace,
             (lambda: jax_poisson_trace(JAX_LONGBENCH_LIKE, n_requests=80,
                                        rate=300.0, seed=5)) if timed else
             (lambda: _staggered(JaxRequest, JaxArrivalInstance))),
            (simulate, SimConfig, make_policy, SimTrace,
             (lambda: poisson_trace(LONGBENCH_LIKE, n_requests=80,
                                    rate=300.0, seed=5)) if timed else
             (lambda: _staggered(Request, ArrivalInstance)))):
        cfg = cfg_cls(G=4, B=6, dispatch=dispatch, seed=7,
                      time_based_arrivals=timed,
                      record_loads_every=trace_every)
        tr = trace_cls()
        m = sim(inst(), pol(policy), cfg, trace=tr)
        out.append((dataclasses.asdict(m), tr.asdict()))
    return out


@pytest.mark.parametrize("timed", [False, True], ids=["steps", "timed"])
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("policy", POLICIES)
def test_sim_metrics_equal(policy, dispatch, timed):
    (want, _), (got, _) = _both(policy, dispatch, timed)
    assert got == want
    assert got["completed"] > 0


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("policy", ["jsq", "bfio_h8"])
def test_sim_traces_equal(policy, dispatch):
    (_, want), (_, got) = _both(policy, dispatch, False, trace_every=3)
    assert got.keys() == want.keys()
    assert len(got["loads"]) > 0
    for key, ref in want.items():
        assert len(got[key]) == len(ref), key
        for a, b in zip(ref, got[key]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


GRID = [dict(B=B, G=G, p=p, sigma_s=sig, s_max=smax, mu_s=mu, c=c)
        for B, G in ((8, 1), (8, 2), (72, 256), (16, 1024))
        for p, sig, smax, mu in ((0.05, 3.0, 40.0, 12.0),
                                 (0.5, 0.25, 2.0, 1.5), (1.0, 1.0, 1.0, 1.0))
        for c in (1.0, 0.37)]


def _theory_values(mod, pms, g):
    B, G, p, sig, smax, mu, c = (g[k] for k in (
        "B", "G", "p", "sigma_s", "s_max", "mu_s", "c"))
    return [
        mod.snapshot_sigma(sig, p),
        mod.iir_homogeneous(B, G, 0.8, c=c),
        mod.iir_geometric(B, G, p, sig, smax, c=c),
        mod.iir_general_drift(B, G, p, sig, smax, c=c),
        mod.predicted_fcfs_imbalance(B, G, sig, p, c=c),
        mod.predicted_bfio_imbalance(G, smax, p),
        mod.eta_sum_fcfs_lower(B, G, mu, sig, p, c=c),
    ] + [mod.energy_saving_guarantee(B, G, p, mu, sig, smax, pm,
                                     c_alpha=c, c_eta=1.0 / c)
         for pm in pms]


@pytest.mark.parametrize("g", GRID, ids=lambda g: "-".join(
    f"{v:g}" for v in g.values()))
def test_theory_equal(g):
    want = _theory_values(jax_theory, (JAX_A100_POWER, JAX_TPU_V5E_POWER), g)
    got = _theory_values(theory, (A100_POWER, TPU_V5E_POWER), g)
    assert got == want
    assert sorted(theory.__all__) == sorted(jax_theory.__all__)
