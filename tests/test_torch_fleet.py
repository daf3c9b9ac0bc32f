"""The port's fleet tier (repro_torch.fleet, obs.ledger, data) against the
reference's (repro.fleet, repro.obs.ledger, repro.data) on the same
scenario traces and the same bridged float32 weights, on the CPU.

Everything is held exactly (``==``): the fleet's time and energy are
modelled, so ``stats()``, every telemetry step and request row, every
generation, the straggler ledger and the span trace are equal when the
scheduling is — under every router family (round_robin, least_loaded,
pod2, bfio, bfio_h2, pod_bfio_p2, bfio_affinity), in both fleet modes,
on six scenarios; for the async fleet under both autoscalers, with
drain handoffs.  The reference's ref and vec fleet modes are themselves
bit-identical (its own gate), so each reference run is made once and
held against both of the port's modes.  The host-side numpy modules
(ledger arithmetic, scenarios and traces) are held seed for seed, and
telemetry JSONL crosses between the packages both ways.
"""
import warnings

warnings.filterwarnings("ignore")

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import data as ref_data
from repro.configs.base import ModelConfig as RefModelConfig
from repro.fleet import AsyncFleetServer as RefAsyncFleetServer
from repro.fleet import FleetServer as RefFleetServer
from repro.fleet import FleetTelemetry as RefFleetTelemetry
from repro.fleet import make_autoscaler as ref_make_autoscaler
from repro.fleet import make_scenario as ref_make_scenario
from repro.launch.mesh import make_cpu_mesh
from repro.models import init_params as ref_init_params
from repro.models import split_params
from repro.obs import SpanRecorder as RefSpanRecorder
from repro.obs import ledger as ref_ledger
from repro.obs import to_chrome_trace as ref_chrome_trace
from repro_torch import data
from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_policy
from repro_torch.fleet import (
    SCENARIOS,
    AsyncFleetServer,
    FleetServer,
    FleetTelemetry,
    make_autoscaler,
    make_scenario,
    validate_scenario,
)
from repro_torch.models import params_from_numpy
from repro_torch.obs import SpanRecorder, ledger, to_chrome_trace
from repro_torch.serving import EngineConfig, ServingEngine

TINY = dict(name="tiny", family="dense", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32")
CFG = ModelConfig(**TINY)
R = 4
EC = dict(n_workers=2, slots_per_worker=2, max_seq_len=64,
          cache_backend="paged", step_overhead=1e-3, t_token=2e-4)
ROUTERS = ["round_robin", "least_loaded", "pod2", "bfio", "bfio_h2",
           "pod_bfio_p2", "bfio_affinity"]
SCENARIO_RUNS = {"flash_crowd": dict(n_requests=16, seed=1),
                 "agentic": dict(n_requests=14, seed=2),
                 "diurnal": dict(n_requests=20, seed=1),
                 "flash_crowd_32": dict(n_requests=32, seed=1,
                                        name="flash_crowd"),
                 "steady": dict(n_requests=16, seed=3),
                 "long_doc": dict(n_requests=12, seed=4),
                 "trickle": dict(n_requests=12, seed=5),
                 "multi_turn": dict(n_requests=18, seed=6)}
# the barrier fleet's scenarios; multi_turn's later turns share their
# session's prefix, which bfio_affinity and the LRU prefix cache act on
COMPARED = ["flash_crowd", "agentic", "steady", "long_doc", "trickle",
            "multi_turn"]
SCENARIO_EC = {"multi_turn": dict(prefix_cache=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny tensors: faster alone,
    and the suite runs in several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    rcfg = RefModelConfig(**TINY)
    rparams, _ = split_params(ref_init_params(rcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                device="cpu")
    return rcfg, rparams, tparams, make_cpu_mesh()


def _scenario(make, name, ec_kw=EC):
    kw = SCENARIO_RUNS[name]
    return make(kw.get("name", name), n_requests=kw["n_requests"],
                n_replicas=R,
                n_workers=ec_kw["n_workers"],
                slots_per_worker=ec_kw["slots_per_worker"],
                max_seq_len=EC["max_seq_len"], vocab_size=128,
                seed=kw["seed"], step_overhead=EC["step_overhead"],
                t_token=EC["t_token"])


def _outcome(fleet, tel, rec=None) -> dict:
    out = {"stats": fleet.stats(), "steps": tel.steps,
           "requests": tel.requests,
           "generated": [list(r.generated) for r in fleet.requests],
           "assignments": dict(fleet.assignments),
           "ledger": fleet.straggler_ledger()}
    if rec is not None:
        out["trace"] = rec
    return out


def _run(side, weights, router, scenario, *, fleet_mode="vec",
         ec_kw=None, fleet_cls=None, trace=False, **kw):
    """One fleet run on one side ("ref" or "port"); returns everything
    that is compared."""
    rcfg, rparams, tparams, mesh = weights
    ec_kw = {**EC, **(ec_kw or {})}
    if side == "ref":
        tel, rec = RefFleetTelemetry(), RefSpanRecorder() if trace else None
        cls = RefAsyncFleetServer if fleet_cls == "async" \
            else RefFleetServer
        from repro.serving import EngineConfig as RefEngineConfig
        fleet = cls(rcfg, rparams, RefEngineConfig(**ec_kw), n_replicas=R,
                    router=router, policy="bfio_h0", mesh=mesh,
                    telemetry=tel, fleet_mode=fleet_mode, obs=rec, **kw)
        fleet.submit_scenario(_scenario(ref_make_scenario, scenario, ec_kw))
        chrome = ref_chrome_trace
    else:
        tel, rec = FleetTelemetry(), SpanRecorder() if trace else None
        cls = AsyncFleetServer if fleet_cls == "async" else FleetServer
        fleet = cls(CFG, tparams, EngineConfig(**ec_kw), n_replicas=R,
                    router=router, policy="bfio_h0", device="cpu",
                    telemetry=tel, fleet_mode=fleet_mode, obs=rec, **kw)
        fleet.submit_scenario(_scenario(make_scenario, scenario, ec_kw))
        chrome = to_chrome_trace
    fleet.run()
    return _outcome(fleet, tel, chrome(rec) if trace else None)


_REF: dict = {}


def _reference(weights, router, scenario):
    """The reference's run of one (router, scenario), made once."""
    key = (router, scenario)
    if key not in _REF:
        _REF[key] = _run("ref", weights, router, scenario,
                         ec_kw=SCENARIO_EC.get(scenario))
    return _REF[key]


def _assert_equal(got, want):
    for key in want:
        assert got[key] == want[key], f"{key} differs"


@pytest.mark.parametrize("fleet_mode", ["vec", "ref"])
@pytest.mark.parametrize("scenario", COMPARED)
@pytest.mark.parametrize("router", ROUTERS)
def test_fleet_matches_reference(weights, router, scenario, fleet_mode):
    want = _reference(weights, router, scenario)
    got = _run("port", weights, router, scenario, fleet_mode=fleet_mode,
               ec_kw=SCENARIO_EC.get(scenario))
    _assert_equal(got, want)
    assert got["stats"]["completed"] == SCENARIO_RUNS[scenario][
        "n_requests"]


def test_routing_steps_have_several_candidates(weights):
    """The comparison above is not vacuous: the burst puts several
    candidates into one routing step, and BF-IO places them unlike
    round-robin."""
    bfio = _reference(weights, "bfio", "flash_crowd")
    rr = _reference(weights, "round_robin", "flash_crowd")
    routed = [r["t_routed"] for r in bfio["requests"]]
    assert max(routed.count(t) for t in set(routed)) >= 3
    assert bfio["assignments"] != rr["assignments"]


def test_multi_turn_hits_the_prefix_cache(weights):
    """multi_turn's comparison is not vacuous either: later turns hit
    their session's cached prefix, and the affinity term moves requests
    away from plain BF-IO's placement."""
    aff = _reference(weights, "bfio_affinity", "multi_turn")
    bfio = _reference(weights, "bfio", "multi_turn")
    assert aff["stats"]["prefix_hits"] > 0
    assert aff["assignments"] != bfio["assignments"]


def test_traced_fleet_matches_reference(weights):
    """Span trace and straggler ledger, with tracing on."""
    want = _run("ref", weights, "bfio", "flash_crowd", trace=True)
    got = _run("port", weights, "bfio", "flash_crowd", trace=True)
    _assert_equal(got, want)
    assert got["ledger"]["total_idle_j"] == got["stats"]["idle_j"]
    assert got["trace"]["traceEvents"]


@pytest.mark.parametrize("router", ["round_robin", "pod2", "bfio",
                                    "pod_bfio_p2", "bfio_affinity"])
def test_single_replica_fleet_equals_bare_engine(weights, router):
    """fleet(R=1, router=*) on a stream arriving at t=0 submits the
    identical sequence a bare engine sees, so the replica's stats and
    generations equal the engine's."""
    _, _, tparams, _ = weights
    ec = EngineConfig(**EC)
    sc = _scenario(make_scenario, "flash_crowd")
    fleet = FleetServer(CFG, tparams, ec, n_replicas=1, router=router,
                        policy="bfio_h0", device="cpu")
    for r in sc.requests:
        fleet.submit(r.to_serve_request())
    fleet.run()
    eng = ServingEngine(CFG, tparams, ec, make_policy("bfio_h0"),
                        device="cpu")
    reqs = [r.to_serve_request() for r in sc.requests]
    for r in reqs:
        eng.submit(r)
    assert fleet.engines[0].stats() == eng.run()
    assert [r.generated for r in fleet.requests] == \
        [r.generated for r in reqs]


ASYNC_EC = {**EC, "slots_per_worker": 4, "prefill_chunk": 16}


@pytest.mark.parametrize("autoscaler,scenario", [("util", "diurnal"),
                                                 ("slo", "flash_crowd_32")])
def test_async_fleet_matches_reference(weights, autoscaler, scenario):
    """Autoscaled async fleet (paged backend, swap): each autoscaler
    drains replicas that hold residents on its trace, so requests hand
    off through the ported ``ServingEngine.drain``."""
    kw = dict(r_min=1, r_max=R, interval_s=0.01, warmup_s=0.005)
    if autoscaler == "slo":      # shed replicas below 90% utilization
        kw["low_util"] = 0.9
    runs = {}
    for side, make in (("ref", ref_make_autoscaler),
                       ("port", make_autoscaler)):
        runs[side] = _run(side, weights, "bfio", scenario,
                          ec_kw=ASYNC_EC, fleet_cls="async",
                          autoscaler=make(autoscaler, **kw),
                          max_snapshot_age=0.01)
    _assert_equal(runs["port"], runs["ref"])
    stats = runs["port"]["stats"]
    assert stats["fleet_kind"] == "async"
    assert stats["scale_ups"] + stats["scale_downs"] > 0
    assert stats["drain_handoffs"] > 0, "no drain handoff: vacuous"
    assert stats["drain_tokens_lost"] == 0 and stats["failed"] == 0


def test_async_barrier_compat_matches_reference(weights):
    want = _run("ref", weights, "pod_bfio_p2", "agentic", fleet_cls="async",
                barrier_compat=True)
    got = _run("port", weights, "pod_bfio_p2", "agentic", fleet_cls="async",
               barrier_compat=True)
    _assert_equal(got, want)


def test_heterogeneous_fleet_with_predictor_matches_reference(weights):
    """replica_classes and the oracle predictor reach the router."""
    rcfg, rparams, tparams, mesh = weights
    from repro.serving import EngineConfig as RefEngineConfig
    runs = []
    for cls, ec_cls, params, dev in (
            (RefFleetServer, RefEngineConfig, rparams, {"mesh": mesh}),
            (FleetServer, EngineConfig, tparams, {"device": "cpu"})):
        base = ec_cls(**EC)
        classes = [(2, dataclasses.replace(base, n_workers=1,
                                           slots_per_worker=2)),
                   (2, dataclasses.replace(base, n_workers=2,
                                           slots_per_worker=4))]
        tel = (RefFleetTelemetry if cls is RefFleetServer
               else FleetTelemetry)()
        fleet = cls(rcfg if cls is RefFleetServer else CFG, params, base,
                    replica_classes=classes, router="pod_bfio_p2_h1",
                    predictor="oracle", policy="bfio_h0", telemetry=tel,
                    **dev)
        fleet.submit_scenario(_scenario(
            ref_make_scenario if cls is RefFleetServer else make_scenario,
            "flash_crowd"))
        fleet.run()
        runs.append(_outcome(fleet, tel))
    _assert_equal(runs[1], runs[0])


def test_ledger_arithmetic_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, ledger.N_CAUSES + 1))
        split = np.zeros(ledger.N_CAUSES)
        split[:n] = rng.uniform(0, 1, n) * 10.0 ** rng.integers(-12, 12, n)
        total = float(split.sum() * rng.uniform(0.999, 1.001))
        assert ledger.fold_sum(split) == ref_ledger.fold_sum(split)
        got = ledger.reconcile_split(total, split.copy())
        assert got.tobytes() == ref_ledger.reconcile_split(
            total, split.copy()).tobytes()
        assert ledger.fold_sum(got) == total
        slack = rng.uniform(0, 5, 6)
        causes = rng.integers(0, ledger.N_CAUSES, 6)
        assert ledger.attribute_step_idle(
            float(slack.sum()), slack, causes).tobytes() == \
            ref_ledger.attribute_step_idle(
                float(slack.sum()), slack, causes).tobytes()
    assert ledger.IDLE_CAUSES == ref_ledger.IDLE_CAUSES


def test_straggler_ledger_charges_equal():
    rng = np.random.default_rng(1)
    a, b = ledger.StragglerLedger(), ref_ledger.StragglerLedger()
    for _ in range(50):
        split = rng.uniform(0, 3, ledger.N_CAUSES)
        idle = float(split.sum())
        g = int(rng.integers(-1, 4))
        cause = int(rng.integers(0, ledger.N_CAUSES))
        for L in (a, b):
            L.charge(idle, split.copy(), g)
            L.charge_one(0.5 * idle, cause)
    assert a.report() == b.report()
    assert a.format() == b.format()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_equal_seed_for_seed(name):
    kw = dict(n_requests=24, n_replicas=3, n_workers=2, slots_per_worker=4,
              max_seq_len=96, vocab_size=500, seed=5, load_factor=1.3)
    got, want = make_scenario(name, **kw), ref_make_scenario(name, **kw)
    validate_scenario(got, max_seq_len=96, vocab_size=500)
    assert got.meta == want.meta
    assert len(got.requests) == len(want.requests) == 24
    for a, b in zip(got.requests, want.requests):
        assert (a.rid, a.arrival_time, a.max_new_tokens) == \
            (b.rid, b.arrival_time, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _instance_rows(inst):
    return np.array([(r.rid, r.arrival_step, r.prefill, r.decode_len,
                      r.arrival_time) for r in inst.requests])


def test_traces_equal_seed_for_seed():
    for spec_name in ("LONGBENCH_LIKE", "BURSTGPT_LIKE", "UNIFORM_PREFILL",
                      "LONGBENCH_HEAVY"):
        spec, rspec = getattr(data, spec_name), getattr(ref_data, spec_name)
        assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
        assert data.overload_rate(spec, 4, 8) == \
            ref_data.overload_rate(rspec, 4, 8)
        for fn, kw in (("poisson_trace", dict(rate=3.0)),
                       ("bursty_trace", dict(rate=3.0, period=5.0)),
                       ("diurnal_trace", dict(rate=3.0, period=20.0))):
            got = getattr(data, fn)(spec, n_requests=40, seed=7, **kw)
            want = getattr(ref_data.traces, fn)(rspec, n_requests=40,
                                                seed=7, **kw)
            np.testing.assert_array_equal(_instance_rows(got),
                                          _instance_rows(want))
        got = data.batched_rounds_instance(spec, G=3, B=4, n_rounds=3,
                                           seed=2)
        want = ref_data.batched_rounds_instance(rspec, G=3, B=4,
                                                n_rounds=3, seed=2)
        np.testing.assert_array_equal(_instance_rows(got),
                                          _instance_rows(want))
    kw = dict(vocab_size=100, batch=4, seq_len=16, n_batches=2, seed=3)
    for got, want in zip(data.token_batches(**kw),
                         ref_data.token_batches(**kw)):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def test_telemetry_jsonl_crosses_packages(weights, tmp_path):
    """JSONL written by the port reads back in the reference and the
    reverse (each reader re-validates the stored summary)."""
    for side, writer_cls, reader_cls in (
            ("port", FleetTelemetry, RefFleetTelemetry),
            ("ref", RefFleetTelemetry, FleetTelemetry)):
        rcfg, rparams, tparams, mesh = weights
        tel = writer_cls()
        if side == "port":
            fleet = FleetServer(CFG, tparams, EngineConfig(**EC),
                                n_replicas=R, router="bfio",
                                policy="bfio_h0", device="cpu",
                                telemetry=tel)
            fleet.submit_scenario(_scenario(make_scenario, "agentic"))
        else:
            from repro.serving import EngineConfig as RefEngineConfig
            fleet = RefFleetServer(rcfg, rparams, RefEngineConfig(**EC),
                                   n_replicas=R, router="bfio",
                                   policy="bfio_h0", mesh=mesh,
                                   telemetry=tel)
            fleet.submit_scenario(_scenario(ref_make_scenario, "agentic"))
        fleet.run()
        path = tmp_path / f"{side}.jsonl"
        tel.write_jsonl(str(path))
        back = reader_cls.read_jsonl(str(path))
        assert back.steps == tel.steps and back.requests == tel.requests
        assert back.summary() == tel.summary()
