"""Fleet scenario trace suite: named, seed-reproducible request streams.

Each scenario turns an arrival-process generator from
:mod:`repro_torch.data.traces` (stationary Poisson, BurstGPT-style bursts, the
diurnal sinusoidal ramp) plus a :class:`~repro_torch.data.synthetic.
WorkloadSpec` length model into a concrete stream of
:class:`FleetRequest`\\ s — wall-clock arrival times, materialized prompt
token ids, and decode budgets — sized to a given fleet shape
(R replicas x G workers x B slots).  The scenarios cover the load
shapes a fleet router must ride:

* ``steady`` — stationary Poisson at ~1.3x capacity (Definition 1's
  overloaded regime): the baseline routing setting.
* ``flash_crowd`` — alternating calm / 6x-rate burst episodes: the
  regime where a burst must be *spread*, not dumped on whoever looked
  idle when it began.
* ``diurnal`` — sinusoidal day/night rate swing: sustained ramps up and
  down rather than shocks.
* ``agentic`` — shared-system-prefix prompts with longer decodes
  (multi-turn agent swarms): near-identical prefill sizes, so
  count-based and load-based routing genuinely differ, and the stream
  exercises prefix caching when the paged backend is on.
* ``long_doc`` — document-scale prompts with short summaries: maximal
  prefill dispersion, the size-aware router's best case.
* ``trickle`` — sparse arrivals (at most ~one request in flight
  fleet-wide) with short prompts and long decode budgets: the large-R
  probe regime (background scoring / agent traffic spread over
  hundreds of mostly-idle replicas), where per-step fleet bookkeeping
  — not model compute — dominates wall clock.
* ``multi_turn`` — staggered agentic sessions: each session reuses a
  per-session shared context across several turns, and turn t+1
  arrives only *after* turn t's estimated finish.  Every turn's
  context blocks are refcount-0 when the next turn lands, so an
  admission-scoped prefix cache measures ~0% hits here — the workload
  the persistent LRU evictor (and ``bfio_affinity`` routing) is
  built for.

Every generator is a pure function of its arguments (seed included), so
scenarios are bit-reproducible across runs and machines, and equal the
reference package's seed for seed (``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..data.synthetic import WorkloadSpec
from ..data.traces import bursty_trace, diurnal_trace, poisson_trace
from ..serving import ServeRequest

__all__ = ["FleetRequest", "Scenario", "SCENARIOS", "make_scenario",
           "validate_scenario"]


@dataclasses.dataclass
class FleetRequest:
    """One materialized request of a scenario trace."""

    rid: int
    arrival_time: float          # seconds on the fleet clock
    tokens: np.ndarray           # prompt token ids, int32
    max_new_tokens: int

    def to_serve_request(self) -> ServeRequest:
        return ServeRequest(rid=self.rid, tokens=self.tokens.copy(),
                            max_new_tokens=self.max_new_tokens)


@dataclasses.dataclass
class Scenario:
    """A named request stream plus the knobs that produced it."""

    name: str
    requests: list[FleetRequest]
    meta: dict

    @property
    def n_requests(self) -> int:
        return len(self.requests)


def _fleet_rate(spec: WorkloadSpec, R: int, G: int, B: int, *,
                factor: float, step_overhead: float,
                t_token: float) -> float:
    """Arrival rate at ``factor`` x the fleet's crude service capacity
    (the single-engine estimate of traces.overload_rate, times R)."""
    e_o = 1.0 / spec.decode_p
    dt = step_overhead + t_token * B * (spec.mu_s + 0.5 * e_o)
    return factor * R * G * B / (e_o * dt)


def _materialize(name: str, inst, *, vocab_size: int, max_prompt: int,
                 max_new: int, seed: int, meta: dict) -> Scenario:
    """Turn an ArrivalInstance (arrival times + prefill/decode lengths)
    into concrete token streams.  Token ids come from a dedicated rng so
    prompt *content* is independent of the arrival-process draws."""
    rng = np.random.default_rng(seed + 0x5EED)
    out = []
    for r in inst.requests:
        L = int(np.clip(r.prefill, 1, max_prompt))
        out.append(FleetRequest(
            rid=r.rid, arrival_time=float(r.arrival_time),
            tokens=rng.integers(1, vocab_size, size=L).astype(np.int32),
            max_new_tokens=int(np.clip(r.decode_len, 1, max_new))))
    return Scenario(name=name, requests=out, meta=meta)


def _spec(name: str, mean: float, sigma: float, s_min: int, s_max: int,
          decode_p: float, o_max: int) -> WorkloadSpec:
    return WorkloadSpec(name=name, prefill_log_mean=float(np.log(mean)),
                        prefill_log_sigma=sigma, s_min=s_min, s_max=s_max,
                        decode_p=decode_p, o_max=o_max)


def _steady(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    spec = _spec("fleet-steady", mean=max_seq / 4, sigma=0.8, s_min=2,
                 s_max=max_seq - 1, decode_p=1 / 8, o_max=24)
    rate = _fleet_rate(spec, R, G, B, factor=1.3 * factor,
                       step_overhead=c, t_token=tt)
    inst = poisson_trace(spec, n_requests=n, rate=rate, seed=seed)
    return _materialize("steady", inst, vocab_size=vocab,
                        max_prompt=max_seq - 1, max_new=24, seed=seed,
                        meta={"rate": rate, "spec": spec.name})


def _flash_crowd(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    spec = _spec("fleet-flash", mean=max_seq / 4, sigma=1.0, s_min=2,
                 s_max=max_seq - 1, decode_p=1 / 8, o_max=24)
    rate = _fleet_rate(spec, R, G, B, factor=1.1 * factor,
                       step_overhead=c, t_token=tt)
    period = max(n / rate / 3.0, 1e-3)   # ~3 burst cycles over the trace
    inst = bursty_trace(spec, n_requests=n, rate=rate, burst_factor=4.0,
                        burst_frac=0.25, period=period, seed=seed)
    return _materialize("flash_crowd", inst, vocab_size=vocab,
                        max_prompt=max_seq - 1, max_new=24, seed=seed,
                        meta={"rate": rate, "period": period,
                              "spec": spec.name})


def _diurnal(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    spec = _spec("fleet-diurnal", mean=max_seq / 4, sigma=0.9, s_min=2,
                 s_max=max_seq - 1, decode_p=1 / 8, o_max=24)
    rate = _fleet_rate(spec, R, G, B, factor=1.2 * factor,
                       step_overhead=c, t_token=tt)
    period = max(n / rate / 2.0, 1e-3)   # ~2 day/night cycles
    inst = diurnal_trace(spec, n_requests=n, rate=rate, amplitude=0.8,
                         period=period, seed=seed)
    return _materialize("diurnal", inst, vocab_size=vocab,
                        max_prompt=max_seq - 1, max_new=24, seed=seed,
                        meta={"rate": rate, "period": period,
                              "spec": spec.name})


def _agentic(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    """Shared system prefix + short per-agent suffix, longer decodes."""
    spec = _spec("fleet-agentic", mean=max(max_seq / 8, 2), sigma=0.4,
                 s_min=2, s_max=max(max_seq // 4, 2), decode_p=1 / 16,
                 o_max=32)
    rate = _fleet_rate(spec, R, G, B, factor=1.3 * factor,
                       step_overhead=c, t_token=tt)
    inst = poisson_trace(spec, n_requests=n, rate=rate, seed=seed)
    rng = np.random.default_rng(seed + 0xA6E)
    prefix_len = max(max_seq // 2, 1)
    prefix = rng.integers(1, vocab, size=prefix_len).astype(np.int32)
    out = []
    for r in inst.requests:
        sfx = int(np.clip(r.prefill, 1, max(max_seq - 1 - prefix_len, 1)))
        toks = np.concatenate(
            [prefix, rng.integers(1, vocab, size=sfx).astype(np.int32)])
        out.append(FleetRequest(
            rid=r.rid, arrival_time=float(r.arrival_time), tokens=toks,
            max_new_tokens=int(np.clip(r.decode_len, 1, 32))))
    return Scenario(name="agentic", requests=out,
                    meta={"rate": rate, "shared_prefix_len": prefix_len,
                          "spec": spec.name})


def _long_doc(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    """Document-scale prompts, short outputs: maximal prefill dispersion
    relative to the cache (uniform over the upper half of max_seq)."""
    spec = _spec("fleet-longdoc", mean=max_seq * 0.6, sigma=0.5,
                 s_min=max(max_seq // 3, 2), s_max=max_seq - 1,
                 decode_p=1 / 4, o_max=12)
    rate = _fleet_rate(spec, R, G, B, factor=0.9 * factor,
                       step_overhead=c, t_token=tt)
    inst = poisson_trace(spec, n_requests=n, rate=rate, seed=seed)
    return _materialize("long_doc", inst, vocab_size=vocab,
                        max_prompt=max_seq - 1, max_new=12, seed=seed,
                        meta={"rate": rate, "spec": spec.name})


def _trickle(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    """Sparse single-file arrivals, short prompts, long decode budgets:
    at any instant only a handful of replicas are busy regardless of R,
    so fleet-layer per-step cost is laid bare (the ``fleet_scale``
    regime)."""
    s_max = max(max_seq // 6, 2)
    o_max = max(max_seq - s_max - 1, 1)
    spec = _spec("fleet-trickle", mean=max(max_seq / 12, 2), sigma=0.6,
                 s_min=2, s_max=s_max, decode_p=1 / 24, o_max=o_max)
    # Unlike every other scenario the rate does NOT scale with the
    # fleet shape: a trickle keeps at most ~one request in flight
    # fleet-wide, so adding replicas only adds idle bookkeeping.
    e_o = 1.0 / spec.decode_p
    dt = c + tt * B * (spec.mu_s + 0.5 * e_o)
    rate = factor * 0.8 / (e_o * dt)
    inst = poisson_trace(spec, n_requests=n, rate=rate, seed=seed)
    return _materialize("trickle", inst, vocab_size=vocab,
                        max_prompt=s_max, max_new=o_max, seed=seed,
                        meta={"rate": rate, "spec": spec.name})


def _multi_turn(n, R, G, B, max_seq, vocab, seed, factor, c, tt) -> Scenario:
    """Staggered multi-turn agentic sessions: every turn of a session
    shares the session's context tokens, and turn t+1 arrives after
    turn t's *estimated finish* (service-time model plus slack) — so
    when the next turn lands, the previous turn has drained and its
    context blocks sit at refcount 0.  An admission-scoped prefix cache
    gets ~0% hits on this stream; a persistent LRU evictor turns every
    later turn into a context-length hit, and per-session contexts
    differ so affinity routing can tell *which* replica holds them."""
    turns = 3
    sessions = max(-(-n // turns), 1)
    rng = np.random.default_rng(seed + 0x717)
    ctx_len = max(max_seq // 2, 1)
    sfx_max = max(max_seq - 1 - ctx_len, 2)
    spec = _spec("fleet-multiturn", mean=max(max_seq / 8, 2), sigma=0.4,
                 s_min=2, s_max=sfx_max, decode_p=1 / 8, o_max=16)
    e_o = 1.0 / spec.decode_p
    dt = c + tt * B * (spec.mu_s + 0.5 * e_o)
    # session starts: Poisson, rate sized so ~R sessions run at once
    rate = factor * R * G * B / (e_o * dt) / turns
    starts = np.cumsum(rng.exponential(1.0 / rate, size=sessions))
    turn_gap = 2.0 * e_o * dt
    out: list[FleetRequest] = []
    rid = 0
    for s in range(sessions):
        ctxt = rng.integers(1, vocab, size=ctx_len).astype(np.int32)
        t_arr = float(starts[s])
        for _ in range(turns):
            if rid >= n:
                break
            sfx = int(rng.integers(1, sfx_max + 1))
            dec = int(rng.integers(1, spec.o_max + 1))
            out.append(FleetRequest(
                rid=rid, arrival_time=t_arr,
                tokens=np.concatenate(
                    [ctxt,
                     rng.integers(1, vocab, size=sfx).astype(np.int32)]),
                max_new_tokens=dec))
            rid += 1
            # next turn lands after this one's estimated finish
            t_arr += (ctx_len + sfx + dec) * dt + turn_gap
    out.sort(key=lambda r: r.arrival_time)    # global arrival order
    return Scenario(name="multi_turn", requests=out,
                    meta={"sessions": sessions, "turns": turns,
                          "shared_ctx_len": ctx_len, "rate": rate,
                          "turn_gap": turn_gap, "spec": spec.name})


SCENARIOS = {
    "steady": _steady,
    "flash_crowd": _flash_crowd,
    "diurnal": _diurnal,
    "agentic": _agentic,
    "long_doc": _long_doc,
    "trickle": _trickle,
    "multi_turn": _multi_turn,
}


def make_scenario(name: str, *, n_requests: int, n_replicas: int,
                  n_workers: int, slots_per_worker: int,
                  max_seq_len: int = 64, vocab_size: int = 128,
                  seed: int = 0, load_factor: float = 1.0,
                  step_overhead: float = 9.775e-3,
                  t_token: float = 1.005e-7) -> Scenario:
    """Build a named scenario sized to a fleet shape.  ``load_factor``
    scales every scenario's arrival rate around its calibrated
    overload point."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (have {sorted(SCENARIOS)})")
    sc = builder(n_requests, n_replicas, n_workers, slots_per_worker,
                 max_seq_len, vocab_size, seed, load_factor,
                 step_overhead, t_token)
    sc.meta.update(n_requests=n_requests, n_replicas=n_replicas,
                   n_workers=n_workers, slots_per_worker=slots_per_worker,
                   max_seq_len=max_seq_len, vocab_size=vocab_size,
                   seed=seed, load_factor=load_factor)
    return sc


def validate_scenario(sc: Scenario, *, max_seq_len: int,
                      vocab_size: int) -> None:
    """Schema check: raise AssertionError on any malformed stream."""
    assert sc.name in SCENARIOS, sc.name
    assert sc.requests, "empty scenario"
    rids = [r.rid for r in sc.requests]
    assert len(set(rids)) == len(rids), "duplicate rids"
    prev = 0.0
    for r in sc.requests:
        assert r.arrival_time >= prev >= 0.0, "arrivals not sorted"
        prev = r.arrival_time
        assert r.tokens.dtype == np.int32
        assert 1 <= len(r.tokens) <= max_seq_len, len(r.tokens)
        assert (r.tokens >= 1).all() and (r.tokens < vocab_size).all()
        assert r.max_new_tokens >= 1
