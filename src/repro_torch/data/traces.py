"""Arrival-trace generation (Section 6.1).

Requests arrive by a stationary Poisson process whose rate exceeds system
capacity (the overloaded regime of Definition 1), or in bursty episodes
(BurstGPT-style).  Also provides step-indexed adversarial-style instances
used by the theory-validation benchmarks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.workload import ArrivalInstance, DriftModel, Request, unit_drift
from .synthetic import WorkloadSpec, decode_sampler, prefill_sampler

__all__ = [
    "poisson_trace",
    "bursty_trace",
    "diurnal_trace",
    "batched_rounds_instance",
    "overload_rate",
]


def overload_rate(spec: WorkloadSpec, G: int, B: int,
                  t_token: float = 1.005e-7, c_step: float = 9.775e-3,
                  factor: float = 1.5) -> float:
    """Arrival rate (req/s) that exceeds steady-state capacity by ``factor``.

    Steady state: ~G*B slots, mean occupancy time per request ~ E[o] steps of
    duration ~ (c + t_token * B * E[load per slot] * 1) ... we use the crude
    estimate dt ~= c_step + t_token * B * (mu_s + E[o]/2) and service rate
    G*B / (E[o] * dt).
    """
    e_o = 1.0 / spec.decode_p
    mu_s = spec.mu_s
    dt = c_step + t_token * B * (mu_s + 0.5 * e_o)
    service_rate = G * B / (e_o * dt)
    return factor * service_rate


def poisson_trace(
    spec: WorkloadSpec,
    *,
    n_requests: int,
    rate: float,
    drift: Optional[DriftModel] = None,
    seed: int = 0,
) -> ArrivalInstance:
    """Stationary Poisson arrivals at ``rate`` req/s (wall-clock arrival
    times; use SimConfig(time_based_arrivals=True))."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    times = np.cumsum(gaps)
    s = prefill_sampler(spec)(rng, n_requests)
    o = decode_sampler(spec)(rng, n_requests)
    reqs = [
        Request(rid=i, arrival_step=0, prefill=float(s[i]),
                decode_len=int(o[i]), arrival_time=float(times[i]))
        for i in range(n_requests)
    ]
    return ArrivalInstance(requests=reqs, drift=drift or unit_drift(),
                           name=f"{spec.name}-poisson")


def bursty_trace(
    spec: WorkloadSpec,
    *,
    n_requests: int,
    rate: float,
    burst_factor: float = 8.0,
    burst_frac: float = 0.25,
    period: float = 60.0,
    drift: Optional[DriftModel] = None,
    seed: int = 0,
) -> ArrivalInstance:
    """BurstGPT-style: alternating high/low-rate episodes with mean ``rate``."""
    rng = np.random.default_rng(seed)
    hi = rate * burst_factor
    lo = rate * (1.0 - burst_frac * burst_factor) / max(1.0 - burst_frac, 1e-9)
    lo = max(lo, rate * 0.05)
    times = []
    t = 0.0
    while len(times) < n_requests:
        in_burst = (t % period) < burst_frac * period
        r = hi if in_burst else lo
        t += rng.exponential(1.0 / r)
        times.append(t)
    times = np.asarray(times[:n_requests])
    s = prefill_sampler(spec)(rng, n_requests)
    o = decode_sampler(spec)(rng, n_requests)
    reqs = [
        Request(rid=i, arrival_step=0, prefill=float(s[i]),
                decode_len=int(o[i]), arrival_time=float(times[i]))
        for i in range(n_requests)
    ]
    return ArrivalInstance(requests=reqs, drift=drift or unit_drift(),
                           name=f"{spec.name}-bursty")


def diurnal_trace(
    spec: WorkloadSpec,
    *,
    n_requests: int,
    rate: float,
    amplitude: float = 0.8,
    period: float = 240.0,
    drift: Optional[DriftModel] = None,
    seed: int = 0,
) -> ArrivalInstance:
    """Diurnal ramp: nonhomogeneous Poisson with a sinusoidal rate

        lambda(t) = rate * (1 + amplitude * sin(2 pi t / period))

    sampled by thinning against ``lambda_max = rate * (1 + amplitude)``.
    The mean rate over a full period is ``rate``; peaks reach
    ``(1 + amplitude) * rate`` and troughs ``(1 - amplitude) * rate`` —
    the day/night load swing a fleet router must ride without
    re-provisioning."""
    if not (0.0 <= amplitude <= 1.0):
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    rng = np.random.default_rng(seed)
    lam_max = rate * (1.0 + amplitude)
    times = []
    t = 0.0
    while len(times) < n_requests:
        t += rng.exponential(1.0 / lam_max)
        lam = rate * (1.0 + amplitude * np.sin(2.0 * np.pi * t / period))
        if rng.uniform() * lam_max <= lam:
            times.append(t)
    times = np.asarray(times)
    s = prefill_sampler(spec)(rng, n_requests)
    o = decode_sampler(spec)(rng, n_requests)
    reqs = [
        Request(rid=i, arrival_step=0, prefill=float(s[i]),
                decode_len=int(o[i]), arrival_time=float(times[i]))
        for i in range(n_requests)
    ]
    return ArrivalInstance(requests=reqs, drift=drift or unit_drift(),
                           name=f"{spec.name}-diurnal")


def batched_rounds_instance(
    spec: WorkloadSpec,
    *,
    G: int,
    B: int,
    n_rounds: int,
    pool_factor: float = 3.0,
    homogeneous_decode: Optional[int] = None,
    drift: Optional[DriftModel] = None,
    seed: int = 0,
) -> ArrivalInstance:
    """Step-indexed overloaded instance: all requests available from step 0
    with a pool ``pool_factor`` times the total slot capacity times rounds —
    this guarantees Definition 1's overloaded condition along the run.

    ``homogeneous_decode`` forces o_i = o (Theorem 1's warm-up model).
    """
    rng = np.random.default_rng(seed)
    n = int(pool_factor * G * B * n_rounds)
    s = prefill_sampler(spec)(rng, n)
    if homogeneous_decode is not None:
        o = np.full(n, int(homogeneous_decode), dtype=np.int64)
    else:
        o = decode_sampler(spec)(rng, n)
    reqs = [
        Request(rid=i, arrival_step=0, prefill=float(s[i]), decode_len=int(o[i]))
        for i in range(n)
    ]
    return ArrivalInstance(requests=reqs, drift=drift or unit_drift(),
                           name=f"{spec.name}-rounds")
