"""Workload model from Section 3 of the paper.

A request i is a workload profile W_i = (w_i^(1), ..., w_i^(o_i)):
``o_i`` processing steps, each contributing workload w_i^(j) >= 0.

The paper's LLM decode specialization (Section 5): w_i^(1) = s_i (prefill
size), and the j-th decode step costs s_i + sum_{t<j} delta_t where
(delta_k) is the common non-decreasing drift sequence (Definition 2):

  * delta_k == 1 : standard KV-cache growth (dense / MoE / VLM / audio)
  * delta_k == 0 : constant per-step workload (SSM state, classical jobs)
  * 0 < delta_k < 1 : compressed / hybrid caches (e.g. Zamba2 shared attn)

Workloads are *unknown to the scheduler* at arrival; the scheduler only
observes current loads and (optionally) a short-lookahead prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "DriftModel",
    "Request",
    "ArrivalInstance",
    "constant_drift",
    "unit_drift",
    "fractional_drift",
    "drift_for_family",
]


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Common per-step workload increment sequence (Definition 2).

    ``delta(k)`` must be in [0, delta_max] for all global steps k >= 1.
    """

    name: str
    delta_max: float
    delta: Callable[[int], float]

    def increment(self, k: int) -> float:
        d = float(self.delta(int(k)))
        if not (0.0 <= d <= self.delta_max + 1e-12):
            raise ValueError(
                f"drift {self.name}: delta({k})={d} outside [0, {self.delta_max}]"
            )
        return d

    def cumulative(self, k_start: int, n: int) -> float:
        """Sum of delta over global steps k_start+1 .. k_start+n."""
        return float(sum(self.increment(k_start + 1 + t) for t in range(int(n))))


def unit_drift() -> DriftModel:
    """delta_k == 1: one token of KV per decode step (paper's main model)."""
    return DriftModel(name="unit", delta_max=1.0, delta=lambda k: 1.0)


def constant_drift() -> DriftModel:
    """delta_k == 0: constant workload (SSM decode, classical scheduling)."""
    return DriftModel(name="constant", delta_max=0.0, delta=lambda k: 0.0)


def fractional_drift(frac: float) -> DriftModel:
    """delta_k == frac in (0,1): only a fraction of layers grow KV (hybrid)."""
    if not (0.0 < frac < 1.0):
        raise ValueError(f"fractional drift must be in (0,1), got {frac}")
    return DriftModel(name=f"fractional[{frac:g}]", delta_max=frac,
                      delta=lambda k: frac)


def scaled_drift(c: float) -> DriftModel:
    """delta_k == c >= 0: speculative decoding accepts ~c tokens per step
    (the paper's delta_k >= 1 case of Definition 2)."""
    if c < 0:
        raise ValueError(f"drift must be >= 0, got {c}")
    return DriftModel(name=f"scaled[{c:g}]", delta_max=c, delta=lambda k: c)


def drift_for_family(family: str) -> DriftModel:
    """Map an architecture family to its workload drift model (DESIGN.md §5)."""
    family = family.lower()
    if family in ("dense", "moe", "vlm", "audio"):
        return unit_drift()
    if family == "ssm":
        return constant_drift()
    if family == "hybrid":
        # Zamba2: ~6 shared-attention applications over 38 blocks grow KV;
        # SSM blocks carry constant state.  Effective drift ~ 6/38.
        return fractional_drift(6.0 / 38.0)
    raise ValueError(f"unknown architecture family: {family!r}")


@dataclasses.dataclass
class Request:
    """One inference request with its (hidden) workload profile."""

    rid: int
    arrival_step: int          # k_i: step at which it enters the waiting pool
    prefill: float             # s_i = w_i^(1)
    decode_len: int            # o_i: total number of processing steps
    arrival_time: float = float("nan")  # wall-clock arrival (trace mode)
    # Mutable scheduling state:
    assign_step: int = -1      # x_i (-1 = unassigned)
    worker: int = -1           # g(i)
    steps_done: int = 0        # number of processing steps completed
    finish_step: int = -1
    # Wall-clock bookkeeping (filled by the simulator):
    t_start: float = float("nan")
    t_finish: float = float("nan")

    @property
    def active(self) -> bool:
        return self.worker >= 0 and self.finish_step < 0

    @property
    def done(self) -> bool:
        return self.finish_step >= 0

    def workload_at(self, k: int, drift: DriftModel) -> float:
        """w_i^(j) for the step j = k - x_i + 1 (k is a global step index).

        Requires the request to be active at step k.
        """
        if self.assign_step < 0 or k < self.assign_step:
            raise ValueError(f"request {self.rid} not active at step {k}")
        j = k - self.assign_step  # 0-based processing-step index
        if j >= self.decode_len:
            raise ValueError(f"request {self.rid} already finished by step {k}")
        return self.prefill + drift.cumulative(self.assign_step, j)

    def profile(self, drift: DriftModel) -> np.ndarray:
        """Full workload profile W_i (assuming assignment at step 0)."""
        out = np.empty(self.decode_len, dtype=np.float64)
        acc = self.prefill
        out[0] = acc
        for j in range(1, self.decode_len):
            acc += drift.increment(j)
            out[j] = acc
        return out

    def total_work(self, drift: DriftModel) -> float:
        """sum_j w_i^(j) — the request's policy-independent contribution."""
        return float(self.profile(drift).sum())


@dataclasses.dataclass
class ArrivalInstance:
    """An arrival instance I: requests with arrival steps (Section 3).

    ``requests`` must be sorted by arrival_step (FCFS pops in this order).
    """

    requests: list[Request]
    drift: DriftModel = dataclasses.field(default_factory=unit_drift)
    name: str = "instance"

    def __post_init__(self) -> None:
        steps = [r.arrival_step for r in self.requests]
        if steps != sorted(steps):
            self.requests = sorted(self.requests, key=lambda r: r.arrival_step)

    def __len__(self) -> int:
        return len(self.requests)

    def arrivals_at(self, k: int) -> Iterator[Request]:
        for r in self.requests:
            if r.arrival_step == k:
                yield r

    def total_work(self) -> float:
        """W(I) of Eq. (11): policy independent."""
        return float(sum(r.total_work(self.drift) for r in self.requests))

    def reset(self) -> None:
        for r in self.requests:
            r.assign_step = -1
            r.worker = -1
            r.steps_done = 0
            r.finish_step = -1
            r.t_start = float("nan")
            r.t_finish = float("nan")


def make_instance(
    *,
    n_requests: int,
    prefill_sampler: Callable[[np.random.Generator, int], np.ndarray],
    decode_sampler: Callable[[np.random.Generator, int], np.ndarray],
    arrival_steps: Optional[Sequence[int]] = None,
    drift: Optional[DriftModel] = None,
    seed: int = 0,
    name: str = "synthetic",
) -> ArrivalInstance:
    """Build an ArrivalInstance from samplers (the reference package builds traces with it)."""
    rng = np.random.default_rng(seed)
    s = np.asarray(prefill_sampler(rng, n_requests), dtype=np.float64)
    o = np.asarray(decode_sampler(rng, n_requests), dtype=np.int64)
    if np.any(s < 0) or np.any(o < 1):
        raise ValueError("prefill must be >=0 and decode_len >= 1")
    if arrival_steps is None:
        arrival_steps = [0] * n_requests
    reqs = [
        Request(rid=i, arrival_step=int(arrival_steps[i]),
                prefill=float(s[i]), decode_len=int(o[i]))
        for i in range(n_requests)
    ]
    return ArrivalInstance(requests=reqs, drift=drift or unit_drift(), name=name)
