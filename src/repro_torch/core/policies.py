"""Routing policies: FCFS (Algorithm 2), JSQ, RR, Power-of-d, and BF-IO.

All policies implement ``assign(ctx) -> np.ndarray`` mapping each waiting
candidate index to a worker id (or -1 to keep waiting).  The baselines are
*size-agnostic* (they may observe queue/batch counts but not workloads),
exactly as described in Appendix A.1/B; BF-IO observes current loads,
candidate prefill sizes (known at prefill→decode handoff — the KV cache has
a definite size), and short-lookahead survival predictions for active jobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import io_solver
from .lookahead import Predictor, trajectories
from .workload import DriftModel

__all__ = [
    "SchedulerContext",
    "Policy",
    "FCFSPolicy",
    "JSQPolicy",
    "RoundRobinPolicy",
    "PowerOfDPolicy",
    "BFIOPolicy",
    "make_policy",
]


@dataclasses.dataclass
class SchedulerContext:
    """Observable state handed to a policy at step k.

    When the serving engine runs chunked prefill (vLLM-style interleaving,
    :mod:`repro_torch.serving.scheduler`), admitted requests spend a few steps
    mid-prefill before they start decoding.  Those jobs appear in the
    ``active_*`` arrays with ``active_age == 0`` and their *current*
    workload ``active_w`` equal to the prompt tokens prefilled so far;
    ``active_prefill_remaining`` exposes the outstanding prompt tokens so
    slice-aware policies can anticipate the load each worker is still
    committed to absorb.  Engines without chunking pass zeros (and the
    simulator omits the field entirely), so policies must treat ``None``
    as "no prefill in flight".
    """

    k: int
    loads: np.ndarray            # (G,) pre-admission workloads
    counts: np.ndarray           # (G,) number of active requests
    caps: np.ndarray             # (G,) free slots
    wait_prefill: np.ndarray     # (n,) candidate prefill sizes s_i (arrival order)
    # Active-job details (for lookahead policies):
    active_worker: np.ndarray    # (m,) worker of each active job
    active_w: np.ndarray         # (m,) current per-step workload of each job
    active_age: np.ndarray       # (m,) decode steps already done
    active_remaining: np.ndarray  # (m,) TRUE remaining steps (oracle use only)
    drift: DriftModel
    rng: np.random.Generator
    # (m,) prompt tokens of each active job not yet prefilled (0 = job is
    # decoding).  None when the runtime has no chunked prefill.
    active_prefill_remaining: Optional[np.ndarray] = None

    @property
    def G(self) -> int:
        return int(self.loads.shape[0])

    @property
    def n_wait(self) -> int:
        return int(self.wait_prefill.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.caps.sum())

    @property
    def n_admit(self) -> int:
        """U(k) = min(|R_wait|, sum_g cap[g]) — full-utilization constraint."""
        return min(self.n_wait, self.n_slots)


class Policy:
    name = "base"

    def reset(self) -> None:  # pragma: no cover - stateless default
        pass

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        raise NotImplementedError


class FCFSPolicy(Policy):
    """Appendix B, Algorithm 2: pop the oldest waiting request, place it on
    the worker with the most free slots (ties: lowest index)."""

    name = "fcfs"

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        out = np.full(ctx.n_wait, -1, dtype=np.int64)
        caps = ctx.caps.copy()
        for i in range(ctx.n_admit):
            g = int(np.argmax(caps))
            if caps[g] <= 0:
                break
            out[i] = g
            caps[g] -= 1
        return out


class JSQPolicy(Policy):
    """Join-Shortest-Queue on request *counts* (the vLLM/SGLang-style proxy:
    queue length, not workload — Appendix A.1.1)."""

    name = "jsq"

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        out = np.full(ctx.n_wait, -1, dtype=np.int64)
        caps = ctx.caps.copy()
        counts = ctx.counts.astype(np.int64).copy()
        for i in range(ctx.n_admit):
            masked = np.where(caps > 0, counts, np.iinfo(np.int64).max)
            g = int(np.argmin(masked))
            if caps[g] <= 0:
                break
            out[i] = g
            caps[g] -= 1
            counts[g] += 1
        return out


class RoundRobinPolicy(Policy):
    """Cyclic dispatch irrespective of size/load (Appendix A.1.1)."""

    name = "rr"

    def __init__(self) -> None:
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        out = np.full(ctx.n_wait, -1, dtype=np.int64)
        caps = ctx.caps.copy()
        G = ctx.G
        for i in range(ctx.n_admit):
            placed = False
            for _ in range(G):
                g = self._next % G
                self._next += 1
                if caps[g] > 0:
                    out[i] = g
                    caps[g] -= 1
                    placed = True
                    break
            if not placed:
                break
        return out


class PowerOfDPolicy(Policy):
    """Sample d workers, route to the least-count one among them."""

    name = "pod"

    def __init__(self, d: int = 2) -> None:
        self.d = int(d)
        self.name = f"pod{d}"

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        out = np.full(ctx.n_wait, -1, dtype=np.int64)
        caps = ctx.caps.copy()
        counts = ctx.counts.astype(np.int64).copy()
        G = ctx.G
        for i in range(ctx.n_admit):
            avail = np.nonzero(caps > 0)[0]
            if len(avail) == 0:
                break
            d = min(self.d, len(avail))
            sample = ctx.rng.choice(avail, size=d, replace=False)
            g = int(sample[np.argmin(counts[sample])])
            out[i] = g
            caps[g] -= 1
            counts[g] += 1
        return out


class BFIOPolicy(Policy):
    """Balance-Future with Integer Optimization (Algorithm 1).

    Parameters
    ----------
    H:
        lookahead window length (H=0 is the prediction-free myopic case
        analyzed in Theorems 1–3).
    predictor:
        survival predictor for *active* jobs (OraclePredictor /
        GeometricPredictor / NoisyOraclePredictor).
    p_new:
        geometric prior parameter for *new* candidates' survival within the
        window (their decode lengths are unknown at admission). ``None``
        treats candidates as surviving the whole window (conservative).
    candidate_window:
        the router considers the first ``candidate_window * U`` waiting
        requests (arrival order) as the selectable pool — bounded staleness,
        bounded solve cost.
    """

    def __init__(
        self,
        H: int = 0,
        predictor: Optional[Predictor] = None,
        p_new: Optional[float] = None,
        candidate_window: int = 4,
        min_pool: int = 128,
        refine: bool = True,
    ) -> None:
        self.H = int(H)
        # Default lookahead signal: clairvoyant *within the window* (the
        # paper's short-horizon finish signals).  NB: a non-discriminative
        # predictor (e.g. GeometricPredictor: identical survival for all
        # jobs) makes H>0 behave like H=0 — lookahead only helps when it
        # can tell imminent finishers apart.
        from .lookahead import OraclePredictor
        self.predictor = predictor or OraclePredictor()
        self.p_new = p_new
        self.candidate_window = int(candidate_window)
        self.min_pool = int(min_pool)
        self.refine = refine
        self.name = f"bfio_h{H}"

    def _candidate_traj(self, ctx: SchedulerContext, pool: np.ndarray) -> np.ndarray:
        H = self.H
        s = ctx.wait_prefill[pool]
        n = len(pool)
        growth = np.zeros(H + 1)
        for h in range(1, H + 1):
            growth[h] = growth[h - 1] + ctx.drift.increment(ctx.k + h)
        traj = s[:, None] + growth[None, :]
        if self.p_new is not None and H > 0:
            surv = (1.0 - self.p_new) ** np.arange(H + 1, dtype=np.float64)
            traj = traj * surv[None, :]
        return traj.astype(np.float64)

    def _base_traj(self, ctx: SchedulerContext) -> np.ndarray:
        """Predicted per-worker trajectories of resident jobs over the window."""
        H = self.H
        G = ctx.G
        base = np.zeros((G, H + 1), dtype=np.float64)
        m = len(ctx.active_w)
        if m == 0:
            return base
        if H == 0:
            np.add.at(base[:, 0], ctx.active_worker, ctx.active_w)
            return base
        traj = trajectories(
            ctx.active_w, ctx.active_remaining, ctx.active_age,
            drift=ctx.drift, k=ctx.k, H=H, predictor=self.predictor,
            rng=ctx.rng,
        )  # (m, H+1)
        np.add.at(base, ctx.active_worker, traj)
        return base

    def assign(self, ctx: SchedulerContext) -> np.ndarray:
        out = np.full(ctx.n_wait, -1, dtype=np.int64)
        U = ctx.n_admit
        if U == 0:
            return out
        pool_size = min(ctx.n_wait,
                        max(U, self.candidate_window * U, self.min_pool))
        pool = np.arange(pool_size)
        base = self._base_traj(ctx)
        cands = self._candidate_traj(ctx, pool)
        a = io_solver.solve_io(base, ctx.caps, cands, n_admit=U,
                               refine=self.refine,
                               max_iters=min(64, 4 * U + 8))
        out[pool] = a
        return out


def make_policy(name: str, **kw) -> Policy:
    name = name.lower()
    if name == "fcfs":
        return FCFSPolicy()
    if name == "jsq":
        return JSQPolicy()
    if name in ("rr", "round_robin"):
        return RoundRobinPolicy()
    if name.startswith("pod"):
        d = int(name[3:]) if len(name) > 3 else kw.pop("d", 2)
        return PowerOfDPolicy(d=d)
    if name.startswith("bfio"):
        if "_h" in name:
            kw.setdefault("H", int(name.split("_h")[1]))
        return BFIOPolicy(**kw)
    raise ValueError(f"unknown policy {name!r}")
