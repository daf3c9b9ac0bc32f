"""Fleet-tier routing: which *replica* serves a request.

The paper's balancing principle is scale-free: the same decision problem
that places a request on a decode worker inside one engine reappears one
tier up when heavy traffic is spread across R independent engine
replicas.  :class:`FleetRouter` is that tier's seam — it sees only
fleet-level observables (per-replica committed load/count/capacity and
the waiting candidates' prefill sizes) and maps every waiting request to
a replica.  The replica's own admission scheduler
(:mod:`repro_torch.serving.scheduler` + a :class:`~repro_torch.core.policies.Policy`)
then picks the worker slot, so with the BF-IO router *and* a BF-IO
engine policy the principle acts at both levels.

Routing is **total**: every candidate is placed every step (replicas
queue internally; the fleet never holds requests back).  That is what
makes ``fleet(R=1, router=*)`` bit-identical to a bare
:class:`~repro_torch.serving.engine.ServingEngine` on the same stream — the
single replica receives the identical submission sequence — and it
matches how real fleet LBs work: forward on arrival, queue at the
replica.  Load-aware routers therefore balance *committed* load
(resident work plus queued prefill), not just resident work.

Routers mirror the engine-policy taxonomy (Appendix A.1):

* ``round_robin`` — cyclic, size- and load-agnostic;
* ``least_loaded`` — sequential argmin of committed load, counting each
  placement's prefill size (size-aware JSQ analogue);
* ``pod2`` — power-of-d choices on committed request counts;
* ``bfio`` — the paper's Algorithm 1 at fleet scope: one batched
  windowed-imbalance solve over all waiting candidates via the existing
  :func:`~repro_torch.core.balancer_jax.bfio_assign_batch` (a leading cluster
  axis of 1 here; multi-cluster fleets batch many routing solves into
  the same call), on the fleet's device — on a card its swap search is
  the hand-written kernel, which takes the cluster axis in its grid;
* ``pod_bfio`` — two-level hierarchical BF-IO for R in the hundreds:
  level 1 spreads candidates over P pods of replicas
  (capacity-normalized least-loaded, so heterogeneous pods fill
  proportionally), level 2 runs ONE ``bfio_assign_batch`` call whose
  cluster axis is the pods.  Solve cost scales with the pod size, not
  R.

Load-aware routers optionally fold in a predicted output length per
candidate (``RouterContext.pred_out`` x ``pred_weight``) — the
predictive-scheduling signal — and see per-replica slot capacity for
heterogeneous fleets (``RouterContext.capacity``).

``bfio_affinity`` (and ``pod_bfio_*_affinity``) additionally folds
prefix-cache locality into the same objective: the fleet surfaces
per-(replica, candidate) predicted hit tokens through
``RouterContext.affinity`` (the prompt head hashed against each
replica's live :class:`~repro_torch.serving.paged_cache.PrefixIndex`), and a
post-solve refinement discounts a candidate's effective size on a
replica by ``affinity_weight * predicted_hit_tokens`` — cache hits skip
prefill compute, so the discounted size is the *true* work the
placement adds there.  Locality and load balance trade inside one
windowed-imbalance objective instead of a sticky-session override; at
``affinity_weight=0`` the refinement is skipped entirely and the router
is bit-identical to plain ``bfio``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.balancer_jax import bfio_assign_batch
from ..core.workload import DriftModel, unit_drift

__all__ = [
    "RouterContext",
    "FleetRouter",
    "RoundRobinRouter",
    "LeastLoadedRouter",
    "PowerOfDRouter",
    "BFIORouter",
    "PodBFIORouter",
    "make_router",
]


@dataclasses.dataclass
class RouterContext:
    """Fleet-level observables at barrier step k.

    ``loads``/``counts`` are *committed* quantities: resident work on the
    replica's workers plus the prefill work already queued at (but not
    yet admitted by) the replica — the router's placements from earlier
    steps must count against a replica even before its scheduler admits
    them, or a burst would pile onto whichever replica looked idle when
    it began."""

    k: int
    loads: np.ndarray        # (R,) committed load per replica
    counts: np.ndarray       # (R,) committed request count per replica
    free_slots: np.ndarray   # (R,) currently free engine slots
    wait_sizes: np.ndarray   # (n,) candidate prefill sizes, arrival order
    drift: DriftModel = dataclasses.field(default_factory=unit_drift)
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0))
    # (R,) total engine slots per replica — equal for homogeneous fleets,
    # the normalizer for capacity-aware (hierarchical) routing when
    # replica classes differ.  None means "assume homogeneous".
    capacity: Optional[np.ndarray] = None
    # (n,) predicted output length per candidate (arrival order), or None
    # when the fleet has no predictor.  Routers that opt in (pred_weight
    # > 0) add it to each candidate's placement size.
    pred_out: Optional[np.ndarray] = None
    # (R,) seconds since each routable replica's load view was last
    # refreshed.  The barrier fleet routes against just-gathered
    # snapshots (None == implicitly fresh); the async fleet refreshes
    # on step completion, so its router sees bounded-stale loads and
    # this field says how stale.  Routers may discount accordingly.
    snapshot_age: Optional[np.ndarray] = None
    # (R, n) predicted prefix-cache hit tokens: entry [r, i] is how many
    # leading prompt tokens of candidate i are live (referenced or
    # LRU-cached) in replica r's PrefixIndex right now.  None when the
    # fleet has no prefix caches or the router did not ask
    # (affinity_weight == 0 — the probe is not free, so the server only
    # computes it for routers that opt in).
    affinity: Optional[np.ndarray] = None
    # where the BF-IO routers run their batched solve: the fleet's device
    # (``FleetServer(device=...)``), so on a card the solve's swap search
    # runs the Hopper kernel.  Only the returned assignment comes back.
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))

    @property
    def R(self) -> int:
        return int(self.loads.shape[0])

    @property
    def n_wait(self) -> int:
        return int(self.wait_sizes.shape[0])


class FleetRouter:
    """Maps every waiting request to a replica (total assignment)."""

    name = "base"

    def reset(self) -> None:  # pragma: no cover - stateless default
        pass

    def route(self, ctx: RouterContext) -> np.ndarray:
        """(n_wait,) replica id per candidate — every entry in
        [0, R)."""
        raise NotImplementedError


class RoundRobinRouter(FleetRouter):
    """Cyclic dispatch, irrespective of size and load."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def route(self, ctx: RouterContext) -> np.ndarray:
        out = np.empty(ctx.n_wait, dtype=np.int64)
        for i in range(ctx.n_wait):
            out[i] = self._next % ctx.R
            self._next += 1
        return out


class LeastLoadedRouter(FleetRouter):
    """Sequential argmin of committed load; each placement adds its
    prefill size to the running estimate (ties: lowest index)."""

    name = "least_loaded"

    def route(self, ctx: RouterContext) -> np.ndarray:
        out = np.empty(ctx.n_wait, dtype=np.int64)
        loads = ctx.loads.astype(np.float64).copy()
        for i in range(ctx.n_wait):
            g = int(np.argmin(loads))
            out[i] = g
            loads[g] += float(ctx.wait_sizes[i])
        return out


class PowerOfDRouter(FleetRouter):
    """Sample d replicas, route to the least-committed-count one —
    size-agnostic like the engine-tier PowerOfDPolicy."""

    name = "pod"

    def __init__(self, d: int = 2) -> None:
        self.d = int(d)
        self.name = f"pod{d}"

    def route(self, ctx: RouterContext) -> np.ndarray:
        out = np.empty(ctx.n_wait, dtype=np.int64)
        counts = ctx.counts.astype(np.int64).copy()
        for i in range(ctx.n_wait):
            d = min(self.d, ctx.R)
            sample = ctx.rng.choice(ctx.R, size=d, replace=False)
            g = int(sample[np.argmin(counts[sample])])
            out[i] = g
            counts[g] += 1
        return out


def _on(x: np.ndarray, device, dtype) -> torch.Tensor:
    """A routing input as a tensor on the solve's device (float64 values
    round to float32 to nearest, as the reference's cast does)."""
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def _pad_bucket(n: int, lo: int = 8) -> int:
    """Next power-of-two bucket >= n: the reference's bucket (there it
    bounds jit recompiles), kept so the solve sees the same padded
    instance and returns the same assignment."""
    b = lo
    while b < n:
        b *= 2
    return b


class BFIORouter(FleetRouter):
    """BF-IO at fleet scope (Algorithm 1, replicas as the machines).

    One batched solve per routing step: base trajectories are each
    replica's committed load grown by ``counts * drift`` over the
    window, candidates contribute their prefill size plus drift, and
    :func:`~repro_torch.core.balancer_jax.bfio_assign_batch` (cluster axis 1)
    returns the windowed-imbalance-minimizing total assignment.  Caps
    are set to the candidate count — the fleet tier is total, capacity
    is the replica scheduler's concern.

    ``pred_weight`` > 0 folds ``pred_weight * ctx.pred_out`` into each
    candidate's size: a request predicted to decode long is placed as if
    it were that much heavier now.  The default 0.0 is an exact no-op.

    ``affinity_weight`` > 0 (``router="bfio_affinity"``) adds the
    prefix-locality term: after the batched solve, a bounded greedy
    refinement moves single candidates whenever the move lowers the
    affinity-discounted windowed-max objective
    ``J = sum_h max_r traj[r, h]``, where candidate i contributes
    ``max(size_i - affinity_weight * affinity[r, i], 1) + growth`` on
    replica r.  ``affinity_weight=1`` is the physical discount — a
    predicted hit token is a prompt token whose prefill compute the
    replica skips.  At 0.0 (or ``ctx.affinity is None``) the refinement
    is skipped entirely: bit-identical to plain ``bfio``.
    """

    def __init__(self, H: int = 0, swap_iters: int = 8,
                 pred_weight: float = 0.0,
                 affinity_weight: float = 0.0) -> None:
        self.H = int(H)
        self.swap_iters = int(swap_iters)
        self.pred_weight = float(pred_weight)
        self.affinity_weight = float(affinity_weight)
        self.name = f"bfio_h{H}" if H else "bfio"
        if self.affinity_weight != 0.0:
            self.name += "_affinity"

    def _growth(self, ctx: RouterContext) -> np.ndarray:
        g = np.zeros(self.H + 1)
        for h in range(1, self.H + 1):
            g[h] = g[h - 1] + ctx.drift.increment(ctx.k + h)
        return g

    def _sizes(self, ctx: RouterContext) -> np.ndarray:
        """(n,) effective candidate sizes: prefill size plus (optionally)
        the weighted predicted output length."""
        sizes = ctx.wait_sizes.astype(np.float64)
        if self.pred_weight != 0.0 and ctx.pred_out is not None:
            sizes = sizes + self.pred_weight * np.asarray(
                ctx.pred_out, dtype=np.float64)
        return sizes

    def _affinity_refine(self, ctx: RouterContext,
                         out: np.ndarray) -> np.ndarray:
        """Greedy single-candidate move descent on the affinity-
        discounted lexicographic objective (see class docstring):
        primary ``J1 = sum_h max_r traj[r, h]`` (the solver's windowed
        peak, with candidate contributions affinity-discounted),
        secondary ``J2 = sum_i eff[out[i], i]`` (total effective
        prefill work — the compute that predicted hits save).  A move
        is taken when it lowers J1, or keeps J1 and lowers J2 — so
        cache-locality moves off the peak replica are *free* (J1
        untouched, J2 drops by the discount) while balance stays the
        binding constraint: the peak never degrades.

        Each pass evaluates every (candidate, target replica) move via
        a top-2 column-max trick (O(n * R * W) per pass) and applies
        the lexicographically best strictly-improving one; at most
        ``2n`` passes.  Exact no-op when ``affinity_weight == 0`` or
        the fleet supplied no affinity matrix.
        """
        lam = self.affinity_weight
        if lam == 0.0 or ctx.affinity is None:
            return out
        n, R = ctx.n_wait, ctx.R
        if n == 0 or R < 2:
            return out
        growth = self._growth(ctx)                         # (W,)
        aff = np.asarray(ctx.affinity, dtype=np.float64)   # (R, n)
        # effective contribution of candidate i on replica r: prefill
        # size with predicted-hit tokens discounted (hits skip chunk
        # compute), floored at one token so no placement looks free
        eff = np.maximum(self._sizes(ctx)[None, :] - lam * aff,
                         1.0)                              # (R, n)
        traj = (ctx.loads[:, None].astype(np.float64)
                + ctx.counts[:, None] * growth[None, :])   # (R, W)
        out = out.copy()
        for i in range(n):
            traj[out[i]] += eff[out[i], i] + growth
        rows = np.arange(R)
        for _ in range(2 * n):
            J1 = traj.max(axis=0).sum()
            J2 = float(sum(eff[out[i], i] for i in range(n)))
            eps = 1e-9 * (1.0 + abs(J1))   # fp slack, relative scale
            best = (J1 - eps, J2 - eps, None)
            for i in range(n):
                src = int(out[i])
                t = traj.copy()
                t[src] -= eff[src, i] + growth             # i removed
                am = t.argmax(axis=0)                      # (W,)
                m1 = t[am, np.arange(t.shape[1])]
                t[am, np.arange(t.shape[1])] = -np.inf
                m2 = t.max(axis=0)                         # second max
                t[am, np.arange(t.shape[1])] = m1
                # per-column max over the *other* rows when row r takes i
                other = np.where(am[None, :] == rows[:, None],
                                 m2[None, :], m1[None, :])  # (R, W)
                add = eff[:, i][:, None] + growth[None, :]  # (R, W)
                newJ1 = np.maximum(other, t + add).sum(axis=1)
                newJ1[src] = np.inf
                newJ2 = J2 - eff[src, i] + eff[:, i]        # (R,)
                r = int(np.lexsort((newJ2, newJ1))[0])
                nj1, nj2 = float(newJ1[r]), float(newJ2[r])
                b1, b2, _ = best
                if nj1 < b1 - eps or (nj1 <= b1 + eps and nj2 < b2):
                    best = (nj1, nj2, (i, src, r))
            if best[2] is None:
                break
            i, src, r = best[2]
            traj[src] -= eff[src, i] + growth
            traj[r] += eff[r, i] + growth
            out[i] = r
        return out

    def route(self, ctx: RouterContext) -> np.ndarray:
        n, R = ctx.n_wait, ctx.R
        growth = self._growth(ctx)                       # (W,)
        base = (ctx.loads[:, None]
                + ctx.counts[:, None] * growth[None, :])  # (R, W)
        npad = _pad_bucket(n)
        cands = np.zeros((npad, self.H + 1))
        cands[:n] = self._sizes(ctx)[:, None] + growth[None, :]
        valid = np.zeros(npad, dtype=bool)
        valid[:n] = True
        a = bfio_assign_batch(
            _on(base[None], ctx.device, torch.float32),
            _on(np.full((1, R), npad), ctx.device, torch.int32),
            _on(cands[None], ctx.device, torch.float32),
            _on(valid[None], ctx.device, torch.bool),
            _on(np.array([n]), ctx.device, torch.int32),
            swap_iters=self.swap_iters)
        out = a.cpu().numpy()[0, :n].astype(np.int64)
        if (out < 0).any():   # defensive: caps are ample, so never hit
            fallback = LeastLoadedRouter().route(ctx)
            out = np.where(out < 0, fallback, out)
        return self._affinity_refine(ctx, out)


class PodBFIORouter(BFIORouter):
    """Two-level hierarchical BF-IO: replicas are grouped into ``pods``
    contiguous pods (sizes differ by at most one when R % pods != 0).

    Level 1 assigns each candidate to a pod by capacity-normalized
    least-loaded (sequential, each placement updates the running
    estimate); level 2 solves all pods' placements in ONE
    :func:`~repro_torch.core.balancer_jax.bfio_assign_batch` call with the pod
    axis as the cluster axis — solver cost grows with the pod size and
    per-pod candidate count, not with R.  With ``pods=1`` the solver
    sees bit-identical inputs to the flat :class:`BFIORouter` (a unit
    test pins this), so the hierarchy is a pure scaling knob.
    """

    def __init__(self, pods: int = 4, H: int = 0, swap_iters: int = 8,
                 pred_weight: float = 0.0,
                 affinity_weight: float = 0.0) -> None:
        super().__init__(H=H, swap_iters=swap_iters,
                         pred_weight=pred_weight,
                         affinity_weight=affinity_weight)
        self.pods = int(pods)
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {pods}")
        self.name = (f"pod_bfio_p{self.pods}"
                     + (f"_h{self.H}" if self.H else "")
                     + ("_affinity" if self.affinity_weight else ""))

    def route(self, ctx: RouterContext) -> np.ndarray:
        n, R = ctx.n_wait, ctx.R
        if n == 0:
            return np.empty(0, dtype=np.int64)
        P = min(self.pods, R)
        members = np.array_split(np.arange(R), P)
        sizes = self._sizes(ctx)
        growth = self._growth(ctx)                       # (W,)
        W = self.H + 1

        # level 1: capacity-normalized least-loaded pod, sequential so a
        # burst spreads instead of piling onto one pod.
        cap = (np.asarray(ctx.capacity, dtype=np.float64)
               if ctx.capacity is not None else np.ones(R))
        pod_cap = np.array([max(cap[m].sum(), 1e-12) for m in members])
        run = np.array([ctx.loads[m].sum() for m in members]) / pod_cap
        pod_of = np.empty(n, dtype=np.int64)
        for i in range(n):
            p = int(np.argmin(run))
            pod_of[i] = p
            run[p] += sizes[i] / pod_cap[p]
        order = [np.flatnonzero(pod_of == p) for p in range(P)]
        per = np.array([o.size for o in order], dtype=np.int64)

        # level 2: one batched solve, pods on the cluster axis.  Pods
        # smaller than the widest get zero caps + huge base loads on
        # their padding machine rows so the solver never picks them.
        npad = _pad_bucket(int(per.max()))
        rmax = max(m.size for m in members)
        base = np.full((P, rmax, W), 1e30)
        caps = np.zeros((P, rmax), dtype=np.int32)
        cands = np.zeros((P, npad, W))
        valid = np.zeros((P, npad), dtype=bool)
        for p, m in enumerate(members):
            base[p, :m.size] = (ctx.loads[m][:, None]
                                + ctx.counts[m][:, None] * growth[None, :])
            caps[p, :m.size] = npad
            idx = order[p]
            cands[p, :idx.size] = sizes[idx][:, None] + growth[None, :]
            valid[p, :idx.size] = True
        a = bfio_assign_batch(
            _on(base, ctx.device, torch.float32),
            _on(caps, ctx.device, torch.int32),
            _on(cands, ctx.device, torch.float32),
            _on(valid, ctx.device, torch.bool),
            _on(per, ctx.device, torch.int32),
            swap_iters=self.swap_iters).cpu().numpy()

        out = np.empty(n, dtype=np.int64)
        for p, m in enumerate(members):
            idx = order[p]
            if idx.size == 0:
                continue
            ap = a[p, :idx.size].astype(np.int64)
            bad = (ap < 0) | (ap >= m.size)
            if bad.any():   # defensive: caps are ample, so never hit
                ap = np.where(bad, int(np.argmin(ctx.loads[m])), ap)
            out[idx] = m[ap]
        return self._affinity_refine(ctx, out)


def make_router(name, **kw) -> FleetRouter:
    if isinstance(name, FleetRouter):
        return name
    name = name.lower()
    if name in ("rr", "round_robin"):
        return RoundRobinRouter()
    if name in ("ll", "least_loaded"):
        return LeastLoadedRouter()
    if name.startswith("pod_bfio"):
        # pod_bfio[_pP][_hH][_affinity], e.g. pod_bfio_p16 or
        # pod_bfio_p8_h2_affinity
        for part in name[len("pod_bfio"):].split("_"):
            if not part:
                continue
            if part == "affinity":
                kw.setdefault("affinity_weight", 1.0)
            elif part[0] == "p" and part[1:].isdigit():
                kw.setdefault("pods", int(part[1:]))
            elif part[0] == "h" and part[1:].isdigit():
                kw.setdefault("H", int(part[1:]))
            else:
                raise ValueError(
                    f"unknown pod_bfio suffix {part!r} in {name!r}")
        return PodBFIORouter(**kw)
    if name.startswith("pod"):
        d = int(name[3:]) if len(name) > 3 else kw.pop("d", 2)
        return PowerOfDRouter(d=d)
    if name.startswith("bfio"):
        # bfio[_hH][_affinity]; the affinity token must be parsed
        # explicitly — startswith("bfio") would otherwise swallow
        # "bfio_affinity" into a plain BFIORouter silently
        if "affinity" in name:
            kw.setdefault("affinity_weight", 1.0)
        if "_h" in name:
            kw.setdefault("H", int(name.split("_h")[1].split("_")[0]))
        return BFIORouter(**kw)
    raise ValueError(f"unknown fleet router {name!r}")
