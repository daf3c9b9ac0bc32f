"""FleetServer: two-tier BF-IO serving across R engine replicas.

The repo's :class:`~repro_torch.serving.engine.ServingEngine` is one replica —
G decode workers behind one admission scheduler.  The paper's scaling
results (imbalance reduction *grows* with system scale, >52% energy in
the G -> infinity limit) need the tier above: many replicas, heavy
arrival streams, and a router spreading traffic across them.
:class:`FleetServer` is that tier, runnable end to end:

* R independent :class:`ServingEngine` replicas (shared params — one
  copy of the weights on the fleet's device serves every replica, as DP
  shards of one deployment),
  each with its own slot table, KV backend, wait queue, and engine-tier
  placement policy.  Replicas may be heterogeneous
  (``replica_classes``): per-replica G/B/power constants, with slot
  capacity surfaced to capacity-aware routers;
* a barrier-stepped continuous loop: release due arrivals, route them
  (:mod:`repro_torch.fleet.router` — every waiting request is placed every
  step), then step every busy replica once; the fleet clock advances by
  the *slowest* replica's step (the barrier), and replicas that finish
  early (or idle) draw idle power for the remainder — the fleet-tier
  analogue of the per-worker barrier idle the paper's energy theorem
  prices;
* fleet-clock per-request bookkeeping (TTFT / TPOT / latency, terminal
  ``status``/``error``) streamed into
  :class:`~repro_torch.fleet.telemetry.FleetTelemetry`.

Two fleet modes, following the repo's ref/vec pattern (``engine_mode``,
``dispatch``): ``fleet_mode="ref"`` re-gathers every replica's
:meth:`~repro_torch.serving.engine.ServingEngine.load_snapshot` each step —
O(R) Python work per barrier, the live baseline the ``fleet_scale``
reference's bench times against — while ``fleet_mode="vec"`` (default)
keeps the
per-replica snapshot values in incrementally-updated numpy arrays,
refreshed only for replicas actually touched (routed to or stepped), so
a mostly-idle R=256 fleet pays for its busy replicas, not for R.  Both
modes feed the same values through the same arithmetic, so their stats
and telemetry are bit-identical (``tests/test_torch_fleet.py`` holds
both against the reference package under every router).

Failure isolation: a request the engine can never serve (decode growth
past its whole pool, or a prompt rejected at submit) fails *that
request* — surfaced on ``ServeRequest.status`` / ``.error`` and in the
telemetry — while both the replica and the fleet keep serving.

``fleet(R=1, router=*)`` is bit-identical to a bare engine on the same
stream (the single replica sees the identical submission sequence), so
every fleet run is anchored to the exhaustively-tested one-replica
semantics (``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

import heapq
from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..configs.base import ModelConfig
from ..core import make_policy
from ..core.metrics import step_imbalance
from ..models import resolve_device
from ..obs.ledger import (CAUSE_INDEX, N_CAUSES, PHASE_CAUSE,
                          StragglerLedger, attribute_step_idle,
                          reconcile_split)
from ..obs.trace import FLEET_TRACK, NULL_RECORDER
from ..serving import EngineConfig, ServeRequest, ServingEngine
from .router import FleetRouter, RouterContext, make_router
from .telemetry import FleetTelemetry

__all__ = ["FleetServer"]


class FleetServer:
    """Barrier-stepped fleet of engine replicas behind a router seam.

    ``replica_classes`` (optional) replaces the homogeneous
    ``n_replicas x engine_cfg`` fleet with a list of ``(count,
    EngineConfig)`` classes, expanded in order; per-replica capacity and
    idle power follow each class's config.  ``predictor`` (None,
    ``"oracle"``, or a callable ``ServeRequest -> float``) supplies a
    predicted output length per routing candidate, surfaced to routers
    as ``RouterContext.pred_out`` (the oracle reads
    ``req.max_new_tokens`` — an upper bound on what the request can
    decode).

    ``device`` (default ``cuda``; the tests pass ``"cpu"``) takes the
    place of the reference's ``mesh``: every replica runs on it over the
    one shared ``params`` dict, which must already live there, and it is
    handed to the router through :attr:`RouterContext.device`, the seam
    through which the BF-IO routers' batched solve runs on the card.
    """

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 *, n_replicas: int = 4,
                 router: Union[str, FleetRouter] = "bfio",
                 policy: str = "bfio_h0", device=None, drift=None,
                 telemetry: Optional[FleetTelemetry] = None,
                 seed: int = 0, fleet_mode: str = "vec",
                 replica_classes: Optional[
                     Sequence[tuple[int, EngineConfig]]] = None,
                 predictor: Union[None, str,
                                  Callable[[ServeRequest], float]] = None,
                 obs=None):
        if fleet_mode not in ("ref", "vec"):
            raise ValueError(
                f"fleet_mode must be 'ref' or 'vec', got {fleet_mode!r}")
        self.fleet_mode = fleet_mode
        if replica_classes is not None:
            ecs: list[EngineConfig] = []
            for count, klass_ec in replica_classes:
                if count < 1:
                    raise ValueError(
                        f"replica class count must be >= 1, got {count}")
                ecs.extend([klass_ec] * int(count))
            if not ecs:
                raise ValueError("replica_classes is empty")
        else:
            if n_replicas < 1:
                raise ValueError(
                    f"n_replicas must be >= 1, got {n_replicas}")
            ecs = [engine_cfg] * int(n_replicas)
        self.R = len(ecs)
        self.router = make_router(router)
        # per-request tracing + straggler attribution (repro_torch.obs); the
        # recorder is shared with every engine (each on its own track)
        self._obs_rec = obs if obs is not None else NULL_RECORDER
        self._obs_ledger = StragglerLedger()
        # one device for the fleet: every replica (they share ``params``,
        # one copy of the weights) and the router's batched solve
        self.device = resolve_device(device)
        self.engines = [
            ServingEngine(cfg, params, ec, make_policy(policy),
                          device=self.device, drift=drift, obs=obs,
                          obs_replica=i)
            for i, ec in enumerate(ecs)
        ]
        self.ec = engine_cfg
        self.telemetry = telemetry
        self.rng = np.random.default_rng(seed)
        if predictor is None:
            self._predict = None
        elif predictor == "oracle":
            self._predict = lambda r: float(r.max_new_tokens)
        elif callable(predictor):
            self._predict = predictor
        else:
            raise ValueError(
                f"predictor must be None, 'oracle', or a callable, "
                f"got {predictor!r}")
        self.t_now = 0.0
        self.steps = 0
        self.idle_j = 0.0            # barrier + between-arrival idle draw
        self.imbalance_sum = 0.0
        self.requests_failed = 0
        # (arrival_time, seq, req) min-heap of not-yet-due submissions
        # (seq breaks ties FIFO and keeps req out of the comparison)
        self._pending: list[tuple[float, int, ServeRequest]] = []
        self._seq = 0
        # (arrival_time, req): due, not yet routed
        self._queue: list[tuple[float, ServeRequest]] = []
        self._live: list[dict] = []            # routed, not finalized
        self.requests: list[ServeRequest] = []
        self.assignments: dict[int, int] = {}  # rid -> replica
        # per-replica constants (heterogeneous-safe)
        self._idle_power_vec = np.array(
            [float(e.ec.power.power(0.0)) * e.ec.n_workers
             for e in self.engines])
        self._capacity = np.array([float(e.N) for e in self.engines])
        # vec mode: cached per-replica LoadSnapshot fields, refreshed only
        # for replicas that were routed to or stepped (see _refresh)
        self._snap_res = np.zeros(self.R)
        self._snap_wait_cost = np.zeros(self.R)
        self._snap_active = np.zeros(self.R, dtype=np.int64)
        self._snap_waiting = np.zeros(self.R, dtype=np.int64)
        self._snap_free = np.array([e.N for e in self.engines],
                                   dtype=np.int64)
        self._snap_tokens = np.zeros(self.R, dtype=np.int64)
        self._snap_preempt = np.zeros(self.R, dtype=np.int64)
        self._snap_hits = np.zeros(self.R, dtype=np.int64)
        self._snap_cached = np.zeros(self.R, dtype=np.int64)
        self._snap_revived = np.zeros(self.R, dtype=np.int64)
        self._busy_mask = np.zeros(self.R, dtype=bool)
        # telemetry per-step deltas: previous cumulative fleet totals
        self._prev_preemptions = 0
        self._prev_prefix_hits = 0
        self._prev_prefix_revived = 0

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest, arrival_time: float = 0.0) -> None:
        """Queue a request for release at ``arrival_time`` on the fleet
        clock (0 = immediately)."""
        self.requests.append(req)
        if self._obs_rec.enabled:
            self._obs_rec.point(FLEET_TRACK, req.rid, "queued",
                                float(arrival_time),
                                n_prompt=len(req.tokens))
        heapq.heappush(self._pending,
                       (float(arrival_time), self._seq, req))
        self._seq += 1

    def submit_scenario(self, scenario) -> None:
        """Submit every request of a :class:`~repro_torch.fleet.workloads.
        Scenario` at its arrival time."""
        for fr in scenario.requests:
            self.submit(fr.to_serve_request(), fr.arrival_time)

    # ------------------------------------------------------------------
    def _release_arrivals(self) -> None:
        while self._pending and self._pending[0][0] <= self.t_now:
            t, _, req = heapq.heappop(self._pending)
            self._queue.append((t, req))

    def _refresh(self, replicas) -> None:
        """Re-read :meth:`ServingEngine.load_snapshot` for the given
        replica ids into the vec-mode cache arrays.  Everything the
        fleet hot path reads per step flows through here, so vec cost
        scales with touched replicas, not R."""
        for r in replicas:
            s = self.engines[r].load_snapshot()
            self._snap_res[r] = s.resident_load
            self._snap_wait_cost[r] = s.wait_cost
            self._snap_active[r] = s.active
            self._snap_waiting[r] = s.waiting
            self._snap_free[r] = s.free_slots
            self._snap_tokens[r] = s.tokens_out
            self._snap_preempt[r] = s.preemptions
            self._snap_hits[r] = s.prefix_hits
            self._snap_cached[r] = s.prefix_cached_blocks
            self._snap_revived[r] = s.prefix_revived
            self._busy_mask[r] = s.busy

    def _pred_out(self) -> Optional[np.ndarray]:
        if self._predict is None:
            return None
        return np.array([float(self._predict(req))
                         for _, req in self._queue])

    @staticmethod
    def _req_chain(req: ServeRequest, bs: int, prefix) -> list:
        """Memoized block-hash chain for a request's full prompt at
        block size ``bs`` (``ServeRequest.prefix_keys``) — the affinity
        probe and the engine's admission share one hash walk per prompt
        per block size (gated by the hash-count regression test)."""
        chain = req.prefix_keys.get(bs)
        if chain is None:
            chain = prefix.keys_for(req.tokens, bs)
            req.prefix_keys[bs] = chain
        return chain

    def _affinity_matrix(self, eligible=None) -> Optional[np.ndarray]:
        """(R', n) predicted prefix-hit tokens: each candidate's prompt
        head hashed against each routable replica's live PrefixIndex —
        entry [j, i] counts the leading tokens of candidate i whose
        blocks are live (referenced or LRU-cached) on replica ids[j].

        Read-only probe: ``lookup`` + ``is_live`` only — never
        ``note_lookup`` (routing probes must not skew hit-rate
        accounting) and never ``touch`` (a probe is not a use; LRU
        recency belongs to admissions).  Returns None when no replica
        has an index, so plain load-only routing is unaffected."""
        ids = (list(range(self.R)) if eligible is None
               else [int(r) for r in eligible])
        n = len(self._queue)
        aff = np.zeros((len(ids), n))
        keys_by_bs: dict = {}   # block_size -> per-candidate key chains
        any_index = False
        for j, r in enumerate(ids):
            backend = self.engines[r].backend
            prefix = getattr(backend, "prefix", None)
            if prefix is None:
                continue
            any_index = True
            alloc = backend.kv.allocator
            bs = int(backend.block_size)
            if bs not in keys_by_bs:
                keys_by_bs[bs] = [self._req_chain(req, bs, prefix)
                                  for _, req in self._queue]
            for i, keys in enumerate(keys_by_bs[bs]):
                toks = 0
                for key, parent, span in keys:
                    blk = prefix.lookup(key, parent, span)
                    if blk is None or not alloc.is_live(blk):
                        break
                    toks += len(span)
                aff[j, i] = toks
        return aff if any_index else None

    def _dispatch(self, loads: np.ndarray, counts: np.ndarray,
                  free: np.ndarray, *, eligible=None,
                  snapshot_age=None) -> set:
        """Route every due candidate given the committed per-replica
        state; returns the set of replicas submitted to.  Shared by both
        fleet modes — identical context in, identical assignment out.

        ``eligible`` (optional, async fleet) restricts routing to a
        subset of replica ids: the router sees only the subset's rows
        (its world is ``len(eligible)`` replicas) and the returned
        subset-space assignment is mapped back to fleet ids here —
        draining / not-yet-warm replicas are unroutable by
        construction.  ``snapshot_age`` annotates the same rows with
        the staleness of their load views (:class:`RouterContext`)."""
        ctx = RouterContext(
            k=self.steps, loads=loads, counts=counts, free_slots=free,
            wait_sizes=np.array([float(len(r.tokens))
                                 for _, r in self._queue]),
            drift=self.engines[0].drift, rng=self.rng,
            capacity=(self._capacity if eligible is None
                      else self._capacity[eligible]),
            pred_out=self._pred_out(), snapshot_age=snapshot_age,
            device=self.device,
            # the probe walks every replica's index, so only routers
            # that opt in (affinity_weight != 0) pay for it
            affinity=(self._affinity_matrix(eligible)
                      if getattr(self.router, "affinity_weight", 0.0)
                      else None))
        assign = np.asarray(self.router.route(ctx))
        n_route = self.R if eligible is None else len(eligible)
        if assign.shape != (len(self._queue),) or (assign < 0).any() \
                or (assign >= n_route).any():
            raise ValueError(
                f"router {self.router.name!r} returned an invalid "
                f"assignment (shape {assign.shape}, range "
                f"[{assign.min() if assign.size else 0}, "
                f"{assign.max() if assign.size else 0}]) for "
                f"{len(self._queue)} candidates over {n_route} replicas")
        if eligible is not None:
            assign = np.asarray(eligible)[assign]
        touched = set()
        for (t_arrival, req), g in zip(self._queue, assign):
            g = int(g)
            self.assignments[req.rid] = g
            if self._obs_rec.enabled:
                self._obs_rec.point(FLEET_TRACK, req.rid, "routed",
                                    self.t_now, replica=g)
            rec = {"rid": req.rid, "req": req, "replica": g,
                   "t_arrival": t_arrival, "t_routed": self.t_now,
                   "ttft": None}
            try:
                self.engines[g].submit(req)
                touched.add(g)
            except ValueError as e:     # e.g. prompt can never fit the pool
                req.error = str(e)
                req.status = "failed"
                req.t_finish = self.t_now
            self._live.append(rec)
        self._queue = []
        return touched

    def _route_ref(self) -> None:
        """Per-route full re-gather from every replica (the baseline)."""
        if not self._queue:
            return
        snaps = [e.load_snapshot() for e in self.engines]
        self._dispatch(
            np.array([s.committed_load for s in snaps]),
            np.array([s.committed_count for s in snaps], dtype=np.int64),
            np.array([s.free_slots for s in snaps], dtype=np.int64))

    def _route_vec(self) -> None:
        """Route from the cached arrays; refresh only touched replicas."""
        if not self._queue:
            return
        touched = self._dispatch(
            self._snap_res + self._snap_wait_cost,
            self._snap_active + self._snap_waiting,
            self._snap_free)
        if touched:
            self._refresh(sorted(touched))

    def _finalize_requests(self) -> None:
        """Fleet-clock request bookkeeping after a barrier step."""
        still = []
        for rec in self._live:
            req = rec["req"]
            if rec["ttft"] is None and not np.isnan(req.t_first_token):
                rec["ttft"] = self.t_now - rec["t_arrival"]
            if req.done:
                if req.failed:
                    self.requests_failed += 1
                latency = self.t_now - rec["t_arrival"]
                if self._obs_rec.enabled:
                    self._obs_rec.point(
                        FLEET_TRACK, req.rid,
                        "failed" if req.failed else "completed",
                        self.t_now, replica=rec["replica"])
                n_gen = len(req.generated)
                tpot = None
                if rec["ttft"] is not None and n_gen > 1:
                    tpot = (latency - rec["ttft"]) / (n_gen - 1)
                if self.telemetry is not None:
                    self.telemetry.record_request(
                        rid=req.rid, replica=rec["replica"],
                        status=req.status, error=req.error,
                        t_arrival=rec["t_arrival"],
                        t_routed=rec["t_routed"], ttft=rec["ttft"],
                        tpot=tpot, latency=latency,
                        n_prompt=len(req.tokens), n_generated=n_gen)
            else:
                still.append(rec)
        self._live = still

    def _busy(self, eng: ServingEngine) -> bool:
        return bool(eng.wait) or bool(eng.table.active.any())

    # ------------------------------------------------------------------
    def _account(self, *, loads: np.ndarray, dts: np.ndarray,
                 de: np.ndarray, any_busy: bool, tokens: int,
                 active: list, waiting: list, preemptions: int,
                 prefix_hits: int, prefix_revived: int,
                 prefix_cached: int, queued: int,
                 phases: Optional[list] = None) -> dict:
        """Shared barrier accounting: clock/idle/imbalance update,
        request finalization, telemetry row, step info.  Both fleet
        modes call this with identical values, so every derived number
        is computed by identical arithmetic — the bit-identity gate
        rests on this.

        ``phases`` (per-replica engine step phase, ``"idle"`` for
        unstepped replicas) drives the straggler attribution: the step's
        idle joules are split by cause against the gating replica's
        phase and charged to the ledger with the *same float, in the
        same order* as ``self.idle_j`` accumulates — so the ledger total
        matches ``idle_j`` bit-exactly (see :mod:`repro_torch.obs.ledger`)."""
        if any_busy:
            imb = step_imbalance(loads)
            dt = float(dts.max())
            self.imbalance_sum += imb
            idle = float(((dt - dts) * self._idle_power_vec).sum())
            gating = int(np.argmax(dts))
            # the replicas the gating replica kept waiting inherit its
            # phase as cause; a replica that sat fully idle while work
            # waited anywhere in the fleet is a routing miss instead
            phase = "idle" if phases is None else phases[gating]
            causes = np.full(self.R, PHASE_CAUSE.get(
                phase, CAUSE_INDEX["decode_tail"]), dtype=np.int64)
            if queued > 0:
                causes[dts == 0.0] = CAUSE_INDEX["routing_miss"]
            split = attribute_step_idle(
                idle, (dt - dts) * self._idle_power_vec, causes)
        else:
            # fleet idle: fast-forward to the next arrival
            imb = 0.0
            dt = max(self._pending[0][0] - self.t_now, 0.0) \
                if self._pending else 0.0
            idle = float(dt * self._idle_power_vec.sum())
            gating = -1
            split = np.zeros(N_CAUSES)
            split[CAUSE_INDEX["arrival_gap"]] = idle
            split = reconcile_split(idle, split)
        self.idle_j += idle
        self._obs_ledger.charge(idle, split, gating)
        self.t_now += dt
        self.steps += 1
        self._finalize_requests()
        d_preempt = preemptions - self._prev_preemptions
        d_hits = prefix_hits - self._prev_prefix_hits
        d_revived = prefix_revived - self._prev_prefix_revived
        self._prev_preemptions = preemptions
        self._prev_prefix_hits = prefix_hits
        self._prev_prefix_revived = prefix_revived
        if self.telemetry is not None:
            self.telemetry.record_step(
                step=self.steps, t=self.t_now, dt=dt,
                replica_loads=loads,
                replica_active=active, replica_waiting=waiting,
                cross_imbalance=imb, energy_j=float(de.sum()),
                idle_j=idle, tokens=tokens,
                preemptions=d_preempt, prefix_hits=d_hits,
                replica_count=self.R, replica_busy=dts,
                prefix_revived=d_revived,
                prefix_cached_blocks=prefix_cached,
                gating_replica=gating, idle_split=split)
        return {"t": self.t_now, "dt": dt, "imbalance": imb,
                "tokens": tokens, "idle_j": idle,
                "waiting": len(self._pending) + len(self._queue) + queued,
                "replica_waiting": waiting}

    def _step_ref(self) -> dict:
        """Reference barrier step: every per-replica quantity is
        re-gathered from the engines via Python loops — O(R) per step
        regardless of how many replicas are busy."""
        self._release_arrivals()
        self._route_ref()
        snaps = [e.load_snapshot() for e in self.engines]
        loads = np.array([s.resident_load for s in snaps])
        tokens0 = sum(s.tokens_out for s in snaps)
        dts = np.zeros(self.R)
        de = np.zeros(self.R)
        phases = ["idle"] * self.R
        any_busy = False
        for r, eng in enumerate(self.engines):
            if not snaps[r].busy:
                continue
            any_busy = True
            t0, e0 = eng.t_now, eng.energy_j
            info = eng.step()
            phases[r] = info["phase"]
            dts[r] = eng.t_now - t0
            de[r] = eng.energy_j - e0
        post = [e.load_snapshot() for e in self.engines]
        return self._account(
            loads=loads, dts=dts, de=de, any_busy=any_busy,
            tokens=sum(s.tokens_out for s in post) - tokens0,
            active=[s.active for s in post],
            waiting=[s.waiting for s in post],
            preemptions=sum(s.preemptions for s in post),
            prefix_hits=sum(s.prefix_hits for s in post),
            prefix_revived=sum(s.prefix_revived for s in post),
            prefix_cached=sum(s.prefix_cached_blocks for s in post),
            queued=sum(s.waiting for s in post), phases=phases)

    def _step_vec(self) -> dict:
        """Vectorized barrier step: per-replica state lives in cached
        arrays refreshed only for touched replicas, and all fleet
        bookkeeping is array ops over R."""
        self._release_arrivals()
        self._route_vec()
        # pre-step loads: copy before the post-step refresh overwrites
        loads = self._snap_res.copy()
        tokens0 = int(self._snap_tokens.sum())
        dts = np.zeros(self.R)
        de = np.zeros(self.R)
        phases = ["idle"] * self.R
        busy_idx = np.flatnonzero(self._busy_mask)
        for r in busy_idx:
            eng = self.engines[r]
            t0, e0 = eng.t_now, eng.energy_j
            info = eng.step()
            phases[r] = info["phase"]
            dts[r] = eng.t_now - t0
            de[r] = eng.energy_j - e0
        if busy_idx.size:
            self._refresh(busy_idx)
        return self._account(
            loads=loads, dts=dts, de=de, any_busy=busy_idx.size > 0,
            tokens=int(self._snap_tokens.sum()) - tokens0,
            active=self._snap_active.tolist(),
            waiting=self._snap_waiting.tolist(),
            preemptions=int(self._snap_preempt.sum()),
            prefix_hits=int(self._snap_hits.sum()),
            prefix_revived=int(self._snap_revived.sum()),
            prefix_cached=int(self._snap_cached.sum()),
            queued=int(self._snap_waiting.sum()), phases=phases)

    def step(self) -> dict:
        """One fleet barrier step: release due arrivals, route, step
        every busy replica, advance the fleet clock by the slowest
        replica's step and charge idle power for the slack."""
        if self.fleet_mode == "vec":
            return self._step_vec()
        return self._step_ref()

    def _any_busy(self) -> bool:
        if self.fleet_mode == "vec":
            return bool(self._busy_mask.any())
        return any(self._busy(e) for e in self.engines)

    def has_work(self) -> bool:
        """Whether a submitted request is not yet terminal: the loop
        condition of :meth:`run`, public for callers that time each
        step themselves."""
        return bool(self._pending or self._queue or self._any_busy())

    def run(self, max_steps: int = 100_000) -> dict:
        """Step until every submitted request reaches a terminal state."""
        while self.has_work():
            if self.steps >= max_steps:
                raise RuntimeError("fleet exceeded max_steps")
            self.step()
        return self.stats()

    # ------------------------------------------------------------------
    def straggler_ledger(self) -> dict:
        """JSON-native report of the cause-attributed idle ledger (see
        :class:`repro_torch.obs.ledger.StragglerLedger`); its
        ``total_idle_j`` equals :attr:`idle_j` bit-exactly."""
        return self._obs_ledger.report()

    def format_straggler_ledger(self) -> str:
        """Human-readable ledger table (per-cause joules + gating
        replicas) — the serve-cluster demo print."""
        return self._obs_ledger.format()

    def stats(self) -> dict:
        rep = [e.stats() for e in self.engines]
        tokens = sum(r["tokens"] for r in rep)
        engine_j = sum(r["energy_j"] for r in rep)
        energy = engine_j + self.idle_j
        return {
            "router": self.router.name,
            "n_replicas": self.R,
            "steps": self.steps,
            "time_s": self.t_now,
            "tokens": tokens,
            "throughput_tok_s": tokens / max(self.t_now, 1e-12),
            "engine_energy_j": engine_j,
            "idle_j": self.idle_j,
            "energy_j": energy,
            "energy_per_token": energy / max(tokens, 1),
            "avg_cross_imbalance": self.imbalance_sum / max(self.steps, 1),
            "completed": sum(1 for r in self.requests
                             if r.status == "done"),
            "failed": self.requests_failed,
            "preemptions": sum(r["preemptions"] for r in rep),
            "prefix_hits": sum(r["prefix_hits"] for r in rep),
            "prefix_revived": sum(r["prefix_revived"] for r in rep),
            "prefix_cached_blocks": sum(r["prefix_cached_blocks"]
                                        for r in rep),
            "replicas": rep,
        }
