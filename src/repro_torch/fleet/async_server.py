"""Event-driven fleet: each replica steps on its own clock.

:class:`~repro_torch.fleet.server.FleetServer` barrier-steps all R replicas —
the fleet clock rides the *slowest* batch every step and replicas that
finish early idle at ``P_idle``, the paper's waste mechanism operating
one tier up.  :class:`AsyncFleetServer` removes the barrier: a min-heap
of completion events advances the earliest-finishing replica, the
router places due arrivals against *staleness-bounded* snapshot views
(per-replica ``load_snapshot()`` caches refreshed on step completion,
their age surfaced to routers as ``RouterContext.snapshot_age``; ages
past ``max_snapshot_age`` force a refresh before routing — the model of
a load-report RPC), and an optional :class:`~repro_torch.fleet.autoscale.
Autoscaler` turns R into a decision variable.

Replica lifecycle: ``COLD`` (powered off, drawing nothing — the energy
win) -> ``WARMING`` (powered, joins after ``warmup_s``; every replica
runs over the one shared params dict on the fleet's device, so a
scale-up replica loads no weights) ->
``ACTIVE`` (routable) -> ``DRAINING`` (never routed to; resident
requests hand off *bit-exactly* via the engine's host-staged swap path
— :meth:`ServingEngine.drain` stages every victim's KV through
``serving/preemption.py`` and the re-routed replica restores it
block-for-block, so generations are identical to a run that never
scaled; the slot backend has no swap machinery, so its drains hand off
only queued work and let residents finish in place).

``barrier_compat=True`` is the parity oracle in the spirit of every
ref/vec seam in this repo: ``step()`` delegates to the inherited
barrier loop, so stats and telemetry are bit-identical to
:class:`FleetServer` on the same stream.  Accounting invariant shared with the barrier fleet: every
joule is either engine energy (covered by step intervals) or idle
draw (charged to powered, non-stepping replicas as the clock
advances), and the per-tick telemetry rows sum to exactly
``stats()["energy_j"]``.  ``tests/test_torch_fleet.py`` holds the
async fleet's stats and telemetry, drain handoffs included, equal to the
reference package's under both autoscalers.
"""
from __future__ import annotations

import heapq
from typing import Optional, Union

import numpy as np

from ..core.metrics import step_imbalance
from ..obs.ledger import CAUSE_INDEX, N_CAUSES, reconcile_split
from ..obs.trace import FLEET_TRACK
from .autoscale import Autoscaler, make_autoscaler
from .server import FleetServer

__all__ = ["AsyncFleetServer", "COLD", "WARMING", "ACTIVE", "DRAINING"]

# replica lifecycle states
COLD, WARMING, ACTIVE, DRAINING = 0, 1, 2, 3
# event kinds on the heap: step completion / warmup completion
EV_STEP, EV_WARM = 0, 1


class AsyncFleetServer(FleetServer):
    """Event-driven fleet with optional autoscaling.

    Extra knobs over :class:`FleetServer`:

    * ``barrier_compat`` — delegate stepping to the inherited barrier
      loop (bit-identical stats/telemetry; no async state is touched);
    * ``autoscaler`` — an :class:`~repro_torch.fleet.autoscale.Autoscaler`
      (or a factory name, ``"util"`` / ``"slo"``); None fixes R;
    * ``max_snapshot_age`` — seconds a replica's cached load view may
      trail the fleet clock before routing forces a refresh (0.0 =
      always fresh, the barrier fleet's implicit contract);
    * ``record_routes`` — append one audit entry per routing round to
      ``route_log`` (replica states, eligibility, assignments) for the
      staleness property tests.
    """

    def __init__(self, cfg, params, engine_cfg, *,
                 barrier_compat: bool = False,
                 autoscaler: Union[None, str, Autoscaler] = None,
                 max_snapshot_age: float = 0.0,
                 record_routes: bool = False, **kw):
        super().__init__(cfg, params, engine_cfg, **kw)
        if barrier_compat and autoscaler is not None:
            raise ValueError(
                "barrier_compat reproduces the fixed-R barrier fleet "
                "bit-for-bit; it cannot autoscale")
        self.barrier_compat = bool(barrier_compat)
        self.autoscaler: Optional[Autoscaler] = (
            None if autoscaler is None else make_autoscaler(autoscaler))
        self.max_snapshot_age = float(max_snapshot_age)
        self.record_routes = bool(record_routes)
        self.route_log: list[dict] = []
        # (t, seq, kind, replica) min-heap; seq keeps pops FIFO at ties
        self._ev_heap: list[tuple[float, int, int, int]] = []
        self._ev_seq = 0
        # per-replica lifecycle + clock state (everyone starts ACTIVE;
        # the first autoscale decision sheds what the load can't use)
        self._rs_state = np.full(self.R, ACTIVE, dtype=np.int64)
        self._rs_t_ready = np.zeros(self.R)
        self._rs_t_acc = np.zeros(self.R)    # power accounted up to
        self._rs_stepping = np.zeros(self.R, dtype=bool)
        # eager-step results carried from start to completion event
        self._rs_dt = np.zeros(self.R)
        self._rs_de = np.zeros(self.R)
        self._rs_dtok = np.zeros(self.R, dtype=np.int64)
        self._rs_busy_s = np.zeros(self.R)
        self._rs_on_s = np.zeros(self.R)
        # fleet-clock timestamp of each replica's cached load snapshot
        self._snap_time = np.zeros(self.R)
        # tick accumulators, flushed into one telemetry row per tick
        self._tick_t = 0.0
        self._tick_de = 0.0
        self._tick_idle = 0.0
        self._tick_tokens = 0
        self._tick_busy = np.zeros(self.R)
        self._tick_completions = 0
        # per-cause idle within the tick (repro_torch.obs.IDLE_CAUSES order);
        # reconciled against _tick_idle at the row flush
        self._tick_cause = np.zeros(N_CAUSES)
        # autoscaler bookkeeping (windowed signals + audit counters)
        self._as_next_decision = (self.autoscaler.interval_s
                                  if self.autoscaler is not None
                                  else np.inf)
        self._as_win_busy = 0.0
        self._as_win_on = 0.0
        self._as_req_mark = 0
        self._as_carry_ttft: dict[int, float] = {}
        self._as_drain_handoffs = 0
        self._as_drain_tokens_lost = 0
        self._as_scale_ups = 0
        self._as_scale_downs = 0
        self._as_warm_cancels = 0
        self._as_on_integral = 0.0           # integral of n_on over time

    # ------------------------------------------------------------- clock
    def _next_time(self) -> Optional[float]:
        """Next fleet-clock instant anything can happen: the earliest
        event, the next pending arrival, or (when autoscaling) the next
        decision boundary — fast-forwards through an idle trough are
        clamped at decision boundaries so scale-down actually runs."""
        cands = []
        if self._ev_heap:
            cands.append(self._ev_heap[0][0])
        if self._pending:
            cands.append(self._pending[0][0])
        if cands and self.autoscaler is not None:
            cands.append(float(self._as_next_decision))
        if self._queue:                      # defensive: route now
            cands.append(self.t_now)
        if not cands:
            return None
        return min(cands)

    def _advance(self, t: float) -> None:
        """Advance the fleet clock to ``t``, charging idle draw to every
        powered, non-stepping replica for the interval (stepping
        replicas' intervals are covered by their engine's step
        energy)."""
        t = max(float(t), self.t_now)
        idle_idx = np.flatnonzero((self._rs_state != COLD)
                                  & ~self._rs_stepping)
        any_stepping = bool(self._rs_stepping.any())
        for r in idle_idx:
            dt_r = float(t - self._rs_t_acc[r])
            if dt_r > 0:
                idle = dt_r * float(self._idle_power_vec[r])
                self.idle_j += idle
                # single-cause attribution per powered, non-stepping
                # replica (charged with the same float, right after the
                # idle_j accumulation — the ledger-total exactness gate)
                st = int(self._rs_state[r])
                if st == WARMING:
                    c = CAUSE_INDEX["warmup"]
                elif st == DRAINING:
                    c = CAUSE_INDEX["preempt_swap"]
                elif self._queue:
                    c = CAUSE_INDEX["routing_miss"]
                elif any_stepping:
                    c = CAUSE_INDEX["decode_tail"]
                else:
                    c = CAUSE_INDEX["arrival_gap"]
                self._obs_ledger.charge_one(idle, c)
                self._tick_cause[c] += idle
                self._tick_idle += idle
                self._rs_on_s[r] += dt_r
                self._as_win_on += dt_r
            self._rs_t_acc[r] = t
        n_on = int((self._rs_state != COLD).sum())
        self._as_on_integral += (t - self.t_now) * n_on
        self.t_now = t

    # ------------------------------------------------------------ events
    def _start_step(self, r: int) -> None:
        """Eager-step replica ``r``: the engine state advances now (so
        dt / energy / tokens are known), the *fleet* observes the
        results only at the completion event — that deferral is exactly
        the bounded snapshot staleness the router tolerates."""
        eng = self.engines[r]
        t0, e0, k0 = eng.t_now, eng.energy_j, eng.tokens_out
        eng.step()
        self._rs_dt[r] = eng.t_now - t0
        self._rs_de[r] = eng.energy_j - e0
        self._rs_dtok[r] = eng.tokens_out - k0
        self._rs_stepping[r] = True
        self._ev_seq += 1
        heapq.heappush(
            self._ev_heap,
            (self.t_now + float(self._rs_dt[r]), self._ev_seq,
             EV_STEP, r))

    def _complete_step(self, r: int) -> None:
        dt = float(self._rs_dt[r])
        self._rs_stepping[r] = False
        self._rs_busy_s[r] += dt
        self._rs_on_s[r] += dt
        self._as_win_busy += dt
        self._as_win_on += dt
        self._rs_t_acc[r] = self.t_now
        self._tick_de += float(self._rs_de[r])
        self._tick_tokens += int(self._rs_dtok[r])
        self._tick_busy[r] += dt
        self._tick_completions += 1
        self._refresh([r])
        self._snap_time[r] = self.t_now
        if self._rs_state[r] == DRAINING:
            self._drain_now(r)

    def _complete_warm(self, r: int) -> None:
        if self._rs_state[r] != WARMING:
            return                           # canceled while warming
        self._rs_state[r] = ACTIVE
        self._refresh([r])
        self._snap_time[r] = self.t_now

    def _pop_events(self) -> None:
        while self._ev_heap and self._ev_heap[0][0] <= self.t_now:
            _, _, kind, r = heapq.heappop(self._ev_heap)
            if kind == EV_STEP:
                self._complete_step(r)
            else:
                self._complete_warm(r)

    def _start_pending(self) -> None:
        """Start a step on every replica with work: routable replicas,
        plus slot-backend drainers finishing their residents in
        place."""
        for r in np.flatnonzero(~self._rs_stepping & self._busy_mask):
            r = int(r)
            st = int(self._rs_state[r])
            if st == ACTIVE or (st == DRAINING
                                and not self.engines[r]._paged):
                self._start_step(r)

    # ----------------------------------------------------------- routing
    def _route_async(self) -> None:
        """Route due arrivals over the ACTIVE subset against the cached
        (staleness-bounded) snapshot views.  Eligibility masking is the
        staleness property's guarantee: draining and not-yet-warm
        replicas are simply absent from the router's world."""
        if not self._queue:
            return
        elig = np.flatnonzero(self._rs_state == ACTIVE)
        if elig.size == 0:                   # r_min >= 1 prevents this
            return
        age = self.t_now - self._snap_time
        stale = [int(r) for r in elig if age[r] > self.max_snapshot_age]
        if stale:                            # the load-report RPC
            self._refresh(stale)
            self._snap_time[stale] = self.t_now
            age[stale] = 0.0
        entry = None
        if self.record_routes:
            entry = {"t": self.t_now, "eligible": elig.tolist(),
                     "states": self._rs_state.tolist(),
                     "snapshot_age": age[elig].tolist(),
                     "rids": [req.rid for _, req in self._queue]}
        touched = self._dispatch(
            self._snap_res[elig] + self._snap_wait_cost[elig],
            self._snap_active[elig] + self._snap_waiting[elig],
            self._snap_free[elig],
            eligible=elig, snapshot_age=age[elig])
        if touched:
            tl = sorted(touched)
            self._refresh(tl)
            self._snap_time[tl] = self.t_now
        if self._as_carry_ttft:
            # drained residents keep their original first-token time
            for rec in self._live:
                if rec["ttft"] is None \
                        and rec["rid"] in self._as_carry_ttft:
                    rec["ttft"] = self._as_carry_ttft.pop(rec["rid"])
        if entry is not None:
            entry["assigned"] = [self.assignments[rid]
                                 for rid in entry["rids"]]
            self.route_log.append(entry)

    # ------------------------------------------------------- autoscaling
    def _drain_now(self, r: int) -> None:
        """Evict replica ``r``'s work back into the fleet queue.  On the
        paged backend every resident's KV is host-staged by the swap
        path and restored bit-for-bit wherever the router re-lands the
        request; the slot backend hands off only queued work (residents
        finish in place) and the replica powers off once empty."""
        eng = self.engines[r]
        tr0 = eng.tokens_recomputed
        handoff = eng.drain()
        self._as_drain_tokens_lost += eng.tokens_recomputed - tr0
        self._as_drain_handoffs += len(handoff)
        if handoff:
            if self._obs_rec.enabled:
                for req in handoff:
                    self._obs_rec.point(FLEET_TRACK, req.rid,
                                        "drain-handoff", self.t_now,
                                        from_replica=r)
            ids = {id(req) for req in handoff}
            arrival = {}
            still = []
            for rec in self._live:
                if id(rec["req"]) in ids:
                    arrival[id(rec["req"])] = rec["t_arrival"]
                    if rec["ttft"] is not None:
                        self._as_carry_ttft[rec["rid"]] = rec["ttft"]
                else:
                    still.append(rec)
            self._live = still
            for req in handoff:
                self._queue.append(
                    (arrival.get(id(req), self.t_now), req))
        self._refresh([r])
        self._snap_time[r] = self.t_now
        if not self._busy_mask[r]:
            self._rs_state[r] = COLD

    def _window_slo(self) -> Optional[float]:
        """SLO attainment over requests finalized since the last
        decision (None when none finished or telemetry is off)."""
        if self.telemetry is None:
            return None
        window = self.telemetry.requests[self._as_req_mark:]
        self._as_req_mark = len(self.telemetry.requests)
        if not window:
            return None
        slo = self.telemetry.slo
        ok = sum(
            1 for q in window
            if q["status"] == "done" and q["ttft"] is not None
            and q["ttft"] <= slo.ttft_s
            and (q["tpot"] is None or q["tpot"] <= slo.tpot_s))
        return ok / len(window)

    def _autoscale(self) -> None:
        a = self.autoscaler
        n_active = int((self._rs_state == ACTIVE).sum())
        n_on = int((self._rs_state != COLD).sum())
        util = (self._as_win_busy / self._as_win_on
                if self._as_win_on > 0 else None)
        queue_depth = len(self._queue) + int(
            self._snap_waiting[self._rs_state == ACTIVE].sum())
        signals = {"t": self.t_now, "n_active": n_active, "n_on": n_on,
                   "utilization": util, "queue_depth": queue_depth,
                   "window_slo": self._window_slo(),
                   "pending": len(self._pending)}
        target = int(np.clip(a.decide(signals), a.r_min,
                             min(a.r_max, self.R)))
        n_up = n_active + int((self._rs_state == WARMING).sum())
        if target > n_up:
            cold = np.flatnonzero(self._rs_state == COLD)
            for r in cold[:target - n_up]:
                r = int(r)
                self._rs_state[r] = WARMING
                self._rs_t_ready[r] = self.t_now + a.warmup_s
                self._rs_t_acc[r] = self.t_now   # draws idle while warm
                self._ev_seq += 1
                heapq.heappush(
                    self._ev_heap,
                    (float(self._rs_t_ready[r]), self._ev_seq,
                     EV_WARM, r))
                self._as_scale_ups += 1
        elif target < n_up:
            excess = n_up - target
            # cancel in-flight warmups first (newest first) — their
            # stale heap entries are ignored by the state check
            warming = np.flatnonzero(self._rs_state == WARMING)
            for r in warming[::-1][:excess]:
                self._rs_state[int(r)] = COLD
                self._as_warm_cancels += 1
                excess -= 1
            if excess > 0:
                # drain the least-committed actives; target >= r_min
                # keeps at least r_min replicas routable throughout
                act = np.flatnonzero(self._rs_state == ACTIVE)
                commit = (self._snap_res + self._snap_wait_cost)[act]
                for r in act[np.argsort(commit, kind="stable")][:excess]:
                    r = int(r)
                    self._rs_state[r] = DRAINING
                    self._as_scale_downs += 1
                    if not self._rs_stepping[r]:
                        self._drain_now(r)
        self._as_win_busy = 0.0
        self._as_win_on = 0.0

    def _autoscale_due(self) -> None:
        if self.autoscaler is None:
            return
        while self.t_now >= self._as_next_decision:
            self._autoscale()
            self._as_next_decision += self.autoscaler.interval_s

    # -------------------------------------------------------------- tick
    def _record_tick(self) -> dict:
        """Close the tick: finalize requests, flush the accumulators
        into one telemetry row (same row schema as the barrier fleet,
        plus the v2 replica-count / per-replica-busy series)."""
        self.steps += 1
        self._finalize_requests()
        dt = self.t_now - self._tick_t
        self._tick_t = self.t_now
        imb = 0.0
        on = self._rs_state != COLD
        if self._tick_completions and int(on.sum()) > 0:
            imb = step_imbalance(self._snap_res[on])
            self.imbalance_sum += imb
        d_preempt = int(self._snap_preempt.sum()) - self._prev_preemptions
        d_hits = int(self._snap_hits.sum()) - self._prev_prefix_hits
        d_revived = (int(self._snap_revived.sum())
                     - self._prev_prefix_revived)
        self._prev_preemptions += d_preempt
        self._prev_prefix_hits += d_hits
        self._prev_prefix_revived += d_revived
        # per-tick cause split: reconcile so the row's idle_split folds
        # to its idle_j bit-exactly (async rows have no gating replica)
        split = reconcile_split(self._tick_idle, self._tick_cause)
        if self.telemetry is not None:
            self.telemetry.record_step(
                step=self.steps, t=self.t_now, dt=dt,
                replica_loads=self._snap_res.copy(),
                replica_active=self._snap_active.tolist(),
                replica_waiting=self._snap_waiting.tolist(),
                cross_imbalance=imb, energy_j=self._tick_de,
                idle_j=self._tick_idle, tokens=self._tick_tokens,
                preemptions=d_preempt, prefix_hits=d_hits,
                replica_count=int((self._rs_state == ACTIVE).sum()),
                replica_busy=self._tick_busy.copy(),
                prefix_revived=d_revived,
                prefix_cached_blocks=int(self._snap_cached.sum()),
                gating_replica=-1, idle_split=split)
        info = {"t": self.t_now, "dt": dt, "imbalance": imb,
                "tokens": self._tick_tokens, "idle_j": self._tick_idle,
                "waiting": (len(self._pending) + len(self._queue)
                            + int(self._snap_waiting.sum())),
                "replica_waiting": self._snap_waiting.tolist()}
        self._tick_de = 0.0
        self._tick_idle = 0.0
        self._tick_tokens = 0
        self._tick_busy[:] = 0.0
        self._tick_completions = 0
        self._tick_cause[:] = 0.0
        return info

    # ----------------------------------------------------------- driving
    def _step_barrier(self) -> dict:
        """The parity oracle: one inherited barrier step, untouched."""
        return FleetServer.step(self)

    def _step_async(self) -> dict:
        """One event tick: advance to the next instant anything can
        happen, complete due events, release + route arrivals over the
        eligible subset, catch up autoscale decisions, start new
        steps."""
        t_next = self._next_time()
        if t_next is None:
            raise RuntimeError(
                "async fleet stuck: queued work but no events, "
                "arrivals, or routable replicas")
        self._advance(t_next)
        self._pop_events()
        self._release_arrivals()
        self._autoscale_due()
        self._route_async()
        self._start_pending()
        return self._record_tick()

    def step(self) -> dict:
        if self.barrier_compat:
            return self._step_barrier()
        return self._step_async()

    def _any_busy(self) -> bool:
        if self.barrier_compat:
            return FleetServer._any_busy(self)
        # every in-flight step and warmup is on the heap; nothing can
        # happen once it is empty and no arrivals remain
        return bool(self._ev_heap)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        out = super().stats()
        if self.barrier_compat:
            return out
        busy = self._rs_busy_s
        on = self._rs_on_s
        out.update({
            "fleet_kind": "async",
            "drain_handoffs": self._as_drain_handoffs,
            "drain_tokens_lost": int(self._as_drain_tokens_lost),
            "scale_ups": self._as_scale_ups,
            "scale_downs": self._as_scale_downs,
            "warm_cancels": self._as_warm_cancels,
            "replica_busy_s": [float(x) for x in busy],
            "replica_on_s": [float(x) for x in on],
            "utilization": float(busy.sum() / max(on.sum(), 1e-12)),
            "r_on_mean": float(self._as_on_integral
                               / max(self.t_now, 1e-12)),
        })
        return out
