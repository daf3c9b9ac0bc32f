"""Discrete-event simulator of GPU-based LLM decode serving (Section 6.2).

Models G workers with per-worker concurrency B.  Each simulation step:

  1. reveal arrivals (undiscovered -> wait queue);
  2. the routing policy admits waiting requests into free slots;
  3. loads L_g(k) are computed; the step advances wall-clock by
         dt = C + t_l * max_g L_g(k)                        (Eq. 19)
     and energy integrates the power model over dt (Eqs. 6-9);
  4. every active request produces one token; finished requests leave;
  5. surviving requests' workloads grow by the drift delta_{k+1}.

The simulator is slot-vectorized (numpy struct-of-arrays over (G, B)) so the
paper's G=256, B=72 configuration runs in seconds per policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .energy import A100_POWER, PowerModel
from .metrics import SimMetrics
from .policies import Policy, SchedulerContext
from .workload import ArrivalInstance

__all__ = ["SimConfig", "SimTrace", "simulate"]

# Paper Section 6.2 time-progression constants (regressed from real traces).
PAPER_C = 9.775e-3        # fixed per-step overhead, seconds
PAPER_T_TOKEN = 1.005e-7  # per-token latency coefficient, seconds/token


@dataclasses.dataclass(frozen=True)
class SimConfig:
    G: int = 256
    B: int = 72
    step_overhead: float = PAPER_C
    t_token: float = PAPER_T_TOKEN
    power: PowerModel = A100_POWER
    max_steps: int = 200_000
    seed: int = 0
    record_loads_every: int = 0   # 0 = don't record per-worker load traces
    time_based_arrivals: bool = False  # reveal by wall-clock arrival_time
    # "central": one waiting pool, the router reshapes batches at every
    # slot release (the paper's main interface).  "instant": requests bind
    # to a per-worker FIFO queue at arrival (Section 7.3's limitation —
    # vLLM-style engines), which strips the router of late information.
    # "instant_ref": the original per-request Python implementation of
    # instant mode, kept verbatim as the step-for-step regression oracle
    # and the pre-optimization baseline for benchmarks/balancer_bench.py.
    dispatch: str = "central"


@dataclasses.dataclass
class SimTrace:
    """Per-step traces for the paper's figures."""

    dt: list = dataclasses.field(default_factory=list)
    t: list = dataclasses.field(default_factory=list)
    imbalance: list = dataclasses.field(default_factory=list)
    max_load: list = dataclasses.field(default_factory=list)
    mean_load: list = dataclasses.field(default_factory=list)
    idle_frac: list = dataclasses.field(default_factory=list)
    avg_power: list = dataclasses.field(default_factory=list)
    n_active: list = dataclasses.field(default_factory=list)
    n_waiting: list = dataclasses.field(default_factory=list)
    loads: list = dataclasses.field(default_factory=list)  # optional (G,) snaps

    def asdict(self) -> dict:
        return {k: np.asarray(v) for k, v in dataclasses.asdict(self).items()}


def simulate(
    instance: ArrivalInstance,
    policy: Policy,
    config: SimConfig = SimConfig(),
    trace: Optional[SimTrace] = None,
) -> SimMetrics:
    """Run ``policy`` on ``instance`` until every request completes."""
    G, B = config.G, config.B
    drift = instance.drift
    rng = np.random.default_rng(config.seed)
    policy.reset()
    instance.reset()

    reqs = instance.requests
    N = len(reqs)
    arr_step = np.array([r.arrival_step for r in reqs], dtype=np.int64)
    arr_time = (np.array([r.arrival_time for r in reqs], dtype=np.float64)
                if config.time_based_arrivals else None)
    prefill = np.array([r.prefill for r in reqs], dtype=np.float64)
    decode_len = np.array([r.decode_len for r in reqs], dtype=np.int64)
    t_start = np.full(N, np.nan)
    t_finish = np.full(N, np.nan)

    # Slot state, flattened (G*B,)
    S = G * B
    slot_req = np.full(S, -1, dtype=np.int64)
    slot_w = np.zeros(S, dtype=np.float64)
    slot_age = np.zeros(S, dtype=np.int64)
    slot_worker = np.repeat(np.arange(G), B)

    waiting: list[int] = []
    instant = config.dispatch in ("instant", "instant_ref")
    instant_ref = config.dispatch == "instant_ref"
    wqueues: list[list[int]] = [[] for _ in range(G)]  # instant mode
    # Instant-mode queue state, maintained incrementally (never recomputed
    # by walking the queues): total queued prefill and queue length per
    # worker.  Matches the recomputed-per-step reference exactly when
    # prefills are float64-exact under addition (integer token counts, as
    # every in-repo workload produces); arbitrary mixed-magnitude floats
    # could differ from "instant_ref" by rounding in the running sum.
    qload = np.zeros(G, dtype=np.float64)
    qlen = np.zeros(G, dtype=np.int64)
    next_reveal = 0          # pointer into arrival-sorted requests
    completed = 0
    t_now = 0.0
    k = 0

    tot_imb = 0.0
    tot_tokens = 0
    tot_energy = 0.0
    tot_time = 0.0
    sum_idle_frac = 0.0
    n_steps_with_load = 0
    sum_power = 0.0

    pm = config.power

    while completed < N and k < config.max_steps:
        # --- 1. reveal arrivals -----------------------------------------
        if config.time_based_arrivals:
            while next_reveal < N and arr_time[next_reveal] <= t_now:
                waiting.append(next_reveal)
                next_reveal += 1
            # if nothing active and nothing waiting, jump to next arrival
            if not waiting and slot_req.max() < 0 and next_reveal < N:
                t_now = float(arr_time[next_reveal])
                continue
        else:
            while next_reveal < N and arr_step[next_reveal] <= k:
                waiting.append(next_reveal)
                next_reveal += 1
            if not waiting and slot_req.max() < 0 and next_reveal < N:
                k = int(arr_step[next_reveal])
                continue

        # --- 2. policy admission ----------------------------------------
        occ = slot_req >= 0
        loads = np.bincount(slot_worker[occ], weights=slot_w[occ], minlength=G)
        counts = np.bincount(slot_worker[occ], minlength=G)
        caps = B - counts
        if instant and instant_ref:
            # Original per-request Python implementation, kept verbatim as
            # the regression oracle for the vectorized path below.
            qload = np.zeros(G)
            qlen = np.zeros(G, dtype=np.int64)
            for g in range(G):
                qlen[g] = len(wqueues[g])
                qload[g] = sum(prefill[r] for r in wqueues[g])
            act_idx = np.nonzero(occ)[0]
            for rid in waiting:
                ctx = SchedulerContext(
                    k=k,
                    loads=loads + qload,
                    counts=(counts + qlen).astype(np.int64),
                    caps=np.maximum(B - counts - qlen, 1).astype(np.int64),
                    wait_prefill=prefill[[rid]],
                    active_worker=slot_worker[act_idx],
                    active_w=slot_w[act_idx],
                    active_age=slot_age[act_idx],
                    active_remaining=(decode_len[slot_req[act_idx]]
                                      - slot_age[act_idx]),
                    drift=drift,
                    rng=rng,
                )
                a = policy.assign(ctx)
                g = (int(a[0]) if len(a) and a[0] >= 0
                     else int(np.argmin(loads + qload)))
                wqueues[g].append(rid)
                qload[g] += prefill[rid]
                qlen[g] += 1
            waiting = []
            free_slots: list[list[int]] = [[] for _ in range(G)]
            for s_idx in np.nonzero(~occ)[0]:
                free_slots[slot_worker[s_idx]].append(int(s_idx))
            for g in range(G):
                while wqueues[g] and free_slots[g]:
                    rid = wqueues[g].pop(0)
                    s_idx = free_slots[g].pop(0)
                    slot_req[s_idx] = rid
                    slot_w[s_idx] = prefill[rid]
                    slot_age[s_idx] = 0
                    t_start[rid] = t_now
                    reqs[rid].assign_step = k
                    reqs[rid].worker = g
            occ = slot_req >= 0
            loads = np.bincount(slot_worker[occ], weights=slot_w[occ],
                                minlength=G)
        elif instant:
            # Vectorized instant mode.  Route every newly arrived request
            # immediately (no pool): the policy sees current loads + queued
            # prefill backlog, one candidate at a time, unconstrained by
            # free slots.  The routing loop itself is inherently sequential
            # (each decision shifts the backlog the next one observes), but
            # the context's active-slot arrays are batched once per step
            # and qload/qlen are carried incrementally across steps.
            if waiting:
                act_idx = np.nonzero(occ)[0]
                active_worker = slot_worker[act_idx]
                active_w = slot_w[act_idx]
                active_age = slot_age[act_idx]
                active_remaining = (decode_len[slot_req[act_idx]]
                                    - slot_age[act_idx])
                for rid in waiting:
                    ctx = SchedulerContext(
                        k=k,
                        loads=loads + qload,
                        counts=(counts + qlen).astype(np.int64),
                        caps=np.maximum(B - counts - qlen, 1).astype(np.int64),
                        wait_prefill=prefill[rid:rid + 1],
                        active_worker=active_worker,
                        active_w=active_w,
                        active_age=active_age,
                        active_remaining=active_remaining,
                        drift=drift,
                        rng=rng,
                    )
                    a = policy.assign(ctx)
                    g = (int(a[0]) if len(a) and a[0] >= 0
                         else int(np.argmin(loads + qload)))
                    wqueues[g].append(rid)
                    qload[g] += prefill[rid]
                    qlen[g] += 1
                waiting = []
            # Vectorized FIFO drain (every step — slot releases must drain
            # the queues even with no new arrivals): free slot indices are
            # ascending, hence grouped by worker; searchsorted over the
            # cumulative free-slot runs yields each worker's slot range
            # without materializing per-worker lists.
            if qlen.any() and not occ.all():
                free = np.nonzero(~occ)[0]
                free_worker = slot_worker[free]
                nfree = np.bincount(free_worker, minlength=G)
                ntake = np.minimum(nfree, qlen)
                gsel = np.nonzero(ntake > 0)[0]
                if len(gsel) > 0:
                    off = np.searchsorted(free_worker, np.arange(G))
                    rid_parts = []
                    slot_parts = []
                    for g in gsel:
                        g = int(g)
                        t_ = int(ntake[g])
                        q = wqueues[g]
                        rid_parts.extend(q[:t_])
                        wqueues[g] = q[t_:]
                        slot_parts.append(free[off[g]:off[g] + t_])
                        qlen[g] -= t_
                    rids = np.asarray(rid_parts, dtype=np.int64)
                    slots = np.concatenate(slot_parts)
                    np.add.at(qload, slot_worker[slots], -prefill[rids])
                    slot_req[slots] = rids
                    slot_w[slots] = prefill[rids]
                    slot_age[slots] = 0
                    t_start[rids] = t_now
                    for rid, s_idx in zip(rid_parts, slots):
                        reqs[rid].assign_step = k
                        reqs[rid].worker = int(slot_worker[s_idx])
                    occ = slot_req >= 0
                    loads = np.bincount(slot_worker[occ], weights=slot_w[occ],
                                        minlength=G)
        elif waiting and caps.sum() > 0:
            act_idx = np.nonzero(occ)[0]
            ctx = SchedulerContext(
                k=k,
                loads=loads,
                counts=counts.astype(np.int64),
                caps=caps.astype(np.int64),
                wait_prefill=prefill[np.asarray(waiting, dtype=np.int64)],
                active_worker=slot_worker[act_idx],
                active_w=slot_w[act_idx],
                active_age=slot_age[act_idx],
                active_remaining=(decode_len[slot_req[act_idx]]
                                  - slot_age[act_idx]),
                drift=drift,
                rng=rng,
            )
            assignment = policy.assign(ctx)
            if len(assignment) != len(waiting):
                raise RuntimeError(
                    f"{policy.name}: assignment length {len(assignment)} != "
                    f"waiting {len(waiting)}")
            # free slots, ascending (hence grouped by worker): worker g's
            # u-th free slot is free[foff[g] + u]
            free = np.nonzero(~occ)[0]
            foff = np.searchsorted(slot_worker[free], np.arange(G))
            admitted_pos = []
            used = np.zeros(G, dtype=np.int64)
            for pos, g in enumerate(assignment):
                if g < 0:
                    continue
                g = int(g)
                if used[g] >= caps[g]:
                    raise RuntimeError(
                        f"{policy.name}: worker {g} over capacity at step {k}")
                rid = waiting[pos]
                s_idx = int(free[foff[g] + used[g]])
                used[g] += 1
                slot_req[s_idx] = rid
                slot_w[s_idx] = prefill[rid]
                slot_age[s_idx] = 0
                t_start[rid] = t_now
                reqs[rid].assign_step = k
                reqs[rid].worker = g
                admitted_pos.append(pos)
            for pos in sorted(admitted_pos, reverse=True):
                waiting.pop(pos)
            occ = slot_req >= 0
            loads = np.bincount(slot_worker[occ], weights=slot_w[occ],
                                minlength=G)

        # --- 3. step timing, imbalance, energy --------------------------
        lmax = float(loads.max()) if occ.any() else 0.0
        imb = G * lmax - float(loads.sum())
        dt = config.step_overhead + config.t_token * lmax
        u = loads / lmax if lmax > 0 else np.zeros(G)
        step_power = pm.power(u).sum()
        tot_energy += dt * step_power
        tot_time += dt
        t_now += dt
        n_act = int(occ.sum())
        tot_tokens += n_act
        tot_imb += imb
        if lmax > 0:
            sum_idle_frac += float((lmax - loads).mean() / lmax)
            n_steps_with_load += 1
        sum_power += step_power / G

        if trace is not None:
            trace.dt.append(dt)
            trace.t.append(t_now)
            trace.imbalance.append(imb)
            trace.max_load.append(lmax)
            trace.mean_load.append(float(loads.mean()))
            trace.idle_frac.append(
                float((lmax - loads).mean() / lmax) if lmax > 0 else 0.0)
            trace.avg_power.append(step_power / G)
            trace.n_active.append(n_act)
            n_queued = (sum(len(q) for q in wqueues) if instant_ref
                        else int(qlen.sum()))
            trace.n_waiting.append(len(waiting) + n_queued)
            if (config.record_loads_every
                    and k % config.record_loads_every == 0):
                trace.loads.append(loads.copy())

        # --- 4. token generation & completions --------------------------
        act = np.nonzero(occ)[0]
        slot_age[act] += 1
        fin = act[slot_age[act] >= decode_len[slot_req[act]]]
        if len(fin) > 0:
            rids = slot_req[fin]
            t_finish[rids] = t_now
            for rid in rids:
                reqs[rid].finish_step = k
            completed += len(fin)
            slot_req[fin] = -1
            slot_w[fin] = 0.0
            slot_age[fin] = 0

        # --- 5. drift growth for survivors ------------------------------
        surv = slot_req >= 0
        if surv.any():
            slot_w[surv] += drift.increment(k + 1)
        k += 1

    if completed < N:
        raise RuntimeError(
            f"simulation hit max_steps={config.max_steps} with "
            f"{N - completed} requests unfinished")

    done = ~np.isnan(t_finish)
    tpot = float(np.mean((t_finish[done] - t_start[done])
                         / decode_len[done])) if done.any() else float("nan")
    for rid in np.nonzero(done)[0]:
        reqs[rid].t_start = float(t_start[rid])
        reqs[rid].t_finish = float(t_finish[rid])

    return SimMetrics(
        policy=policy.name,
        steps=k,
        avg_imbalance=tot_imb / max(k, 1),
        total_imbalance=tot_imb,
        throughput=tot_tokens / max(tot_time, 1e-12),
        tpot=tpot,
        energy_joules=tot_energy,
        makespan=tot_time,
        total_work=instance.total_work(),
        completed=completed,
        mean_idle_frac=sum_idle_frac / max(n_steps_with_load, 1),
        avg_power_watts=sum_power / max(k, 1),
    )
