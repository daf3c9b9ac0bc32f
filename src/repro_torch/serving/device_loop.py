"""Device-side routed decode loop: BF-IO inside a multi-step serving loop
that keeps its state on the device.

The host engine (engine.py) calls the router between device steps — the
realistic deployment.  This module is the *other* integration the
batched balancer (:mod:`repro_torch.core.balancer_jax`) enables: the
whole admit→decode→complete loop runs on device tensors, so the card can
run many serving steps with no host round-trip (simulation at device
speed, offline batch inference).  Each step's BF-IO admission is
``bfio_assign`` with its default ``method="kernel"``: the hand-written
swap-search kernel (``csrc/bfio_swap.cu``) runs ``swap_iters`` times a
step on a CUDA state, its plain version on a CPU state.

State is fixed-shape: a slot table (G*B slots, the same flat layout as
:mod:`repro_torch.serving.slot_table` — slot s belongs to worker s // B),
a bounded waiting buffer, and the BF-IO assignment each step.  Workload
dynamics follow the paper's model (unit KV drift, known-at-admission
prefill sizes, completion at a fixed per-request decode length).

``kv_pool > 0`` adds the host engine's memory-pressure model: per-slot
resident KV is approximated by the absorbed load, and whenever the active
total exceeds the pool, the most recently admitted slot is preempted
(LIFO, recompute model — its absorbed work returns to the wait buffer,
its decode progress is preserved) until the total fits.
``tot_preempts`` counts the evictions, mirroring the host engine's
``preemptions`` stat.

With ``kv_pool == 0`` a step reads nothing back to the host, and on the
card ``run`` replays one CUDA graph of the step ``n_steps`` times over
static ``LoopState`` buffers (the reference runs one jitted ``lax.scan``;
:mod:`repro_torch.core.graphs`), the solve and its K4 launches inside
it; it returns fresh tensors, so no caller's state aliases the buffers a
later call overwrites.  With ``kv_pool > 0`` the steps run eagerly, one
PyTorch op after another: the eviction loop's trip count depends on the
data, so its condition is read on the host once per eviction round (its
capture needs a bounded masked loop or a conditional graph node, ROADMAP
Queue A item 9).

Summation order.  Every float sum follows the reference's order on the
CPU, so a CPU run is bit-identical to the reference's ``run`` and a card
run to a CPU run: the per-worker loads fold each worker's B slots left to
right (slots are worker-major, so this is the reference's slot-order
``segment_sum``); the imbalance and the resident-KV total fold left to
right over workers and slots; the chunked-prefill prefix sum is a left
fold in float32 (``torch.cumsum`` accumulates in float64 on the CPU and
scans in parallel on the card, neither the reference's order).  No sum
uses atomics, so a card run gives the same state every time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.balancer_jax import bfio_assign
from ..core.graphs import Graphs, captures
from ..kernels.bfio_swap import wsum
from ..models import resolve_device

__all__ = ["LoopState", "make_device_serving_loop", "init_loop_state"]


class LoopState(NamedTuple):
    slot_active: torch.Tensor    # (G*B,) bool
    slot_load: torch.Tensor      # (G*B,) f32 current per-step workload
    slot_remaining: torch.Tensor  # (G*B,) i32 decode steps left
    wait_prefill: torch.Tensor   # (W,) f32, 0 = empty entry
    wait_remaining: torch.Tensor  # (W,) i32
    tot_imbalance: torch.Tensor  # () f32
    tot_steps: torch.Tensor      # () i32
    slot_prefill_left: torch.Tensor  # (G*B,) f32 prompt work not yet done
    slot_admit_step: torch.Tensor    # (G*B,) i32 admission step (LIFO key)
    tot_preempts: torch.Tensor   # () i32 memory-pressure evictions


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-d float32 tensor as a left fold."""
    acc = [x[0]]
    for i in range(1, x.shape[0]):
        acc.append(acc[-1] + x[i])
    return torch.stack(acc)


def make_device_serving_loop(G: int, B: int, wait_cap: int,
                             swap_iters: int = 4,
                             prefill_budget: float = 0.0,
                             kv_pool: float = 0.0, *, device=None):
    """Returns ``run(state, n_steps) -> state`` executing the
    admit/decode/complete loop on ``device`` (``cuda`` unless the caller
    passes another; without a card it raises).

    ``prefill_budget > 0`` models chunked prefill (the host engine's
    ``EngineConfig.prefill_chunk``): admitted slots start at zero load
    and absorb at most ``prefill_budget`` prompt tokens per step
    (greedily in flat slot order); a slot decodes only once its prefill
    drains.  ``0`` keeps the seed semantics — the whole prompt lands in
    the admission step.

    ``kv_pool > 0`` models the paged backend's finite block pool (see the
    module doc): LIFO preemption with recompute-on-resume whenever the
    active resident KV exceeds the pool.
    """
    dev = resolve_device(device)
    S = G * B
    chunked = prefill_budget > 0
    pooled = kv_pool > 0
    slot_ids = torch.arange(S, device=dev)
    wait_ids = torch.arange(wait_cap, device=dev)
    workers = torch.arange(G, device=dev)
    dump = torch.full((wait_cap,), S, dtype=torch.long, device=dev)

    def place(state: LoopState, assign: torch.Tensor):
        """Put every admitted candidate in a free slot of its worker.

        The reference scans the W entries in order, each taking the first
        free slot of its worker at that moment.  So the candidate of rank
        r among those assigned to worker g takes the r-th free slot of g
        in flat order at the start of the step, which is computed here
        with prefix counts instead of W rounds."""
        g = assign.long().clamp(min=0)
        placed = assign >= 0
        onehot = ((g[:, None] == workers) & placed[:, None]).int()  # (W, G)
        rank = (onehot.cumsum(0) - onehot).gather(1, g[:, None])[:, 0]
        free = ~state.slot_active.view(G, B)
        fi = free.int()
        ok = placed & (rank < fi.sum(1)[g])
        # owner[g * B + r] = the candidate that takes g's r-th free slot
        owner = torch.full((S + 1,), -1, dtype=torch.long, device=dev)
        owner.scatter_(0, torch.where(ok, g * B + rank, dump), wait_ids)
        free_rank = (fi.cumsum(1) - fi).clamp(max=B - 1)
        cand = torch.where(free, owner[:S].view(G, B).gather(1, free_rank),
                           -1).view(S)
        new = cand >= 0
        c = cand.clamp(min=0)
        wp, wr = state.wait_prefill, state.wait_remaining
        if chunked:
            # admitted slots start empty and absorb their prompt under
            # the per-step budget
            slot_load = torch.where(new, 0.0, state.slot_load)
            pl = torch.where(new, wp[c], state.slot_prefill_left)
        else:
            slot_load = torch.where(new, wp[c], state.slot_load)
            pl = state.slot_prefill_left
        adm = state.slot_admit_step
        if pooled:
            adm = torch.where(new, state.tot_steps, adm)
        return (state.slot_active | new, slot_load,
                torch.where(new, wr[c], state.slot_remaining),
                torch.where(ok, 0.0, wp), torch.where(ok, 0, wr), pl, adm)

    def evict(sa, sl, srem, wp, wr, pl, adm, npre):
        """LIFO preemption until the resident KV fits the pool: one host
        read of the condition per round."""
        while True:
            # resident KV = absorbed tokens only; queued prefill (pl)
            # has not been written anywhere yet
            total = wsum(torch.where(sa, sl, 0.0))
            free_wait = wp <= 0
            if not bool((total > kv_pool) & sa.any() & free_wait.any()):
                return sa, sl, srem, wp, wr, pl, npre
            victim = torch.where(sa, adm, -1).argmax()
            widx = free_wait.int().argmax()      # first free wait entry
            vmask, wmask = slot_ids == victim, wait_ids == widx
            # recompute model: every absorbed token must be redone, so
            # the whole load (plus unfinished prefill) requeues
            v = victim.view(1)
            back = (sl + pl).gather(0, v)
            wp = torch.where(wmask, torch.clamp(back, min=1.0), wp)
            wr = torch.where(wmask, torch.clamp(srem.gather(0, v), min=1),
                             wr)
            sa = sa & ~vmask
            sl = torch.where(vmask, 0.0, sl)
            pl = torch.where(vmask, 0.0, pl)
            npre = npre + 1

    def step(state: LoopState) -> LoopState:
        # --- current loads ------------------------------------------------
        active = state.slot_active
        loads = wsum(torch.where(active, state.slot_load, 0.0).view(G, B))
        counts = active.view(G, B).sum(1, dtype=torch.int32)
        caps = B - counts

        # --- BF-IO admission (H=0; K4 on the card) ------------------------
        valid = state.wait_prefill > 0
        n_admit = torch.minimum(valid.sum(dtype=torch.int32), caps.sum())
        assign = bfio_assign(loads[:, None], caps,
                             state.wait_prefill[:, None], valid, n_admit,
                             swap_iters=swap_iters)            # (W,)
        slot_active, slot_load, slot_rem, wp, wr, pl, adm = place(
            state, assign)

        # --- chunked prefill: drain at most prefill_budget tokens ----------
        if chunked:
            left = torch.where(slot_active, pl, 0.0)
            take = torch.minimum(torch.clamp(
                prefill_budget - (_prefix_sum(left) - left), min=0.0), left)
            pl = pl - take
            slot_load = slot_load + take
            decoding = slot_active & (pl <= 0)
        else:
            decoding = slot_active

        # --- barrier step metrics ------------------------------------------
        loads = wsum(torch.where(slot_active, slot_load, 0.0).view(G, B))
        imb = G * loads.max() - wsum(loads)

        # --- token generation / completion / drift -------------------------
        slot_rem = torch.where(decoding, slot_rem - 1, slot_rem)
        done = decoding & (slot_rem <= 0)
        slot_active = slot_active & ~done
        slot_load = torch.where(
            slot_active,
            torch.where(decoding & ~done, slot_load + 1.0, slot_load), 0.0)

        # --- memory pressure: LIFO preempt until resident KV fits ----------
        n_pre = state.tot_preempts
        if pooled:
            slot_active, slot_load, slot_rem, wp, wr, pl, n_pre = evict(
                slot_active, slot_load, slot_rem, wp, wr, pl, adm, n_pre)

        return LoopState(slot_active, slot_load, slot_rem, wp, wr,
                         state.tot_imbalance + imb, state.tot_steps + 1,
                         pl, adm, n_pre)

    def step_in_place(*fields) -> LoopState:
        """One step over the static state buffers, written back into
        them (the body of the captured step)."""
        new = step(LoopState(*fields))
        for buf, val in zip(fields, new):
            buf.copy_(val)
        return LoopState(*fields)

    graphs = Graphs(dev)

    def run(state: LoopState, n_steps: int) -> LoopState:
        if state.slot_active.device != slot_ids.device:
            raise ValueError(
                f"the loop state lives on {state.slot_active.device}, the "
                f"loop runs on {slot_ids.device}")
        if pooled or n_steps <= 0:
            for _ in range(n_steps):
                state = step(state)
            return state
        if captures(dev):
            out = graphs.run("step", step_in_place, tuple(state),
                             repeat=n_steps)
            return LoopState(*(t.clone() for t in out))
        fields = tuple(t.clone() for t in state)    # the captured body
        for _ in range(n_steps):
            step_in_place(*fields)
        return LoopState(*fields)

    return run


def init_loop_state(G: int, B: int, wait_prefill, wait_remaining,
                    wait_cap: int, *, device=None) -> LoopState:
    """The empty slot table with ``wait_prefill`` / ``wait_remaining``
    queued at the front of a wait buffer of ``wait_cap`` entries, on
    ``device`` (``cuda`` unless the caller passes another)."""
    dev = resolve_device(device)
    S = G * B
    wp_in = np.asarray(wait_prefill, dtype=np.float32)
    wr_in = np.asarray(wait_remaining, dtype=np.int32)
    if len(wp_in) > wait_cap or len(wr_in) > wait_cap:
        raise ValueError(f"{max(len(wp_in), len(wr_in))} waiting requests "
                         f"do not fit a wait buffer of {wait_cap}")
    wp = np.zeros(wait_cap, dtype=np.float32)
    wp[:len(wp_in)] = wp_in
    wr = np.zeros(wait_cap, dtype=np.int32)
    wr[:len(wr_in)] = wr_in
    return LoopState(
        slot_active=torch.zeros(S, dtype=torch.bool, device=dev),
        slot_load=torch.zeros(S, dtype=torch.float32, device=dev),
        slot_remaining=torch.zeros(S, dtype=torch.int32, device=dev),
        wait_prefill=torch.from_numpy(wp).to(dev),
        wait_remaining=torch.from_numpy(wr).to(dev),
        tot_imbalance=torch.zeros((), dtype=torch.float32, device=dev),
        tot_steps=torch.zeros((), dtype=torch.int32, device=dev),
        slot_prefill_left=torch.zeros(S, dtype=torch.float32, device=dev),
        slot_admit_step=torch.full((S,), -1, dtype=torch.int32, device=dev),
        tot_preempts=torch.zeros((), dtype=torch.int32, device=dev),
    )
