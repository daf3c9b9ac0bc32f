"""Admission scheduler: wait queue, routing, and the chunked-prefill
budget.

The engine's barrier step used to own all of this inline; it is now a
seam so admission *policy* (what the router decides) and admission
*mechanics* (when prefill work actually runs) can evolve independently of
the engine and of the cache layout.

:class:`Scheduler` owns

* the **wait queue** (arrival order preserved — candidate indices handed
  to routing policies are queue positions);
* **admission**: build nothing itself — the engine constructs the
  :class:`~repro_torch.core.policies.SchedulerContext` (it owns the slot
  arrays) and the scheduler runs the policy, caps the assignment to free
  capacity (:func:`~repro_torch.serving.slot_table.cap_assignment`), and
  removes the admitted requests from the queue;
* **chunked prefill** bookkeeping: admitted requests become
  :class:`PrefillJob`\\ s that are advanced at most ``chunk`` tokens per
  job and ``budget`` tokens per barrier step (FCFS in admission order),
  so one admission wave never runs its whole prompt volume inside a
  single step — prefill chunks interleave with decode instead of
  stalling it.

The chunk-budget knob
---------------------
``EngineConfig.prefill_chunk = 0`` (default) keeps the synchronous seed
semantics: a request's entire (padded) prompt is prefilled in its
admission step.  With ``prefill_chunk = c > 0`` each job advances at most
``c`` prompt tokens per step, and ``prefill_budget`` (default ``c``)
bounds the *total* prompt tokens processed per step across jobs — the
knob that trades time-to-first-token against the decode stall: per-step
wall time is bounded by one decode plus ``budget`` prefill tokens,
instead of one decode plus an entire admission wave.  Policies observe
in-flight jobs via ``SchedulerContext.active_prefill_remaining``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.policies import Policy, SchedulerContext
from .preemption import LIFOPreemption, PreemptContext, PreemptionPolicy
from .slot_table import cap_assignment

__all__ = ["PrefillJob", "Scheduler"]


@dataclasses.dataclass
class PrefillJob:
    """A mid-prefill request occupying a slot.

    ``resume_token`` is set for recompute-on-resume prefills (the request
    was preempted while decoding and its KV is being rebuilt): when the
    job finishes, the engine feeds this preserved token back into decode
    instead of sampling a fresh first token from the prefill logits —
    the request already generated it before the preemption.
    ``resume_length`` preserves the victim's KV length when it exceeded
    what the rebuilt (``max_seq_len``-truncated) token sequence covers —
    a request that decoded past the cap on frozen KV must keep its RoPE
    position counter, not restart it at the cap.  ``seeded`` is the
    prefix-cache hit offset the job started at (those tokens were pinned
    copy-free, never computed — recompute accounting must not charge
    them).
    """

    req: object                  # ServeRequest
    tokens: np.ndarray           # prompt (already truncated to max_seq_len)
    done: int = 0                # tokens prefilled so far
    seeded: int = 0              # leading tokens covered by prefix hits
    resume_token: Optional[int] = None
    resume_length: Optional[int] = None

    @property
    def total(self) -> int:
        return len(self.tokens)

    @property
    def remaining(self) -> int:
        return self.total - self.done


class Scheduler:
    """Wait queue + admission + chunked-prefill budget + victim selection
    under memory pressure (see module doc)."""

    def __init__(self, policy: Policy, *, prefill_chunk: int = 0,
                 prefill_budget: int = 0,
                 preemption: Optional[PreemptionPolicy] = None):
        self.policy = policy
        self.chunk = int(prefill_chunk)
        self.budget = int(prefill_budget) or self.chunk
        self.preemption = preemption or LIFOPreemption()
        self.wait: list = []
        self._jobs: dict[int, PrefillJob] = {}   # slot -> job, FCFS order

    @property
    def chunked(self) -> bool:
        return self.chunk > 0

    @property
    def n_prefilling(self) -> int:
        return len(self._jobs)

    # -- queue ----------------------------------------------------------
    def submit(self, req) -> None:
        self.wait.append(req)

    def requeue(self, req) -> None:
        """Return a preempted request to the *front* of the wait queue:
        it was admitted once already, so it outranks everything that
        arrived after it (the vLLM recompute-preemption discipline)."""
        self.wait.insert(0, req)

    # -- admission ------------------------------------------------------
    def admit(self, ctx: SchedulerContext, caps: np.ndarray, *,
              block_budget: Optional[int] = None,
              blocks_of: Optional[Callable] = None) -> list:
        """Run the routing policy and return [(req, worker), ...] for the
        admitted requests (removed from the queue).  A policy may
        over-subscribe a worker beyond its free slots; the excess requests
        simply keep waiting instead of crashing placement.

        ``block_budget``/``blocks_of`` gate admission on KV-pool capacity
        (paged backend): requests are admitted in assignment order only
        while their cumulative block demand fits the budget, and the gate
        is *strict FCFS* — the first request that does not fit stops
        admission for the step (no head-of-line bypass), so an oversized
        pool-pressure wave degrades to waiting instead of to a
        ``MemoryError`` mid-prefill."""
        assignment = cap_assignment(
            np.asarray(self.policy.assign(ctx)), caps)
        to_admit = []
        left = block_budget
        for pos, g in enumerate(assignment):
            if g < 0:
                continue
            req = self.wait[pos]
            if left is not None:
                need = blocks_of(req)
                if need > left:
                    break
                left -= need
            to_admit.append((req, int(g)))
        if to_admit:
            admitted = {id(r) for r, _ in to_admit}
            self.wait = [r for r in self.wait if id(r) not in admitted]
        return to_admit

    # -- memory pressure ------------------------------------------------
    def select_victim(self, ctx: PreemptContext) -> Optional[int]:
        """Pick the active slot to preempt (None if no candidates)."""
        if ctx.slots.size == 0:
            return None
        return self.preemption.select(ctx)

    # -- chunked prefill ------------------------------------------------
    def register_job(self, slot: int, req, tokens: np.ndarray, *,
                     done: int = 0, seeded: int = 0,
                     resume_token: Optional[int] = None,
                     resume_length: Optional[int] = None) -> None:
        """Track a mid-prefill request on ``slot``.  ``done`` resumes a
        preempted-and-swapped-back job at its old offset; ``seeded``
        marks how much of ``done`` came from prefix-cache pins rather
        than compute; ``resume_token``/``resume_length`` mark a
        recompute-on-resume prefill (see :class:`PrefillJob`)."""
        self._jobs[int(slot)] = PrefillJob(req=req, tokens=tokens,
                                           done=int(done),
                                           seeded=int(seeded),
                                           resume_token=resume_token,
                                           resume_length=resume_length)

    def job(self, slot: int) -> Optional[PrefillJob]:
        return self._jobs.get(int(slot))

    def drop_job(self, slot: int) -> Optional[PrefillJob]:
        """Remove and return the job on ``slot`` (victim preempted or
        request finished mid-prefill); None if the slot has no job."""
        return self._jobs.pop(int(slot), None)

    def plan_chunks(self) -> list[tuple[int, int, int]]:
        """Pick this step's chunk work: [(slot, offset, n_tokens), ...],
        FCFS in admission order, each job capped at ``chunk`` tokens and
        the step capped at ``budget`` tokens total.  Advancing ``done``
        is the caller's job (after the compute succeeds)."""
        out = []
        left = self.budget
        for slot, job in self._jobs.items():
            if left <= 0:
                break
            n = min(self.chunk, job.remaining, left)
            if n <= 0:
                continue
            out.append((slot, job.done, n))
            left -= n
        return out

    def advance(self, slot: int, n: int) -> bool:
        """Record ``n`` prefilled tokens for the job on ``slot``; returns
        True (and drops the job) when its prompt is fully prefilled."""
        job = self._jobs[int(slot)]
        job.done += n
        if job.done >= job.total:
            del self._jobs[int(slot)]
            return True
        return False
