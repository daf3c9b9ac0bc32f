"""Multi-worker decode serving engine with pluggable routing, cache
layout, and admission scheduling (PyTorch port of the reference engine).

This is the paper's system diagram (Fig. 3) as a runnable engine:

  * G decode workers (the DP shards), each with B KV-cache slots;
  * prefill produces a request's cache entry; the *router* (FCFS / JSQ /
    BF-IO / ...) assigns it to a worker — sticky thereafter;
  * every engine step decodes ONE token for all active requests on all
    workers (the barrier-synchronized step), with per-worker wall-time
    modeled as ``c + t_token * L_g`` and the step gated by max_g L_g;
  * completions free slots; the router refills them from the wait queue.

The workers share one model on one device and the per-worker batches are
stacked; the router's decision problem is *identical* to a sharded
deployment — that is the point of the paper.

``ServingEngine.step()`` is a thin driver over two seams:

* :class:`~repro_torch.serving.scheduler.Scheduler` — wait queue,
  admission, and the chunked-prefill budget (``EngineConfig.
  prefill_chunk`` / ``prefill_budget``).
* :class:`~repro_torch.serving.cache_backend.CacheBackend` — the memory
  layout (``EngineConfig.cache_backend``): ``"slot"`` is the contiguous
  per-slot layout (every ported family; decode runs the contiguous
  decode-attention kernel), ``"paged"`` vLLM-style block paging whose
  decode runs the paged-attention kernel (attention-family models only).
* ``EngineConfig.engine_mode``: ``"vec"`` (default) is the array hot
  path over the shared :class:`~repro_torch.serving.slot_table.SlotTable`;
  ``"ref"`` is the reference's per-slot Python loops, per-request cache
  writes and full-batch decode of all G*B slots every step, kept as the
  oracle the vec path is held to (slot backend, synchronous prefill
  only).

The engine's time and energy are MODELLED, exactly as in the reference:
``step_overhead + t_token * max load`` priced under ``EngineConfig.
power``.  ``stats()`` reports those modelled numbers on every device; a
measured wall-clock time must be taken around :meth:`run` by the caller.

On the paged backend the engine also drives the memory-pressure
subsystem (:mod:`repro_torch.serving.preemption`): admission is gated on
free pool blocks, every growth path pre-declares its block demand and
victims are preempted — swapped host-side or dropped for
recompute-on-resume — until it fits, and ``EngineConfig.prefix_cache``
shares identical prompt-prefix blocks across concurrent requests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.energy import A100_POWER, PowerModel
from ..core.metrics import step_imbalance
from ..core.policies import Policy, SchedulerContext
from ..core.workload import DriftModel, drift_for_family
from ..models import (
    prefill_fn,
    resolve_device,
    supports_paged_stack,
    torch_dtype,
)
from ..obs.trace import NULL_RECORDER
from .cache_backend import make_cache_backend
from .preemption import (
    PreemptContext,
    PreemptedState,
    make_preemption_policy,
)
from .scheduler import Scheduler
from .slot_table import SlotTable

__all__ = ["ServeRequest", "EngineConfig", "ServingEngine"]


@dataclasses.dataclass
class ServeRequest:
    rid: int
    tokens: np.ndarray              # prompt token ids
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: never stops early
    # filled by the engine:
    worker: int = -1
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = float("nan")
    t_finish: float = float("nan")
    # per-request completion/error channel: "queued" -> "active" ->
    # "done" | "failed" (a preempted request returns to "queued").  A
    # failure (``error`` set) is terminal for THIS request only — the
    # engine keeps serving the rest of the stream; callers (and the
    # fleet router) read ``status``/``error`` instead of catching
    # engine-wide exceptions.
    status: str = "queued"
    error: Optional[str] = None
    # set while the request sits preempted in the wait queue (swap-staged
    # KV or recompute bookkeeping, see serving/preemption.py); None once
    # (re-)admitted
    preempted: Optional[PreemptedState] = None
    # memoized chained content-hash triples of the full prompt, keyed by
    # block size: the fleet's prefix-affinity probe computes the chain
    # at routing and admission reuses it instead of re-hashing
    # (PrefixIndex.keys_for); valid because `tokens` is immutable after
    # submission
    prefix_keys: dict = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> bool:
        return not np.isnan(self.t_finish)

    @property
    def failed(self) -> bool:
        return self.error is not None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_workers: int = 4              # G
    slots_per_worker: int = 8       # B
    max_seq_len: int = 256
    prefill_pad: int = 64           # prompts padded to this for prefill
    step_overhead: float = 9.775e-3
    t_token: float = 1.005e-7
    power: PowerModel = A100_POWER
    greedy: bool = True             # greedy sampling
    engine_mode: str = "vec"        # "vec" (array hot path) | "ref" (seed)
    cache_backend: str = "slot"     # "slot" (contiguous) | "paged" (vLLM)
    # chunked prefill: 0 = synchronous (a request's whole prompt prefills
    # in its admission step); c > 0 = at most c prompt tokens per job per
    # step, interleaved with decode.  Setting only prefill_budget also
    # turns chunking on, with chunk == budget.
    prefill_chunk: int = 0
    prefill_budget: int = 0         # total prompt tokens/step (0 -> chunk)
    # paged-backend knobs
    paged_block_size: int = 16      # tokens per KV block (divides max_seq)
    paged_pool_blocks: int = 0      # 0 -> capacity for all slots at max_seq
    # "kernel" (default): the Hopper paged-attention kernel for a CUDA
    # pool, its plain version for a CPU pool — the main path on the card
    # must run the kernel, so the kernel is the default; "gather" and
    # "ref" are the reference's oracles, kept for parity checks
    paged_attn_impl: str = "kernel"  # "kernel" | "gather" | "ref"
    # memory pressure (paged backend): when the block pool cannot serve a
    # growth/admission request, a victim is preempted instead of raising
    # MemoryError.  "swap" stages the victim's blocks host-side and
    # restores them bit-for-bit on resume; "recompute" drops them and
    # re-prefills prompt + generated tokens through the (chunked) prefill
    # path.  The victim re-enters the wait queue at the front with its
    # generated tokens preserved.  preemption_policy picks the victim
    # ("lifo" default / "fifo" / "largest", see serving/preemption.py).
    preemption_mode: str = "swap"   # "swap" | "recompute"
    preemption_policy: str = "lifo"
    # prefix caching (paged backend): share identical prompt-prefix KV
    # blocks across requests via a content-hash index, copy-on-write on
    # the first divergent append.  Chunked admissions consult the index
    # too: leading full-block hits are pinned copy-free and the chunk
    # job starts past them, skipping recompute of the hit prefix.
    prefix_cache: bool = False
    # eviction lifetime of the prefix index: "lru" (default) retains
    # refcount-0 indexed blocks on an LRU cached list, reclaimed only
    # when the free list runs dry — hits survive their last resident
    # holder (multi-turn sessions); "admission" is the legacy scope:
    # entries die with the last holder's release.
    prefix_evict: str = "lru"


def _decode_buckets(N: int) -> list[int]:
    """Sub-batch sizes the compact decode path may run at.  A small
    geometric ladder (the reference's, which bounds its jit recompiles)
    keeps the drain-phase decode cost proportional to the active count."""
    buckets = {N}
    b = N
    while b > 4:
        b = max(4, (b + 3) // 4)
        buckets.add(b)
    return sorted(buckets)


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """One engine's load state as seen by a fleet router — the public
    seam between :class:`ServingEngine` and the fleet layer, so routing
    and per-step fleet bookkeeping never reach into engine internals
    (``_loads()``, ``_req_cost()``, ``scheduler.wait``)."""

    resident_load: float   # sum of per-worker resident KV loads
    wait_cost: float       # summed prefill-size proxy of waiting requests
    active: int            # occupied slots
    waiting: int           # requests queued at this engine
    free_slots: int        # N - active
    tokens_out: int        # cumulative generated tokens
    preemptions: int       # cumulative preemption count
    prefix_hits: int       # cumulative prefix-cache hits
    prefix_cached_blocks: int = 0   # refcount-0 blocks on the LRU list
    prefix_revived: int = 0         # cumulative cached-block revivals

    @property
    def committed_load(self) -> float:
        """Resident plus queued load — what a router should balance."""
        return self.resident_load + self.wait_cost

    @property
    def committed_count(self) -> int:
        return self.active + self.waiting

    @property
    def busy(self) -> bool:
        return self.active > 0 or self.waiting > 0


class ServingEngine:
    """Continuous-batching decode engine over G logical workers."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 policy: Policy, *, device=None, drift: DriftModel = None,
                 obs=None, obs_replica: int = 0):
        """``device`` is ``cuda`` unless the caller passes another (the
        tests pass ``"cpu"``); ``params`` must already live there."""
        ec = engine_cfg
        if ec.engine_mode not in ("vec", "ref"):
            raise ValueError(
                f"engine_mode must be 'vec' or 'ref', got "
                f"{ec.engine_mode!r}")
        # a budget alone turns chunking on (one chunk == the budget)
        chunk = ec.prefill_chunk or ec.prefill_budget
        if ec.engine_mode == "ref" and (ec.cache_backend != "slot"
                                        or chunk):
            raise ValueError(
                "engine_mode='ref' is the seed oracle: it supports only "
                "cache_backend='slot' with synchronous prefill")
        if chunk and (cfg.family not in ("dense", "moe")
                      or not supports_paged_stack(cfg)):
            raise ValueError(
                "chunked prefill needs a homogeneous attention decoder "
                "without a sliding window whose prompt embeds tokens "
                f"only (dense/moe); got family={cfg.family!r} "
                f"sliding_window={cfg.sliding_window}")
        if ec.preemption_mode not in ("swap", "recompute"):
            raise ValueError(
                f"preemption_mode must be 'swap' or 'recompute', got "
                f"{ec.preemption_mode!r}")
        if ec.prefix_cache and ec.cache_backend != "paged":
            raise ValueError(
                "prefix_cache=True needs cache_backend='paged' (the "
                "contiguous slot layout has no shareable blocks)")
        if ec.prefix_evict not in ("lru", "admission"):
            raise ValueError(
                f"prefix_evict must be 'lru' or 'admission', got "
                f"{ec.prefix_evict!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs "
                f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ec = ec
        self.policy = policy
        self.drift = drift or drift_for_family(cfg.family)
        G, B = ec.n_workers, ec.slots_per_worker
        self.G, self.B = G, B
        N = G * B
        self.N = N
        self.backend = make_cache_backend(ec.cache_backend, cfg, params,
                                          ec, self.device)
        self._paged = ec.cache_backend == "paged"
        self.scheduler = Scheduler(
            policy, prefill_chunk=min(chunk, ec.max_seq_len),
            prefill_budget=ec.prefill_budget,
            preemption=make_preemption_policy(ec.preemption_policy))
        self.table = SlotTable(G, B)
        self.slot_req: list[Optional[ServeRequest]] = [None] * N
        self.slot_tokens = np.zeros(N, dtype=np.int32)   # next input token
        self.slot_load = self.table.load                 # workload proxy
        # vec-mode per-slot request scalars (mirrors of the ServeRequest
        # fields the scheduler context needs, so ctx build is one gather)
        self.slot_age = np.zeros(N, dtype=np.int64)      # len(generated)
        self.slot_max_new = np.zeros(N, dtype=np.int64)
        self.slot_eos = np.full(N, -1, dtype=np.int64)
        # monotonic admission order per slot (LIFO victim selection)
        self.slot_admit_seq = np.zeros(N, dtype=np.int64)
        self._admit_seq = 0
        self.t_now = 0.0
        self.steps = 0
        self.energy_j = 0.0
        self.imbalance_sum = 0.0
        self.tokens_out = 0
        self.kv_peak_bytes = 0
        # memory-pressure accounting (paged backend)
        self.requests_failed = 0
        self.preemptions = 0
        self.tokens_swapped = 0      # KV tokens staged host-side
        self.tokens_recomputed = 0   # KV tokens dropped for re-prefill
        self.rng = np.random.default_rng(0)
        # span recorder (repro.obs): NULL_RECORDER is a no-op, so an
        # untraced run buffers nothing and stays bit-identical;
        # obs_replica is this engine's trace track (fleet replica id)
        self._obs_rec = obs if obs is not None else NULL_RECORDER
        self._obs_replica = int(obs_replica)

        self._buckets = _decode_buckets(N)

    # ------------------------------------------------------------------
    @property
    def cache(self):
        """The slot backend's flat cache tree (test access); the paged
        backend holds pools instead."""
        return self.backend.cache

    @cache.setter
    def cache(self, value):
        self.backend.cache = value

    @property
    def wait(self) -> list:
        return self.scheduler.wait

    def submit(self, req: ServeRequest) -> None:
        """Queue a request.  On the paged backend, a prompt whose KV can
        never fit the block pool — even with every other request
        preempted — is rejected here instead of surfacing as a
        ``MemoryError`` (or an admission livelock) mid-prefill."""
        if self._paged:
            L = min(len(req.tokens), self.ec.max_seq_len)
            need = self.backend.blocks_for(L)
            if need > self.backend.n_blocks:
                raise ValueError(
                    f"request {req.rid}: prompt of {L} tokens needs "
                    f"{need} KV blocks but the pool holds only "
                    f"{self.backend.n_blocks} "
                    f"(block_size={self.backend.block_size}) — it can "
                    "never be admitted")
        req.t_submit = self.t_now
        req.status = "queued"
        if self._obs_rec.enabled:
            self._obs_rec.point(self._obs_replica, req.rid, "queued",
                                self.t_now, n_prompt=len(req.tokens))
        self.scheduler.submit(req)

    def _worker_of(self, slot: int) -> int:
        return slot // self.B

    def _loads(self) -> np.ndarray:
        if self.ec.engine_mode == "vec":
            return self.table.loads()
        loads = np.zeros(self.G)
        for s, r in enumerate(self.slot_req):
            if r is not None:
                loads[self._worker_of(s)] += self.slot_load[s]
        return loads

    def _counts(self) -> np.ndarray:
        if self.ec.engine_mode == "vec":
            return self.table.counts()
        counts = np.zeros(self.G, dtype=np.int64)
        for s, r in enumerate(self.slot_req):
            if r is not None:
                counts[self._worker_of(s)] += 1
        return counts

    def load_snapshot(self) -> LoadSnapshot:
        """Cheap public summary of this engine's load state (see
        :class:`LoadSnapshot`).  Both fleet modes route and account from
        these values, which keeps ``fleet_mode="ref"`` and ``"vec"``
        bit-identical: identical inputs feed identical arithmetic."""
        wait = self.wait
        active = int(self.table.active.sum())
        prefix = getattr(self.backend, "prefix", None)
        alloc = getattr(getattr(self.backend, "kv", None),
                        "allocator", None)
        return LoadSnapshot(
            resident_load=float(self._loads().sum()),
            wait_cost=float(sum(self._req_cost(r) for r in wait)),
            active=active,
            waiting=len(wait),
            free_slots=self.N - active,
            tokens_out=self.tokens_out,
            preemptions=self.preemptions,
            prefix_hits=prefix.hits if prefix is not None else 0,
            prefix_cached_blocks=alloc.n_cached if alloc else 0,
            prefix_revived=alloc.blocks_revived if alloc else 0,
        )

    # ------------------------------------------------------------------
    def _admit_tokens(self, r: "ServeRequest") -> np.ndarray:
        """Token sequence a (re-)admission must prefill: the truncated
        prompt, or — for a recompute-on-resume request — the prompt plus
        every generated token except the last (which is the pending
        decode input, preserved in ``r.preempted.next_token``)."""
        prompt = np.asarray(r.tokens, dtype=np.int64)[:self.ec.max_seq_len]
        if r.preempted is not None:
            toks = np.concatenate(
                [prompt, np.asarray(r.generated[:-1], dtype=np.int64)])
            return toks[:self.ec.max_seq_len].astype(np.int32)
        return prompt.astype(np.int32)

    def _admit_len(self, r: "ServeRequest") -> int:
        """len(:meth:`_admit_tokens`) without materializing the array —
        called per waiting request per admission step (block gating)."""
        L = min(len(r.tokens), self.ec.max_seq_len)
        if r.preempted is not None:
            L = min(L + max(len(r.generated) - 1, 0),
                    self.ec.max_seq_len)
        return L

    def _req_cost(self, r: "ServeRequest") -> float:
        """Prefill-size proxy a routing policy sees for a waiting
        request (resumed victims bring their resident KV length)."""
        if r.preempted is not None:
            return float(r.preempted.length)
        return float(len(r.tokens))

    def _blocks_needed(self, r: "ServeRequest") -> int:
        """KV blocks admission must be able to allocate for ``r``."""
        if r.preempted is not None and r.preempted.mode == "swap":
            return r.preempted.n_blocks
        return self.backend.blocks_for(self._admit_len(r))

    def _prefix_chain(self, r: "ServeRequest", toks) -> Optional[list]:
        """Memoized chained content-hash triples for an admission's
        token sequence, shared with the fleet's prefix-affinity probe
        via ``ServeRequest.prefix_keys`` — the probe hashes the prompt
        at routing and admission reuses the chain instead of re-hashing
        it.  Only a full untruncated prompt is cacheable (resume
        sequences and truncations hash different content); those fall
        back to ``keys_for`` inside the backend (chain=None)."""
        prefix = getattr(self.backend, "prefix", None)
        if prefix is None or len(toks) != len(r.tokens):
            return None
        bs = int(self.backend.block_size)
        chain = r.prefix_keys.get(bs)
        if chain is None:
            chain = prefix.keys_for(toks, bs)
            r.prefix_keys[bs] = chain
        return chain

    def _admit(self) -> tuple[int, int]:
        """Router step: assign waiting requests to free slots; returns
        ``(fresh, resumed)`` admission counts (the step-phase signal the
        straggler attribution classifies barrier slack by)."""
        if not self.wait:
            return 0, 0
        counts = self._counts()
        caps = self.B - counts
        if caps.sum() <= 0:
            return 0, 0
        loads = self._loads()
        if self.ec.engine_mode == "vec":
            act_idx = self.table.active_indices()
            active_worker = self.table.worker[act_idx]
            active_w = self.table.load[act_idx]
            active_age = self.slot_age[act_idx]
            active_remaining = np.maximum(
                self.slot_max_new[act_idx] - active_age, 1)
            prefill_remaining = self.table.prefill_left[act_idx]
        else:
            act = [(s, r) for s, r in enumerate(self.slot_req)
                   if r is not None]
            active_worker = np.array([self._worker_of(s) for s, _ in act],
                                     dtype=np.int64)
            active_w = np.array([self.slot_load[s] for s, _ in act])
            active_age = np.array([len(r.generated) for _, r in act],
                                  dtype=np.int64)
            active_remaining = np.array(
                [max(r.max_new_tokens - len(r.generated), 1)
                 for _, r in act], dtype=np.int64)
            prefill_remaining = np.zeros(len(act), dtype=np.int64)
        ctx = SchedulerContext(
            k=self.steps,
            loads=loads,
            counts=counts,
            caps=caps.astype(np.int64),
            wait_prefill=np.array([self._req_cost(r) for r in self.wait],
                                  dtype=np.float64),
            active_worker=active_worker,
            active_w=active_w,
            active_age=active_age,
            active_remaining=active_remaining,
            drift=self.drift,
            rng=self.rng,
            active_prefill_remaining=prefill_remaining,
        )
        gate = {}
        if self._paged:
            # admit only what the pool can hold after reserving this
            # step's decode growth — admission itself never preempts, so
            # a wave larger than the free pool degrades to waiting
            budget = (self.backend.free_blocks
                      - self.backend.decode_block_demand(
                          self.table.decode_indices()))
            gate = dict(block_budget=max(int(budget), 0),
                        blocks_of=self._blocks_needed)
        to_admit = self.scheduler.admit(ctx, caps, **gate)
        if not to_admit:
            return 0, 0
        resumed = [(r, g) for r, g in to_admit
                   if r.preempted is not None
                   and r.preempted.mode == "swap"]
        fresh = [(r, g) for r, g in to_admit
                 if r.preempted is None or r.preempted.mode != "swap"]
        if resumed:
            self._resume_swapped(resumed)
        if not fresh:
            return 0, len(resumed)
        if self.scheduler.chunked:
            # empty prompts have no chunk work to schedule; the
            # synchronous path already handles them (prefill over an
            # all-padding row), so route them there
            empty = [(r, g) for r, g in fresh if self._admit_len(r) == 0]
            chunked = [(r, g) for r, g in fresh if self._admit_len(r) > 0]
            if chunked:
                self._admit_chunked(chunked)
            if empty:
                self._prefill_batch(empty)
        else:
            self._prefill_batch(fresh)
        return len(fresh), len(resumed)

    def _admit_chunked(self, items: list[tuple["ServeRequest", int]]) -> None:
        """Chunked admission: claim slots and register prefill jobs; no
        model work happens here — chunks run under the per-step budget.
        Recompute-on-resume requests re-prefill prompt + generated tokens
        with their pending decode token carried on the job.  With the
        prefix cache on, a fresh prompt's leading full-block hits are
        pinned copy-free and the job starts *past* them
        (``CacheBackend.seed_chunk_prefix``) — the hit prefix is neither
        re-stored nor recomputed."""
        workers = np.array([g for _, g in items], dtype=np.int64)
        slots = self.table.allocate(workers)
        for i, (r, g) in enumerate(items):
            slot = int(slots[i])
            # first admission of this request?  A preempt-restarted job
            # re-seeds below, but re-counting its lookup would
            # double-count the admission in the hit-rate denominators
            first_admit = int(r.slot) < 0
            r.worker, r.slot = g, slot
            r.status = "active"
            self.slot_req[slot] = r
            self.slot_age[slot] = 0
            self.slot_max_new[slot] = r.max_new_tokens
            self.slot_eos[slot] = r.eos_id
            self.slot_admit_seq[slot] = self._admit_seq
            self._admit_seq += 1
            toks = self._admit_tokens(r)
            resume_token = resume_length = None
            done = 0
            if r.preempted is not None:
                resume_token = int(r.preempted.next_token)
                resume_length = int(r.preempted.length)
                r.preempted = None
                if self._obs_rec.enabled:
                    self._obs_rec.point(self._obs_replica, r.rid,
                                        "resumed", self.t_now,
                                        slot=slot, mode="recompute")
            elif self._paged and self.backend.prefix is not None:
                done = self.backend.seed_chunk_prefix(
                    slot, toks, count=first_admit,
                    chain=self._prefix_chain(r, toks))
            if self._obs_rec.enabled and resume_token is None:
                self._obs_rec.point(self._obs_replica, r.rid,
                                    "admitted", self.t_now,
                                    worker=g, slot=slot, seeded=done)
            self.slot_load[slot] = float(done)
            self.table.prefill_left[slot] = len(toks) - done
            self.scheduler.register_job(slot, r, toks, done=done,
                                        seeded=done,
                                        resume_token=resume_token,
                                        resume_length=resume_length)

    def _resume_swapped(self, items: list[tuple["ServeRequest", int]]) -> None:
        """Re-admit swap-preempted requests: claim a slot, restore the
        host-staged KV blocks bit-for-bit, and continue exactly where the
        victim stopped — decoding from its pending token, or its chunked
        prefill job at the preserved offset.  No model work runs here."""
        workers = np.array([g for _, g in items], dtype=np.int64)
        slots = self.table.allocate(workers)
        for i, (r, g) in enumerate(items):
            slot = int(slots[i])
            st = r.preempted
            self.backend.swap_in(slot, st)
            if self._obs_rec.enabled:
                self._obs_rec.point(self._obs_replica, r.rid, "resumed",
                                    self.t_now, slot=slot, mode="swap")
            r.worker, r.slot = g, slot
            r.status = "active"
            self.slot_req[slot] = r
            self.slot_max_new[slot] = r.max_new_tokens
            self.slot_eos[slot] = r.eos_id
            self.slot_admit_seq[slot] = self._admit_seq
            self._admit_seq += 1
            if st.prefill_done >= 0:      # victim was mid-prefill
                self.slot_load[slot] = float(st.prefill_done)
                self.slot_age[slot] = 0
                self.table.prefill_left[slot] = \
                    len(st.prefill_tokens) - st.prefill_done
                self.scheduler.register_job(
                    slot, r, st.prefill_tokens, done=st.prefill_done,
                    resume_token=st.resume_token,
                    resume_length=st.resume_length)
            else:                         # victim was decoding
                self.slot_load[slot] = float(st.length)
                self.slot_tokens[slot] = int(st.next_token)
                self.slot_age[slot] = len(r.generated)
            r.preempted = None

    # -- memory pressure ------------------------------------------------
    def _preempt_one(self) -> bool:
        """Free pool capacity by preempting one victim (chosen by the
        scheduler's preemption policy); False when no active request is
        left to preempt."""
        cand = self.table.active_indices()
        if cand.size == 0:
            return False
        kv = self.backend.kv
        ctx = PreemptContext(
            slots=cand,
            admit_seq=self.slot_admit_seq[cand],
            kv_tokens=kv.lengths[cand].astype(np.int64),
            blocks_held=np.array(
                [len(kv.req_blocks.get(int(s), [])) for s in cand],
                dtype=np.int64),
            prefilling=self.table.prefill_left[cand] > 0)
        victim = self.scheduler.select_victim(ctx)
        if victim is None:
            return False
        self._preempt_slot(int(victim))
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Evict the request on ``slot``: swap its KV host-side or drop
        it for recompute, preserve the generated tokens, and requeue the
        request at the front of the wait queue."""
        r = self.slot_req[slot]
        job = self.scheduler.drop_job(slot)
        L = int(self.backend.kv.lengths[slot])
        if self.ec.preemption_mode == "swap":
            state = self.backend.swap_out(slot)
            self.tokens_swapped += L
            if job is not None:           # mid-prefill: resume the job
                state.prefill_done = job.done
                state.prefill_tokens = job.tokens
                state.resume_token = job.resume_token
                state.resume_length = job.resume_length
            else:
                state.next_token = int(self.slot_tokens[slot])
            r.preempted = state
        else:
            self.backend.discard(slot)
            # seeded prefix tokens were pinned copy-free, never computed
            # — dropping them forces no recompute
            self.tokens_recomputed += (job.done - job.seeded) \
                if job is not None else L
            if job is not None and job.resume_token is None:
                r.preempted = None        # plain prompt: restart prefill
            elif job is not None:         # re-preempted mid-rebuild
                r.preempted = PreemptedState(
                    mode="recompute",
                    length=job.resume_length or len(job.tokens),
                    next_token=int(job.resume_token))
            else:
                r.preempted = PreemptedState(
                    mode="recompute", length=L,
                    next_token=int(self.slot_tokens[slot]))
        self.slot_req[slot] = None
        self.table.release(np.asarray([slot]))
        r.status = "queued"
        self.scheduler.requeue(r)
        self.preemptions += 1
        if self._obs_rec.enabled:
            self._obs_rec.point(self._obs_replica, r.rid, "preempted",
                                self.t_now, slot=slot,
                                mode=self.ec.preemption_mode)

    def drain(self) -> list:
        """Evict everything this engine holds for fleet-tier re-routing
        (the async fleet's scale-down path): every paged resident is
        preempted through the configured preemption path — ``"swap"``
        stages its KV host-side so the receiving replica restores it
        bit-for-bit — then the wait queue is handed off in order.
        Residents leave in admission order so the handoff sequence is
        deterministic.  The slot backend has no swap machinery, so its
        drain hands off only queued work and residents finish in place.
        Returns the evicted requests, oldest first."""
        handoff = []
        if self._paged:
            order = self.table.active_indices()
            order = order[np.argsort(self.slot_admit_seq[order],
                                     kind="stable")]
            for slot in order:
                handoff.append(self._free(int(slot)))
        while self.scheduler.wait:
            handoff.append(self.scheduler.wait.pop(0))
        return handoff

    def _free(self, slot: int) -> "ServeRequest":
        """Drain-path eviction of one resident: the preempt path stages
        its KV (swap mode) and releases the pool blocks, then the victim
        is popped straight back off the wait queue (``requeue``
        front-inserts it) so the caller can hand it to another
        replica."""
        self._preempt_slot(slot)
        return self.scheduler.wait.pop(0)

    def _fail_slot(self, slot: int, msg: str) -> None:
        """Per-request failure channel: mark the request on ``slot``
        failed (``status``/``error``), release its slot and KV, and keep
        the rest of the stream serving.  The seed engine raised here and
        killed the whole step; a fleet router needs the error surfaced
        per request so one doomed request cannot take down its replica."""
        r = self.slot_req[slot]
        self.scheduler.drop_job(slot)
        r.error = msg
        r.status = "failed"
        r.t_finish = self.t_now
        r.preempted = None
        self.slot_req[slot] = None
        self.table.release(np.asarray([slot]))
        self.backend.release(np.asarray([slot]))
        self.requests_failed += 1
        if self._obs_rec.enabled:
            self._obs_rec.point(self._obs_replica, r.rid, "failed",
                                self.t_now)

    def _ensure_decode_capacity(self) -> None:
        """Preempt until the pool can serve this step's decode growth
        (boundary crossings + copy-on-write blocks).  Preempting shrinks
        the decode set, so demand is recomputed after every victim.

        A slot already holding the *entire* pool that still needs to
        grow can never be served — preempting it would only requeue it
        into an identical dead end (admit, grow back, self-preempt,
        repeat until ``max_steps``).  That request alone *fails*
        (``status="failed"``, ``error`` set, KV released) and everything
        else keeps serving — the seed raised ``MemoryError`` here and
        killed the engine step."""
        kv = self.backend.kv
        while True:
            decode_idx = self.table.decode_indices()
            need = self.backend.decode_block_demand(decode_idx)
            if need <= self.backend.free_blocks:
                return
            failed_one = False
            for s in decode_idx:
                s = int(s)
                held = len(kv.req_blocks.get(s, []))
                if (held + 1 > self.backend.n_blocks
                        and kv.append_demand(np.asarray([s])) > 0):
                    r = self.slot_req[s]
                    self._fail_slot(s, (
                        f"request {r.rid}: resident KV ({held} blocks) "
                        f"plus one growth block exceeds the entire pool "
                        f"({self.backend.n_blocks} blocks) — preemption "
                        "cannot help; size the pool for at least one "
                        "full request (prompt + max_new_tokens)"))
                    failed_one = True
            if failed_one:
                continue        # demand changed; re-evaluate before preempting
            if not self._preempt_one():
                raise MemoryError(
                    f"KV pool exhausted with no preemptable victim: "
                    f"decode growth needs {need} blocks, "
                    f"{self.backend.free_blocks} free of "
                    f"{self.backend.n_blocks}")

    def _run_chunks(self) -> int:
        """Advance mid-prefill jobs by at most the step budget; returns
        the number of prompt tokens processed this step.  On the paged
        backend, capacity for the planned chunks is secured *first* by
        preempting victims (a preempted victim may itself be a planned
        job, so the plan is rebuilt after every preemption)."""
        plan = self.scheduler.plan_chunks()
        if self._paged:
            while True:
                need = self.backend.chunk_block_demand(plan)
                if need <= self.backend.free_blocks:
                    break
                if not self._preempt_one():
                    raise MemoryError(
                        f"KV pool exhausted with no preemptable victim: "
                        f"prefill chunks need {need} blocks, "
                        f"{self.backend.free_blocks} free of "
                        f"{self.backend.n_blocks}")
                plan = self.scheduler.plan_chunks()
        if not plan:
            return 0
        rows = len(plan)
        nbp = next(b for b in self._buckets if b >= rows)
        C = self.scheduler.chunk
        toks = np.zeros((nbp, C), dtype=np.int32)
        offs = np.zeros(nbp, dtype=np.int32)
        clens = np.zeros(nbp, dtype=np.int32)
        slots = np.full(nbp, -1, dtype=np.int64)
        for j, (slot, off, n) in enumerate(plan):
            job = self.scheduler.job(slot)
            toks[j, :n] = job.tokens[off:off + n]
            offs[j], clens[j], slots[j] = off, n, slot
        logits = self.backend.prefill_chunk(toks, offs, clens, slots)
        total = 0
        for j, (slot, off, n) in enumerate(plan):
            total += n
            job = self.scheduler.job(slot)
            if self._obs_rec.enabled:
                self._obs_rec.point(self._obs_replica,
                                    self.slot_req[slot].rid,
                                    "prefill-chunk", self.t_now,
                                    slot=slot, offset=off, tokens=n)
            finished = self.scheduler.advance(slot, n)
            done = off + n
            self.slot_load[slot] = float(done)
            self.table.prefill_left[slot] = 0 if finished else \
                job.remaining
            if finished:
                r = self.slot_req[slot]
                if job.resume_token is not None:
                    # recompute-on-resume rebuild: the next decode input
                    # was generated before the preemption — no fresh
                    # first token is sampled
                    self.slot_tokens[slot] = int(job.resume_token)
                    self.slot_age[slot] = len(r.generated)
                    if (job.resume_length is not None
                            and job.resume_length > done):
                        # the victim had decoded past max_seq_len on
                        # frozen KV: keep its RoPE position counter
                        # instead of restarting it at the cap
                        self.backend.kv.set_length(slot,
                                                   job.resume_length)
                    continue
                if self._paged and self.backend.prefix is not None:
                    # index the finished prompt's blocks for later
                    # arrivals (sync admissions register at write_prefill;
                    # chunked jobs allocate lazily, so register here)
                    self.backend.register_chunk_prefix(
                        slot, job.tokens,
                        chain=self._prefix_chain(r, job.tokens))
                first = int(np.argmax(logits[j]))
                self.slot_tokens[slot] = first
                self.slot_age[slot] = 1
                r.generated.append(first)
                if np.isnan(r.t_first_token):
                    r.t_first_token = self.t_now
                    if self._obs_rec.enabled:
                        self._obs_rec.point(self._obs_replica, r.rid,
                                            "decode", self.t_now,
                                            slot=slot)
                if (len(r.generated) >= r.max_new_tokens
                        or first == r.eos_id):
                    self._finish_at_prefill(slot, r)
        return total

    def _finish_at_prefill(self, slot: int, r: "ServeRequest") -> None:
        """A request whose budget (or eos) is already met by its first
        token completes at prefill instead of burning a decode step on a
        token past its budget."""
        r.t_finish = self.t_now
        r.status = "done"
        self.slot_req[slot] = None
        self.table.release(np.asarray([slot]))
        self.backend.release(np.asarray([slot]))
        if self._obs_rec.enabled:
            self._obs_rec.point(self._obs_replica, r.rid, "completed",
                                self.t_now, n_generated=len(r.generated))

    def _prefill_batch(self, items: list[tuple["ServeRequest", int]]) -> None:
        """Run prefill for admitted requests and write their cache slots.

        Prompts longer than ``max_seq_len`` are truncated to it (the cache
        cannot hold more); the prefill pad never exceeds ``max_seq_len``.
        """
        ec = self.ec
        vec = ec.engine_mode == "vec"
        seqs = [self._admit_tokens(r) for r, _ in items]
        pad = min(max(ec.prefill_pad, max(len(t) for t in seqs)),
                  ec.max_seq_len)
        if vec:
            # round the pad up to a multiple of prefill_pad so the prefill
            # sees few distinct sequence lengths (the reference's jit
            # buckets)
            pad = min(-(-pad // ec.prefill_pad) * ec.prefill_pad,
                      ec.max_seq_len)
        nb = len(items)
        # vec: bucket the batch dim too (same ladder as compact decode)
        nbp = next(b for b in self._buckets if b >= nb) if vec else nb
        toks = np.zeros((nbp, pad), dtype=np.int32)
        lens = np.zeros(nbp, dtype=np.int32)
        for i, t in enumerate(seqs):
            L = min(len(t), pad)
            toks[i, :L] = t[:L]
            lens[i] = L
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "lengths": torch.from_numpy(lens).to(self.device)}
        # the stub front ends: zero patch / frame embeddings, as in the
        # reference engine
        dt = torch_dtype(self.cfg.dtype)
        if self.cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (nbp, self.cfg.patch_tokens, self.cfg.d_model), dtype=dt,
                device=self.device)
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (nbp, self.cfg.encoder_seq, self.cfg.d_model), dtype=dt,
                device=self.device)
        logits, mini_cache = prefill_fn(self.cfg, self.params, batch,
                                        max_len=ec.max_seq_len)
        first = logits.argmax(-1).to(torch.int32).cpu().numpy()

        # place each request into a free slot of its assigned worker
        workers = np.array([g for _, g in items], dtype=np.int64)
        if vec:
            slots = self.table.allocate(workers)
        else:
            slots = np.empty(nb, dtype=np.int64)
            for i, (r, g) in enumerate(items):
                free = [s for s in range(g * self.B, (g + 1) * self.B)
                        if self.slot_req[s] is None]
                if not free:
                    raise RuntimeError(
                        f"worker {g} has no free slot for request {r.rid} "
                        f"(policy assignment not capped?)")
                slots[i] = free[0]
                self.slot_req[free[0]] = r
            self.table.active[slots] = True
        done_slots = []
        length_fix = []
        for i, (r, g) in enumerate(items):
            slot = int(slots[i])
            r.worker, r.slot = g, slot
            r.status = "active"
            if vec:
                self.slot_req[slot] = r  # ref set it during the free scan
            self.slot_load[slot] = float(lens[i])
            self.slot_max_new[slot] = r.max_new_tokens
            self.slot_eos[slot] = r.eos_id
            self.slot_admit_seq[slot] = self._admit_seq
            self._admit_seq += 1
            if r.preempted is not None:
                # recompute-on-resume: KV rebuilt, the pending decode
                # input was generated before the preemption
                self.slot_tokens[slot] = int(r.preempted.next_token)
                self.slot_age[slot] = len(r.generated)
                if r.preempted.length > int(lens[i]):
                    # victim had decoded past max_seq_len on frozen KV:
                    # restore its RoPE position counter after the
                    # backend re-admits the slot below
                    length_fix.append((slot, int(r.preempted.length)))
                r.preempted = None
                if self._obs_rec.enabled:
                    self._obs_rec.point(self._obs_replica, r.rid,
                                        "resumed", self.t_now,
                                        slot=slot, mode="recompute")
                continue
            if self._obs_rec.enabled:
                self._obs_rec.point(self._obs_replica, r.rid,
                                    "admitted", self.t_now,
                                    worker=g, slot=slot, seeded=0)
            first_tok = int(first[i])
            self.slot_tokens[slot] = first_tok
            self.slot_age[slot] = 1
            r.generated.append(first_tok)
            if np.isnan(r.t_first_token):
                r.t_first_token = self.t_now
                if self._obs_rec.enabled:
                    self._obs_rec.point(self._obs_replica, r.rid,
                                        "decode", self.t_now, slot=slot)
            if (len(r.generated) >= r.max_new_tokens
                    or first_tok == r.eos_id):
                done_slots.append((slot, r))
        if vec:
            chains = [self._prefix_chain(r, toks[i, :int(lens[i])])
                      for i, (r, _) in enumerate(items)]
            self.backend.write_prefill(mini_cache, np.arange(nb), slots,
                                       tokens=toks, chains=chains)
        else:
            for i in range(nb):     # seed path: one copy a request
                self.backend.write_prefill(mini_cache, [i], [int(slots[i])])
        for slot, length in length_fix:    # paged-only (resume path)
            self.backend.kv.set_length(slot, length)
        for slot, r in done_slots:
            self._finish_at_prefill(slot, r)

    # ------------------------------------------------------------------
    def step(self) -> dict:
        """One barrier-synchronized step: admission, at most
        ``prefill_budget`` chunked-prefill tokens, and one decode token
        for every active (non-prefilling) request.

        The returned info dict carries ``phase`` — the dominant work
        class of the step (``preempt`` > ``prefill`` > ``decode`` >
        ``idle``) — which the fleet's straggler attribution maps to an
        idle cause when this replica gates a barrier step."""
        p0 = self.preemptions
        fresh, resumed = self._admit()
        chunk_tokens = self._run_chunks() if self.scheduler.chunked else 0
        if self._paged:
            # secure this step's decode growth (block crossings + COW)
            # before the barrier: preempt victims rather than letting the
            # allocator raise mid-decode
            self._ensure_decode_capacity()
        vec = self.ec.engine_mode == "vec"
        if vec:
            active_idx = self.table.active_indices()
            decode_idx = self.table.decode_indices() \
                if self.scheduler.chunked else active_idx
            n_active = active_idx.size
        else:
            decode_idx = [s for s, r in enumerate(self.slot_req)
                          if r is not None]
            n_active = len(decode_idx)
        loads = self._loads()
        lmax = float(loads.max()) if n_active else 0.0
        dt = self.ec.step_overhead + self.ec.t_token * lmax
        u = loads / lmax if lmax > 0 else np.zeros(self.G)
        self.energy_j += dt * float(self.ec.power.power(u).sum())
        imb = step_imbalance(loads) if n_active else 0.0
        self.imbalance_sum += imb
        self.t_now += dt
        self.steps += 1

        n_decode = len(decode_idx)
        if n_decode:
            if vec:
                self._decode_step_vec(np.asarray(decode_idx))
            else:
                self._decode_step_ref(decode_idx)
        if self.ec.cache_backend == "paged":
            self.kv_peak_bytes = max(self.kv_peak_bytes,
                                     self.backend.resident_kv_bytes())
        if self.preemptions > p0 or resumed:
            phase = "preempt"
        elif chunk_tokens or fresh:
            phase = "prefill"
        elif n_decode:
            phase = "decode"
        else:
            phase = "idle"
        return {"t": self.t_now, "active": n_active,
                "waiting": len(self.wait), "max_load": lmax,
                "imbalance": imb, "decoded": n_decode,
                "prefill_tokens": chunk_tokens,
                "prefilling": self.scheduler.n_prefilling,
                "phase": phase}

    def _decode_step_ref(self, active: list[int]) -> None:
        """Seed decode path: always decode all G*B slots, per-slot loop."""
        n = self.slot_tokens.size            # G*B: the whole cache
        nxt = self.backend.decode(self.slot_tokens, np.arange(n), n)
        for s in active:
            r = self.slot_req[s]
            tok = int(nxt[s])
            r.generated.append(tok)
            self.slot_tokens[s] = tok
            self.tokens_out += 1
            self.slot_load[s] += self.drift.increment(self.steps)
            if (len(r.generated) >= r.max_new_tokens
                    or tok == r.eos_id):
                r.t_finish = self.t_now
                r.status = "done"
                if self._obs_rec.enabled:
                    self._obs_rec.point(self._obs_replica, r.rid,
                                        "completed", self.t_now,
                                        n_generated=len(r.generated))
                self.slot_req[s] = None
                self.slot_load[s] = 0.0
                self.table.active[s] = False

    def _decode_step_vec(self, active_idx: np.ndarray) -> None:
        """Vectorized decode path: compact the active slots into the
        smallest decode bucket and let the cache backend run the model
        only on those rows (row gather/scatter for the slot backend,
        block-table indirection for the paged backend)."""
        n = active_idx.size
        nb = next(b for b in self._buckets if b >= n)
        nxt = self.backend.decode(self.slot_tokens, active_idx, nb)

        self.slot_tokens[active_idx] = nxt
        self.slot_load[active_idx] += self.drift.increment(self.steps)
        self.slot_age[active_idx] += 1
        self.tokens_out += n
        for pos, s in enumerate(active_idx):
            self.slot_req[s].generated.append(int(nxt[pos]))
        done = ((self.slot_age[active_idx] >= self.slot_max_new[active_idx])
                | (nxt.astype(np.int64) == self.slot_eos[active_idx]))
        if done.any():
            done_idx = active_idx[done]
            for s in done_idx:
                r = self.slot_req[s]
                r.t_finish = self.t_now
                r.status = "done"
                if self._obs_rec.enabled:
                    self._obs_rec.point(self._obs_replica, r.rid,
                                        "completed", self.t_now,
                                        n_generated=len(r.generated))
                self.slot_req[s] = None
            self.table.release(done_idx)
            self.backend.release(done_idx)

    def run(self, max_steps: int = 10_000) -> dict:
        """Step until all submitted requests finish."""
        while self.wait or self.table.active.any():
            if self.steps >= max_steps:
                raise RuntimeError("engine exceeded max_steps")
            self.step()
        return self.stats()

    def stats(self) -> dict:
        prefix = getattr(self.backend, "prefix", None)
        hits = prefix.hits if prefix is not None else 0
        queries = prefix.queries if prefix is not None else 0
        # three-state allocator counters (paged backend; zeros on the
        # slot layout so slot/paged stats dicts stay key-compatible)
        alloc = getattr(getattr(self.backend, "kv", None),
                        "allocator", None)
        return {
            "steps": self.steps,
            "time_s": self.t_now,
            "tokens": self.tokens_out,
            "throughput_tok_s": self.tokens_out / max(self.t_now, 1e-12),
            "energy_j": self.energy_j,
            "avg_imbalance": self.imbalance_sum / max(self.steps, 1),
            "policy": self.policy.name,
            "requests_failed": self.requests_failed,
            "preemptions": self.preemptions,
            "tokens_swapped": self.tokens_swapped,
            "tokens_recomputed": self.tokens_recomputed,
            "prefix_hits": hits,
            "prefix_queries": queries,
            "prefix_hit_rate": hits / queries if queries else 0.0,
            "prefix_cached_blocks": alloc.n_cached if alloc else 0,
            "prefix_revived": alloc.blocks_revived if alloc else 0,
            "prefix_reclaimed": alloc.blocks_reclaimed if alloc else 0,
        }
