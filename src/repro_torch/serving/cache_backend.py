"""Pluggable KV-cache backends for the serving engine.

The engine's barrier-step loop needs exactly four things from its memory
substrate: write an admitted request's prefill KV, advance a prompt chunk
(chunked prefill), decode one token for a compacted set of slots, and
release a finished slot.  :class:`CacheBackend` is that seam; the engine
(:mod:`repro_torch.serving.engine`) owns scheduling and request
bookkeeping and never touches cache layout.

Two implementations, selected by ``EngineConfig.cache_backend``:

* :class:`SlotCacheBackend` (``"slot"``) — the contiguous per-slot layout:
  one flat ``init_cache`` tree over all ``G * B`` slots, compact decode by
  gather/scatter of whole cache rows.  Simple, but reserves
  ``max_seq_len`` KV per slot forever and copies full rows to compact.
  It serves every ported family (dense, moe, ssm, hybrid); its decode runs
  :func:`repro_torch.models.decode_fn`, whose attention is the Hopper
  contiguous decode-attention kernel and whose Mamba2/mLSTM prefill scan
  is the chunked-scan kernel on the card.
* :class:`PagedCacheBackend` (``"paged"``) — vLLM-style paging over
  :class:`~repro_torch.serving.paged_cache.PagedKVCache`: fixed size KV
  blocks from a shared pool, per-slot block tables, resident KV
  proportional to *actual* tokens.  Decode runs through
  :func:`repro_torch.models.paged_decode_fn` with the configured
  attention (``"kernel"`` by default: the Hopper paged-attention kernel
  on the card).  Attention-family models only — recurrent-state families
  have no paged layout.

The contract the engine relies on:

* ``decode`` is called with a *bucketed* batch size ``nb >= n`` (a small
  ladder of sizes); rows beyond ``n`` are padding whose writes must be
  dropped and whose outputs are discarded.
* ``prefill_chunk`` rows with ``slots[i] < 0`` are padding under the same
  convention.
* All methods are synchronous with respect to the host arrays the engine
  reads (``lengths`` bookkeeping must be visible immediately after the
  call returns).

On the card each backend's decode is one CUDA graph per bucket (the
reference jits it per bucket; :mod:`repro_torch.core.graphs`): the host
builds the step's arrays (token ids, row indices, block tables, lengths,
write positions), they are copied into the graph's static buffers, the
graph replays, and the next tokens are read back once.  So nothing in a
decode body reads the device from the host or takes a shape from the
data: the padding rows' dropped writes are fixed-shape scatters
(:func:`scatter_rows`, ``paged_decode_fn``).  Prefill and chunked prefill
run op by op.
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.graphs import Graphs
from ..models import (
    chunk_prefill_fn,
    decode_fn,
    init_cache,
    paged_chunk_prefill_fn,
    paged_decode_fn,
    supports_paged_stack,
    torch_dtype,
)
from .paged_cache import PagedKVCache, PrefixIndex
from .preemption import PreemptedState, swap_in_blocks, swap_out_blocks

__all__ = ["CacheBackend", "SlotCacheBackend", "PagedCacheBackend",
           "make_cache_backend", "gather_rows", "scatter_rows"]


# ----------------------------------------------------------------------
# Row gather/scatter over a cache tree (dicts of tensors; the sLSTM state
# is a tuple).  Batch is dim 0 of the 1-d ``lengths`` and dim 1 of every
# stacked (layers, batch, ...) leaf.
# ----------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def gather_rows(cache, idx: torch.Tensor):
    """A copy of cache rows ``idx`` (int64 on the cache's device)."""
    return _tree_map(lambda a: a[idx] if a.dim() == 1 else a[:, idx],
                     cache)


def scatter_rows(cache, sub, dst: torch.Tensor) -> None:
    """Write sub-batch rows back at ``dst`` IN PLACE.  Entries of ``dst``
    past the last row (``dst == N``) are padding whose writes are dropped,
    as JAX drops the reference's out-of-bounds scatter.  At least one
    entry must be a row.

    One fixed-shape scatter with no host sync (it runs inside the captured
    decode): a padding entry writes the first live entry's row to that
    entry's destination again, so every duplicate destination gets the
    same bits and the scatter's order cannot matter."""
    keep = dst < cache["lengths"].shape[0]
    rows = torch.where(keep, torch.arange(dst.shape[0], device=dst.device),
                       keep.int().argmax())
    dst = dst[rows]

    def put(full, part):
        if full.dim() == 1:
            full[dst] = part[rows].to(full.dtype)
        else:
            full[:, dst] = part[:, rows].to(full.dtype)
    _tree_map(put, cache, sub)


def _install(cache, mini, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy rows ``src`` of the prefill mini cache into slots ``dst`` of
    the flat cache, IN PLACE.  The mini cache may carry a shorter
    kv-length dim (prefill pad), zero-padded up to the flat cache's."""
    def copy(dst_leaf, src_leaf):
        if dst_leaf.dim() == 1:          # lengths
            dst_leaf[dst] = src_leaf[src].to(dst_leaf.dtype)
            return
        s = src_leaf[:, src]
        tail = dst_leaf.shape[2:]
        if s.shape[2:] != tail:
            pads = []
            for i in reversed(range(len(tail))):
                pads += [0, tail[i] - s.shape[2 + i]]
            s = F.pad(s, pads)
        dst_leaf[:, dst] = s.to(dst_leaf.dtype)
    _tree_map(copy, cache, mini)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ----------------------------------------------------------------------
# Protocol
# ----------------------------------------------------------------------

class CacheBackend(abc.ABC):
    """Memory-layout seam between the serving engine and the model.

    Implementations own the physical KV storage and the model calls that
    read/write it; the engine owns slots, scheduling, and metrics.  See
    the module docstring for the padding conventions.
    """

    name: str = "base"

    @abc.abstractmethod
    def write_prefill(self, mini_cache, src: np.ndarray, dst: np.ndarray,
                      tokens: Optional[np.ndarray] = None,
                      chains: Optional[list] = None) -> None:
        """Install prefill output: copy rows ``src`` of ``mini_cache``
        (a ``prefill_fn`` cache over the admitted batch) into slots
        ``dst``.  ``tokens`` (rows aligned with the mini cache) carries
        the prompt token ids so content-addressed backends can dedup
        shared prefixes; layout-only backends ignore it.  ``chains``
        (aligned with ``src`` rows) optionally carries each row's
        precomputed block-hash chain (``PrefixIndex.keys_for`` output,
        memoized on the request) so the prompt is hashed once per
        lifetime, not once per consumer."""

    @abc.abstractmethod
    def prefill_chunk(self, toks: np.ndarray, offs: np.ndarray,
                      clens: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Advance one prompt chunk per row and return each row's logits
        at its final chunk position, shape (rows, vocab).  ``toks`` is
        (rows, C) right-padded; ``offs``/``clens`` give each chunk's
        start position and valid length; ``slots[i] < 0`` marks padding
        rows."""

    @abc.abstractmethod
    def decode(self, slot_tokens: np.ndarray, active_idx: np.ndarray,
               bucket: int) -> np.ndarray:
        """One greedy decode token for each slot in ``active_idx``
        (batched at size ``bucket``); returns (n,) int32 next tokens and
        updates the stored KV in place."""

    @abc.abstractmethod
    def release(self, slots: np.ndarray) -> None:
        """Free finished slots' KV."""

    @abc.abstractmethod
    def resident_kv_bytes(self) -> int:
        """Bytes of KV currently held for live requests."""


# ----------------------------------------------------------------------
# Contiguous per-slot backend
# ----------------------------------------------------------------------

class SlotCacheBackend(CacheBackend):
    """Contiguous per-slot cache: one flat :func:`~repro_torch.models.
    init_cache` tree over all N slots on ``device``, compact decode via
    gather/scatter of whole cache rows.

    The flat cache is updated IN PLACE by every call (the reference
    donates it to its jitted calls and rebinds the result): prefill rows
    are copied into their slots, full-batch decode writes straight into
    it, compact decode and chunked prefill gather the rows they run,
    update that copy and scatter it back (padding rows carry ``dst == N``
    and are dropped)."""

    name = "slot"

    def __init__(self, cfg: ModelConfig, params, ec, device):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.N = ec.n_workers * ec.slots_per_worker
        self.cache = init_cache(cfg, self.N, ec.max_seq_len,
                                device=self.device)
        self._bytes = int(sum(a.nbytes for a in _leaves(self.cache)))
        self.graphs = Graphs(self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def write_prefill(self, mini_cache, src, dst, tokens=None,
                      chains=None) -> None:
        """One gather/scatter per cache leaf over the whole admitted batch
        (see :func:`_install`).  ``tokens``/``chains`` are unused (the
        contiguous layout is not content-addressed)."""
        _install(self.cache, mini_cache,
                 self._dev(np.asarray(src, np.int64)),
                 self._dev(np.asarray(dst, np.int64)))

    def prefill_chunk(self, toks, offs, clens, slots) -> np.ndarray:
        if not (slots >= 0).any():
            raise ValueError("prefill_chunk needs at least one live row")
        idx = self._dev(np.maximum(slots, 0).astype(np.int64))
        dst = self._dev(np.where(slots >= 0, slots, self.N).astype(np.int64))
        sub = gather_rows(self.cache, idx)
        logits, sub = chunk_prefill_fn(         # sub updated in place
            self.cfg, self.params, sub, self._dev(toks.astype(np.int32)),
            self._dev(offs.astype(np.int32)),
            self._dev(clens.astype(np.int32)))
        scatter_rows(self.cache, sub, dst)
        return logits.float().cpu().numpy()

    def _state(self) -> list:
        return _leaves(self.cache) + _leaves(self.params)

    def _decode_full(self, toks: torch.Tensor) -> torch.Tensor:
        """The full-batch decode (the reference's ``_jitted_decode_full``):
        every slot, the flat cache updated in place; greedy tokens."""
        cache = dict(self.cache)       # decode_fn rebinds "lengths"
        logits, cache = decode_fn(self.cfg, self.params, cache, toks)
        self.cache["lengths"].copy_(cache["lengths"])
        return logits.argmax(-1).to(torch.int32)

    def _decode_compact(self, toks, idx, dst) -> torch.Tensor:
        """The compact decode (``_jitted_decode_compact``): gather rows
        ``idx``, decode them, scatter them back at ``dst`` (pads at
        ``N``); greedy tokens."""
        sub = gather_rows(self.cache, idx)
        logits, sub = decode_fn(self.cfg, self.params, sub, toks)
        scatter_rows(self.cache, sub, dst)
        return logits.argmax(-1).to(torch.int32)

    def decode(self, slot_tokens, active_idx, bucket) -> np.ndarray:
        """One captured region a bucket on the card (see
        :mod:`repro_torch.core.graphs`), then one host read."""
        n = active_idx.size
        if n == 0:
            return np.zeros(0, np.int32)
        if bucket >= self.N:
            nxt = self.graphs.run(
                "full", self._decode_full,
                (np.asarray(slot_tokens, np.int32),), self._state)
            return nxt.cpu().numpy()[active_idx]
        idx = np.zeros(bucket, dtype=np.int64)
        idx[:n] = active_idx
        dst = np.full(bucket, self.N, dtype=np.int64)   # pads: dropped
        dst[:n] = active_idx
        nxt = self.graphs.run(
            "compact", self._decode_compact,
            (slot_tokens[idx].astype(np.int32), idx, dst), self._state)
        return nxt.cpu().numpy()[:n]

    def release(self, slots) -> None:
        # rows are simply abandoned in place (stale state is masked by
        # lengths, or overwritten, by the next occupant's prefill)
        pass

    def resident_kv_bytes(self) -> int:
        return self._bytes


# ----------------------------------------------------------------------
# Paged backend (vLLM block tables over a shared pool)
# ----------------------------------------------------------------------

class PagedCacheBackend(CacheBackend):
    """Paged KV: fixed-size blocks from a shared pool, per-slot block
    tables, resident KV tracking actual tokens.

    ``EngineConfig`` knobs: ``paged_block_size`` (tokens per block;
    must divide ``max_seq_len`` so the gathered contiguous view matches
    the slot layout bit-for-bit), ``paged_pool_blocks`` (0 = capacity for
    every slot at ``max_seq_len``; smaller pools oversubscribe memory —
    the engine preempts victims on pressure instead of crashing, see
    :mod:`repro_torch.serving.preemption`), ``paged_attn_impl``
    (``"kernel"`` Hopper kernel / ``"gather"`` contiguous-view oracle /
    ``"ref"`` standalone gather oracle), and ``prefix_cache`` (share
    identical prompt-prefix blocks across requests via
    :class:`~repro_torch.serving.paged_cache.PrefixIndex`, copy-on-write
    on the first divergent append).

    The pools live on ``device`` and are updated in place by every model
    call (the reference donates them to its jitted calls).

    The preemption surface the engine drives: the ``*_demand`` methods
    report how many blocks an operation is about to allocate (so the
    engine can free capacity *first* and the allocator never raises
    mid-step), and ``swap_out`` / ``swap_in`` / ``discard`` move a
    victim's blocks to host staging and back (or drop them for
    recompute-on-resume)."""

    name = "paged"

    def __init__(self, cfg: ModelConfig, params, ec, device):
        if not supports_paged_stack(cfg):
            raise ValueError(
                "cache_backend='paged' supports only attention-family "
                f"models (dense/moe/vlm, no sliding window); got "
                f"{cfg.family!r}")
        bs = int(ec.paged_block_size)
        if ec.max_seq_len % bs != 0:
            raise ValueError(
                f"paged_block_size {bs} must divide max_seq_len "
                f"{ec.max_seq_len}")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.attn_impl = ec.paged_attn_impl
        self.N = ec.n_workers * ec.slots_per_worker
        self.block_size = bs
        self.max_blocks = ec.max_seq_len // bs
        n_blocks = int(ec.paged_pool_blocks) or self.N * self.max_blocks
        self.kv = PagedKVCache.create(
            n_layers=cfg.n_layers, n_blocks=n_blocks, block_size=bs,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            max_requests=self.N, max_blocks_per_req=self.max_blocks,
            dtype=torch_dtype(cfg.dtype),
            prefix_evict=getattr(ec, "prefix_evict", "lru"),
            device=self.device)
        self.prefix: Optional[PrefixIndex] = None
        if getattr(ec, "prefix_cache", False):
            self.prefix = PrefixIndex()
            self.kv.prefix = self.prefix
        self.graphs = Graphs(self.device)

    # -- helpers --------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.kv.allocator.n_blocks

    @property
    def free_blocks(self) -> int:
        """Blocks an allocation can be served from right now: the free
        list plus the reclaimable LRU-cached list.  Admission block
        budgets and the decode/chunk preemption gates charge against
        this — a warm persistent prefix cache is reusable capacity, not
        pressure, so it must never false-trigger preemption or
        ``MemoryError``."""
        return self.kv.allocator.n_reclaimable

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained on the prefix-cache LRU list."""
        return self.kv.allocator.n_cached

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a request with ``n_tokens`` of KV occupies (>= 1)."""
        return -(-max(int(n_tokens), 1) // self.block_size)

    def pool_bytes(self) -> int:
        return int(self.kv.k_pool.nbytes + self.kv.v_pool.nbytes)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """One host array onto the pool's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tables_for(self, slots: np.ndarray) -> np.ndarray:
        out = np.full((slots.size, self.max_blocks), -1, np.int32)
        valid = slots >= 0
        out[valid] = self.kv.block_tables[slots[valid]]
        return out

    # -- protocol -------------------------------------------------------
    def _shared_prefix(self, toks_row: np.ndarray,
                       chain: Optional[list] = None) -> tuple[list, list]:
        """Longest leading run of prefix-cache hits for a prompt: returns
        (keys, shared_blocks) where ``keys`` covers every block of the
        prompt (chained content-hash triples) and ``shared_blocks`` is
        the hit run (possibly empty).  Only content-verified *live*
        blocks count — referenced by a resident holder or retained on
        the allocator's LRU cached list.  A cached hit is touched here
        (LRU recency) and revived when ``admit`` pins it moments later
        (``add_ref`` on a cached block re-pins it atomically; no
        allocation happens in between, so the hit cannot be reclaimed
        out from under the admit).  ``chain`` optionally supplies the
        precomputed ``keys_for`` triples (memoized on the request) so
        the prompt is not re-hashed per consumer."""
        keys = chain if chain is not None \
            else self.prefix.keys_for(toks_row, self.block_size)
        alloc = self.kv.allocator
        shared = []
        for key, parent, span in keys:
            blk = self.prefix.lookup(key, parent, span)
            if blk is None or not alloc.is_live(blk):
                break
            alloc.touch(blk)
            shared.append(blk)
        self.prefix.note_lookup(len(keys), len(shared))
        return keys, shared

    def write_prefill(self, mini_cache, src, dst, tokens=None,
                      chains=None) -> None:
        """Scatter the admitted batch's prefill KV into freshly allocated
        blocks: ONE gather + scatter per pool (k and v) for the whole
        batch, indexed block-wise.  With the prefix cache on (and
        ``tokens`` provided), each request's leading blocks whose chained
        token-content hash is already indexed are reused copy-free via
        ``add_ref`` — their writes are skipped (the resident KV for an
        identical prefix is identical) — and the request's own blocks are
        registered for later arrivals."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        lens = mini_cache["lengths"].cpu().numpy()
        bs = self.block_size
        rows, blkpos, blocks = [], [], []
        for n, (i, s) in enumerate(zip(src, dst)):
            s = int(s)
            L = int(lens[i])
            keys: list = []
            shared: list = []
            if self.prefix is not None and tokens is not None and L > 0:
                keys, shared = self._shared_prefix(
                    tokens[int(i), :L],
                    chain=chains[n] if chains is not None else None)
            self.kv.admit(s, L, shared=tuple(shared))
            bl = self.kv.req_blocks[s]
            for j, (key, parent, span) in enumerate(keys):
                self.prefix.register(key, parent, span, bl[j])
            skip = len(shared)
            rows.extend([int(i)] * (len(bl) - skip))
            blkpos.extend(range(skip, len(bl)))
            blocks.extend(bl[skip:])
        k = mini_cache["blocks"]["k"]          # (layers, nb, S, Hkv, hd)
        v = mini_cache["blocks"]["v"]
        S = k.shape[2]
        pad = (-S) % bs
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        nblk = (S + pad) // bs
        kb = k.reshape(k.shape[0], k.shape[1], nblk, bs, *k.shape[3:])
        vb = v.reshape(*kb.shape)
        if not blocks:       # every block shared: nothing to write
            return
        rows = self._dev(np.asarray(rows, np.int64))
        blkpos = self._dev(np.asarray(blkpos, np.int64))
        self.kv.write_blocks(blocks, kb[:, rows, blkpos], vb[:, rows, blkpos])

    def seed_chunk_prefix(self, slot: int, toks: np.ndarray,
                          count: bool = True,
                          chain: Optional[list] = None) -> int:
        """Chunked-admission prefix hit: pin the longest run of *full*
        indexed blocks matching the prompt's leading content into
        ``slot`` (``add_ref``, copy-free) and return the token count they
        cover — the chunk job then starts at that offset, skipping
        recompute of the hit prefix (a TTFT win on top of the memory
        dedup).  Restricted to full blocks: chunk writes land directly in
        pool blocks (no copy-on-write on the prefill path), so a shared
        partial tail could be corrupted by the first chunk's scatter —
        full blocks strictly before the chunk offset are never written.
        At least the prompt's final token is always left uncovered so the
        finishing chunk computes the logits the first sampled token needs
        (generations stay bit-identical on dense models).

        ``count=False`` skips the hit-rate counters: a preempt-restarted
        job re-seeds the same admission, and counting that re-walk again
        would double-count the admission's lookup (the engine passes
        ``count`` = first-admission)."""
        if self.prefix is None:
            return 0
        L = len(toks)
        keys = chain if chain is not None \
            else self.prefix.keys_for(toks, self.block_size)
        alloc = self.kv.allocator
        shared: list[int] = []
        for key, parent, span in keys:
            if len(span) < self.block_size:
                break               # partial tail: never shared pre-write
            blk = self.prefix.lookup(key, parent, span)
            if blk is None or not alloc.is_live(blk):
                break
            alloc.touch(blk)
            shared.append(blk)
        # keep the last prompt token out of the shared run (see above)
        while shared and len(shared) * self.block_size >= L:
            shared.pop()
        if count:
            self.prefix.note_lookup(len(keys), len(shared))
        if not shared:
            return 0
        for b in shared:
            alloc.add_ref(b)
        covered = len(shared) * self.block_size
        self.kv.adopt_blocks(slot, shared, covered)
        return covered

    def register_chunk_prefix(self, slot: int, toks: np.ndarray,
                              chain: Optional[list] = None) -> None:
        """Index a chunk-prefilled prompt's blocks for later arrivals
        (the synchronous path registers at :meth:`write_prefill`; chunked
        jobs allocate lazily, so registration happens when the prompt
        completes).  Includes the partial tail — a later *synchronous*
        admission may share it (decode appends into it copy-on-write).
        ``chain`` optionally supplies the precomputed ``keys_for``
        triples (memoized on the request)."""
        if self.prefix is None:
            return
        bl = self.kv.req_blocks.get(int(slot), [])
        keys = chain if chain is not None \
            else self.prefix.keys_for(toks, self.block_size)
        for j, (key, parent, span) in enumerate(keys):
            if j >= len(bl):
                break
            self.prefix.register(key, parent, span, bl[j])

    def prefill_chunk(self, toks, offs, clens, slots) -> np.ndarray:
        bs = self.block_size
        nb, C = toks.shape
        for j in range(nb):
            if slots[j] >= 0:
                self.kv.ensure_capacity(int(slots[j]),
                                        int(offs[j] + clens[j]))
        tables = self._tables_for(slots)
        posm = offs[:, None] + np.arange(C)[None, :]
        validm = np.arange(C)[None, :] < clens[:, None]
        # positions past a full block table have no block to land in
        # (frozen KV, see ensure_capacity): drop those writes like the
        # decode path's in_cap clamp instead of corrupting the last block
        in_cap = posm < self.max_blocks * bs
        bidx = np.clip(posm // bs, 0, self.max_blocks - 1)
        wblk = np.where(validm & in_cap,
                        np.take_along_axis(tables, bidx, axis=1),
                        self.n_blocks).astype(np.int32)
        woff = (posm % bs).astype(np.int32)
        logits, _, _ = paged_chunk_prefill_fn(      # pools updated in place
            self.cfg, self.params, self.kv.k_pool, self.kv.v_pool,
            self._dev(tables), self._dev(toks.astype(np.int32)),
            self._dev(offs.astype(np.int32)),
            self._dev(clens.astype(np.int32)), self._dev(wblk),
            self._dev(woff), block_size=bs)
        return logits.float().cpu().numpy()

    def decode(self, slot_tokens, active_idx, bucket) -> np.ndarray:
        n = active_idx.size
        self.kv.append_tokens(active_idx)
        lens = np.zeros(bucket, np.int32)
        lens[:n] = self.kv.lengths[active_idx]
        tables = np.full((bucket, self.max_blocks), -1, np.int32)
        tables[:n] = self.kv.block_tables[active_idx]
        pos = np.maximum(lens - 1, 0)
        blk = np.full(bucket, self.n_blocks, np.int32)  # pads: dropped
        # requests that outgrew max_seq_len keep decoding on frozen KV
        # (write dropped), matching the slot layout's scatter overflow
        in_cap = pos[:n] < self.max_blocks * self.block_size
        blk[:n][in_cap] = tables[np.flatnonzero(in_cap),
                                 pos[:n][in_cap] // self.block_size]
        off = (pos % self.block_size).astype(np.int32)
        toks = np.zeros(bucket, np.int32)
        toks[:n] = slot_tokens[active_idx]
        nxt = self.graphs.run("decode", self._decode,
                              (tables, lens, blk, off, toks), self._state)
        return nxt.cpu().numpy()[:n]

    def _state(self) -> list:
        return [self.kv.k_pool, self.kv.v_pool] + _leaves(self.params)

    def _decode(self, tables, lens, blk, off, toks) -> torch.Tensor:
        """The paged decode (the reference's jitted ``paged_decode_fn``),
        pools updated in place; greedy tokens.  One captured region a
        bucket on the card (see :mod:`repro_torch.core.graphs`)."""
        nxt, _, _ = paged_decode_fn(
            self.cfg, self.params, self.kv.k_pool, self.kv.v_pool, tables,
            lens, blk, off, toks, block_size=self.block_size,
            attn_impl=self.attn_impl)
        return nxt

    # -- memory pressure (engine-driven preemption) ---------------------
    def decode_block_demand(self, active_idx: np.ndarray) -> int:
        """Blocks the next decode step over ``active_idx`` will allocate
        (boundary crossings + copy-on-write of shared tail blocks)."""
        return self.kv.append_demand(active_idx)

    def chunk_block_demand(self, plan) -> int:
        """Blocks a chunk plan [(slot, off, n), ...] will allocate."""
        need = 0
        for slot, off, n in plan:
            have = len(self.kv.req_blocks.get(int(slot), []))
            need += max(self.blocks_for(off + n) - have, 0)
        return need

    def swap_out(self, slot: int) -> PreemptedState:
        """Move a victim's KV blocks to host staging (tiled copy) and
        return them to the pool; the returned state restores the blocks
        bit-for-bit via :meth:`swap_in`.  Staging happens *before* the
        release, so a prefix-indexed block whose last reference drops
        here may coherently enter the cached state: its device content
        is untouched until reclaim (which evicts its index entry first),
        and the resume path restores from the host copy into fresh
        blocks — the two can never alias."""
        slot = int(slot)
        blocks = self.kv.req_blocks.get(slot, [])
        state = PreemptedState(
            mode="swap", length=int(self.kv.lengths[slot]),
            k_host=swap_out_blocks(self.kv.k_pool, blocks),
            v_host=swap_out_blocks(self.kv.v_pool, blocks))
        self.kv.release(slot)
        return state

    def swap_in(self, slot: int, state: PreemptedState) -> None:
        """Restore a swapped victim into fresh blocks on ``slot``.  The
        blocks are private (a shared prefix is not re-deduped on resume);
        admission block-gating guarantees the allocation fits."""
        slot = int(slot)
        n = state.n_blocks
        blocks = self.kv.allocator.alloc(n)
        self.kv.adopt_blocks(slot, blocks, state.length)
        if n:
            swap_in_blocks(self.kv.k_pool, blocks, state.k_host)
            swap_in_blocks(self.kv.v_pool, blocks, state.v_host)

    def discard(self, slot: int) -> None:
        """Drop a victim's KV for recompute-on-resume."""
        self.kv.release(int(slot))

    def release(self, slots) -> None:
        for s in np.asarray(slots):
            self.kv.release(int(s))

    def resident_kv_bytes(self) -> int:
        return self.kv.resident_bytes()


def make_cache_backend(name: str, cfg: ModelConfig, params, ec,
                       device) -> CacheBackend:
    if name == "paged":
        return PagedCacheBackend(cfg, params, ec, device)
    if name == "slot":
        return SlotCacheBackend(cfg, params, ec, device)
    raise ValueError(f"unknown cache backend {name!r} "
                     "(expected 'slot' or 'paged')")
