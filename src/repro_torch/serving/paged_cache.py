"""Paged KV cache: vLLM-style block-table memory management in PyTorch.

The engine's naive cache reserves max_seq_len per slot; under the paper's
workload (geometric decode lengths, heavy prefill dispersion) that wastes
most of HBM.  Paging allocates fixed-size KV blocks from a shared pool and
maps request -> [block ids], so resident KV equals actual tokens (rounded
to the block size).  This is the memory substrate that makes the paper's
B=72-slots-per-worker batching feasible at 32k contexts.

Host-side allocator (python, like real engines' schedulers) + device-side
pools (see repro_torch.kernels.paged_attention for the Hopper kernel and
the gather oracle re-exported here).  The pools are torch tensors updated
in place: the reference replaces its jax arrays functionally, which is
why ``k_pool``/``v_pool`` are the pool's only functional leaves.

Block lifecycle (three states, vLLM-evictor style):

* **referenced** — refcount > 0; owned by one or more resident requests.
* **cached** — refcount 0 but still prefix-indexed: with
  ``evict="lru"`` (default) a prefix-indexed block whose last reference
  drops moves onto an LRU *cached* list instead of the free list.  Its
  KV content stays valid (nobody writes a refcount-0 block), so a later
  request with the same prompt prefix can *revive* it via ``add_ref``
  even though every original holder has finished — the lifetime bug the
  admission-scoped mode (``evict="admission"``) suffers from.
* **free** — on the free list; content is garbage.

``alloc`` serves from the free list first and reclaims LRU-cached
blocks only when the free list is empty; *reclaim* (not release) is the
transition that evicts the block's :class:`PrefixIndex` entry, always
before the block is handed back out.  Admission and preemption gates
must therefore budget against free + cached (``n_reclaimable``), not
``n_free`` alone.

Layout: pool tensors k/v of shape (n_blocks, block_size, Hkv, hd); block
tables (B, max_blocks) int32 (-1 = unallocated).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..kernels.paged_attention import paged_decode_attention_ref

__all__ = ["BlockAllocator", "PrefixIndex", "PagedKVCache",
           "paged_decode_attention_ref"]


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks (host side).

    Blocks are reference-counted: ``alloc`` hands out blocks at refcount 1,
    ``add_ref`` pins a block for sharing (prefix caching), and ``free``
    decrements — a block leaves the referenced state only when its last
    reference drops.  Freeing a block that is not allocated (double-free)
    raises instead of silently pushing a duplicate id onto the free list,
    which would later hand the same physical block to two requests and
    corrupt both caches.

    With a :class:`PrefixIndex` attached (``self.prefix``) and
    ``evict="lru"``, a prefix-indexed block whose last reference drops
    is *retained* on an LRU cached list (refcount 0, content intact,
    still indexed) instead of being freed; ``alloc`` reclaims cached
    blocks oldest-first only once the free list is empty and evicts
    their index entries at that moment — so an index entry can point at
    a referenced or a cached block, never at a recycled one.
    ``add_ref`` on a cached block *revives* it (back to refcount 1).
    ``evict="admission"`` keeps the legacy lifetime: the cached list
    stays empty and every last-ref drop is released (and evicted by the
    owning :class:`PagedKVCache`) immediately.  Without an attached
    index both modes behave identically, bit-for-bit.
    """

    def __init__(self, n_blocks: int, evict: str = "lru"):
        if evict not in ("lru", "admission"):
            raise ValueError(
                f"evict must be 'lru' or 'admission', got {evict!r}")
        self.n_blocks = n_blocks
        self.evict = evict
        self._free = list(range(n_blocks - 1, -1, -1))
        self._refs = np.zeros(n_blocks, dtype=np.int32)
        # LRU cached list: block id -> None, oldest first (insertion
        # order; touch() re-inserts at the MRU end)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self.prefix: Optional["PrefixIndex"] = None
        self.blocks_reclaimed = 0    # cumulative cached -> reallocated
        self.blocks_revived = 0      # cumulative cached -> re-pinned

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def n_reclaimable(self) -> int:
        """Blocks ``alloc`` can serve right now: free + cached (cached
        blocks are reclaimed LRU-first when the free list runs dry).
        Admission/preemption budgets must gate on this, not ``n_free``,
        or a warm cache would false-trigger ``MemoryError``."""
        return len(self._free) + len(self._cached)

    def ref_count(self, block: int) -> int:
        return int(self._refs[block])

    def is_live(self, block: int) -> bool:
        """True when the block's content is valid to share: referenced
        by a resident request, or retained on the cached list."""
        return self._refs[block] > 0 or block in self._cached

    def touch(self, block: int) -> None:
        """Refresh a cached block's LRU recency (a prefix-cache hit)."""
        if block in self._cached:
            self._cached.move_to_end(block)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free) + len(self._cached):
            raise MemoryError(
                f"KV pool exhausted: want {n}, have {len(self._free)} "
                f"free + {len(self._cached)} reclaimable-cached")
        out: list[int] = []
        reclaimed: list[int] = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            else:
                b, _ = self._cached.popitem(last=False)   # LRU victim
                reclaimed.append(b)
                out.append(b)
        if reclaimed:
            # reclaim (not release) evicts: the entry dies exactly when
            # the block's content is about to be overwritten
            self.blocks_reclaimed += len(reclaimed)
            if self.prefix is not None:
                self.prefix.evict(reclaimed)
        self._refs[out] = 1
        return out

    def add_ref(self, block: int) -> None:
        """Pin a block for sharing (prefix hit): one more ``free`` is
        then needed before the block leaves the referenced state.  On a
        *cached* block this revives it — off the LRU list, refcount 1 —
        which is how a hit outlives its original holders."""
        if block < 0 or block >= self.n_blocks:
            raise ValueError(f"bad block id {block}")
        if self._refs[block] > 0:
            self._refs[block] += 1
            return
        if block in self._cached:
            del self._cached[block]
            self._refs[block] = 1
            self.blocks_revived += 1
            return
        raise ValueError(f"add_ref on unallocated block {block}")

    # RA202 sees no release verb here because the free list is a plain
    # python list (``_free.append``) — the method IS the pool's release
    # primitive; everything above it (PagedKVCache._free, swap_out,
    # discard) satisfies the contract by calling it.
    def free(self, blocks: list[int]) -> list[int]:  # ra: ignore[RA202]
        """Drop one reference per block; returns the blocks whose last
        reference dropped *and* went back to the free list — callers
        holding a prefix index must evict exactly those.  In ``"lru"``
        mode a prefix-indexed block is retained on the cached list
        instead (MRU end) and is absent from the returned list: its
        index entry stays valid until the block is reclaimed."""
        released = []
        for b in blocks:
            if b < 0 or b >= self.n_blocks:
                raise ValueError(
                    f"bad block id {b} (pool has {self.n_blocks} blocks)")
            if self._refs[b] <= 0:
                raise ValueError(
                    f"double free of block {b}: refcount is "
                    f"{int(self._refs[b])}, block is not allocated")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                if (self.evict == "lru" and self.prefix is not None
                        and self.prefix.contains_block(b)):
                    self._cached[b] = None
                else:
                    self._free.append(b)
                    released.append(b)
        return released


class PrefixIndex:
    """Block-granular prefix cache: chained content hashes -> block ids.

    A block's key hashes (parent_key, its token ids); equality of the
    64-bit hash alone is NOT trusted — every entry stores its (parent,
    tokens) pair and :meth:`lookup` verifies them, so a hash collision
    degrades to a miss instead of silently serving another prompt's KV.
    With the parent verified inductively, a hit proves the *entire*
    token prefix up to and including that block is equal — and therefore
    (causal attention) the KV content is too.  Full prompt blocks and
    the partial tail block are both indexed; a partial-tail hit is what
    later forces copy-on-write when the sharer appends its first
    divergent token (:meth:`PagedKVCache.append_tokens`).

    Entries never pin blocks: the index holds no reference, and
    :meth:`evict` must be called with every block returning to the free
    list or being reclaimed off the cached list
    (``BlockAllocator.free`` returns the former; ``alloc`` evicts the
    latter itself), so a key can never resolve to a block that was
    recycled to another request.  An entry *may* point at a refcount-0
    block as long as it sits on the allocator's cached list — that is
    the persistent-cache state; check ``BlockAllocator.is_live`` before
    sharing.
    """

    def __init__(self):
        self._by_key: dict = {}     # key -> (block, parent, span)
        self._by_block: dict = {}   # block id -> key
        self.hits = 0
        self.queries = 0

    def __len__(self) -> int:
        return len(self._by_key)

    def note_lookup(self, queries: int, hits: int) -> None:
        """Record a batch of lookup outcomes in the hit-rate counters
        (kept behind a method so backends never write index state)."""
        self.queries += queries
        self.hits += hits

    @staticmethod
    def chain(parent: Optional[int], tokens) -> int:
        """Key of the block holding ``tokens``, whose predecessor block
        (None for the first) hashed to ``parent``."""
        return hash((parent, tuple(int(t) for t in np.asarray(tokens))))

    def keys_for(self, tokens, block_size: int) -> list[tuple]:
        """Chained ``(key, parent, span)`` triples for a prompt: one per
        full block plus one for the partial tail (if any), in block
        order.  ``span`` is the block's token tuple — lookup/register
        verify it so hash collisions cannot alias prefixes."""
        tokens = np.asarray(tokens)
        out: list[tuple] = []
        parent = None
        for start in range(0, len(tokens), block_size):
            span = tuple(int(t) for t in tokens[start:start + block_size])
            key = self.chain(parent, span)
            out.append((key, parent, span))
            parent = key
        return out

    def lookup(self, key: int, parent: Optional[int],
               span: tuple) -> Optional[int]:
        """Block id whose verified content chain matches, else None."""
        entry = self._by_key.get(key)
        if entry is None:
            return None
        block, p, s = entry
        if p != parent or s != span:
            return None             # 64-bit hash collision: a miss
        return block

    def register(self, key: int, parent: Optional[int], span: tuple,
                 block: int) -> None:
        """First registration wins; a block maps to at most one key."""
        if key not in self._by_key and block not in self._by_block:
            self._by_key[key] = (block, parent, span)
            self._by_block[block] = key

    def contains_block(self, block: int) -> bool:
        """True when ``block`` backs an index entry (referenced or
        cached holder of some prefix span)."""
        return block in self._by_block

    def evict(self, blocks) -> None:
        for b in blocks:
            key = self._by_block.pop(b, None)
            if key is not None:
                del self._by_key[key]


@dataclasses.dataclass
class PagedKVCache:
    """One layer-stacked paged cache + per-request block tables."""

    k_pool: torch.Tensor         # (layers, n_blocks, block, Hkv, hd)
    v_pool: torch.Tensor
    block_tables: np.ndarray     # (B, max_blocks) int32, host-managed
    lengths: np.ndarray          # (B,) int32, host mirror
    block_size: int
    allocator: BlockAllocator
    req_blocks: dict = dataclasses.field(default_factory=dict)

    # optional prefix cache (see PrefixIndex): when set, appends into
    # shared blocks copy-on-write first and last-ref drops either evict
    # (evict="admission") or retain on the allocator's LRU cached list
    # (evict="lru").  The index lives on the allocator so the
    # cached-state machinery (retain / revive / reclaim-evict) and the
    # index can never disagree about a block's liveness.
    @property
    def prefix(self) -> Optional[PrefixIndex]:
        return self.allocator.prefix

    @prefix.setter
    def prefix(self, value: Optional[PrefixIndex]) -> None:
        self.allocator.prefix = value

    @classmethod
    def create(cls, *, n_layers: int, n_blocks: int, block_size: int,
               n_kv_heads: int, head_dim: int, max_requests: int,
               max_blocks_per_req: int, device, dtype=torch.bfloat16,
               prefix_evict: str = "lru"):
        """A zeroed pool on ``device`` (required: the backend passes its
        own, so a card's engine never builds its pool on the CPU)."""
        z = torch.zeros((n_layers, n_blocks, block_size, n_kv_heads,
                         head_dim), dtype=dtype, device=device)
        return cls(
            k_pool=z, v_pool=torch.zeros_like(z),
            block_tables=np.full((max_requests, max_blocks_per_req), -1,
                                 dtype=np.int32),
            lengths=np.zeros(max_requests, dtype=np.int32),
            block_size=block_size,
            allocator=BlockAllocator(n_blocks, evict=prefix_evict),
        )

    # -- host-side bookkeeping -------------------------------------------
    def _free(self, blocks: list[int]) -> None:
        # blocks the allocator actually returned to the free list must
        # leave the index; indexed last-ref drops in "lru" mode are
        # retained (cached) by the allocator and stay indexed until
        # reclaim evicts them
        released = self.allocator.free(blocks)
        if self.prefix is not None and released:
            self.prefix.evict(released)

    def admit(self, slot: int, prompt_len: int,
              shared: tuple[int, ...] = ()) -> None:
        """Reserve blocks for a request's prompt KV (after prefill).

        ``shared`` is a leading run of already-populated block ids (a
        prefix-cache hit, see :class:`PrefixIndex`): they are pinned via
        ``add_ref`` and become this request's first blocks copy-free; only
        the remaining blocks are freshly allocated."""
        n = -(-max(prompt_len, 1) // self.block_size)
        shared = list(shared[:n])
        pinned: list[int] = []
        try:
            for b in shared:
                self.allocator.add_ref(b)
                pinned.append(b)
            blocks = shared + self.allocator.alloc(n - len(shared))
        except (MemoryError, ValueError):
            # roll back the pins so a failed admit leaks nothing (RA205)
            self._free(pinned)
            raise
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :n] = blocks
        self.lengths[slot] = prompt_len
        self.req_blocks[slot] = blocks

    def set_length(self, slot: int, length: int) -> None:
        """Set ``slot``'s written-KV length (resume paths where the
        victim decoded past the cap on frozen KV keep their RoPE
        position counter instead of restarting at the cap)."""
        self.lengths[slot] = int(length)

    def adopt_blocks(self, slot: int, blocks: list[int],
                     length: int) -> None:
        """Point ``slot`` at ``blocks`` — already owned by the caller
        via ``alloc``/``add_ref`` — and set its length.  This is the
        supported way for backends to rebind a slot's table (swap-in,
        chunk-prefix seeding) without touching pool internals."""
        blocks = list(blocks)
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :len(blocks)] = blocks
        self.req_blocks[slot] = blocks
        self.lengths[slot] = int(length)

    def _cow(self, slot: int, bi: int) -> tuple[int, int]:
        """Copy-on-write block ``bi`` of ``slot``: allocate a private
        copy, repoint the table, drop the shared reference.  Returns the
        (old, new) ids; the caller batches the pool copies."""
        blocks = self.req_blocks[slot]
        old = blocks[bi]
        new = self.allocator.alloc(1)[0]
        self._free([old])   # refcount > 1 here, so never released
        blocks[bi] = new
        self.block_tables[slot, bi] = new
        return old, new

    def _apply_cow(self, pairs: list[tuple[int, int]]) -> None:
        if not pairs:
            return
        dev = self.k_pool.device
        old = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                           device=dev)
        new = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                           device=dev)
        # the gather of ``old`` is a copy taken before ``new`` is written
        self.k_pool[:, new] = self.k_pool[:, old]
        self.v_pool[:, new] = self.v_pool[:, old]

    def append_token(self, slot: int) -> None:
        """Grow by one token; allocate a new block at block boundaries
        and copy-on-write a shared last block before the append lands in
        it.  Same freeze-at-capacity overflow semantics as
        :meth:`append_tokens` (a full block table stops growing)."""
        self.append_tokens(np.asarray([slot]))

    def append_tokens(self, slots: np.ndarray) -> None:
        """Batched grow-by-one-token for every slot in ``slots``: a block
        is allocated only for rows crossing a block boundary
        (1/block_size of decode steps per slot), and a row about to
        append into a *shared* block (refcount > 1 — prefix-cache
        partial-tail hit) first copies it on write so the divergent
        token never corrupts the other holders.

        A slot whose block table is already full stops growing: its
        length keeps counting (positions matter for RoPE) but the
        overflow token's KV has nowhere to land and is dropped — the
        same freeze-at-capacity behavior as the contiguous slot layout,
        whose writes past ``max_seq_len`` fall off the scatter."""
        slots = np.asarray(slots)
        self.lengths[slots] += 1
        crossing = (self.lengths[slots] - 1) % self.block_size == 0
        max_blocks = self.block_tables.shape[1]
        for s in slots[crossing]:
            s = int(s)
            blocks = self.req_blocks[s]
            need = min(-(-int(self.lengths[s]) // self.block_size),
                       max_blocks)
            if len(blocks) >= need:
                # table full (frozen KV) or the crossing position is
                # already covered (admit() reserves >= 1 block even for
                # an empty prompt, whose first token lands at pos 0)
                continue
            new = self.allocator.alloc(1)
            self.block_tables[s, len(blocks)] = new[0]
            blocks.extend(new)
        cow_pairs = []
        for s in slots[~crossing]:
            s = int(s)
            bi = (int(self.lengths[s]) - 1) // self.block_size
            blocks = self.req_blocks.get(s, [])
            if bi < len(blocks) and self.allocator.ref_count(blocks[bi]) > 1:
                cow_pairs.append(self._cow(s, bi))
        self._apply_cow(cow_pairs)

    def ensure_capacity(self, slot: int, new_len: int) -> None:
        """Grow a slot's block list to cover ``new_len`` tokens (chunked
        prefill: blocks are allocated chunk by chunk, not all at
        admission) and set its length.  ``need`` is clamped to the block
        table's width: growth past a full table freezes the block list
        (same freeze-at-capacity semantics as :meth:`append_tokens` —
        the length keeps counting, overflow writes are dropped) instead
        of raising a shape-mismatch ``ValueError`` on the table row."""
        blocks = self.req_blocks.setdefault(slot, [])
        need = min(-(-max(new_len, 1) // self.block_size),
                   self.block_tables.shape[1])
        if need > len(blocks):
            new = self.allocator.alloc(need - len(blocks))
            self.block_tables[slot, len(blocks):need] = new
            blocks.extend(new)
        self.lengths[slot] = new_len

    def append_demand(self, slots: np.ndarray) -> int:
        """Blocks :meth:`append_tokens` would allocate for ``slots`` —
        boundary crossings plus copy-on-write of shared last blocks.  The
        engine pre-budgets this and preempts until the pool can serve it,
        so the allocator never raises mid-decode."""
        slots = np.asarray(slots)
        if slots.size == 0:
            return 0
        max_blocks = self.block_tables.shape[1]
        need = 0
        for s in slots:
            s = int(s)
            pos = int(self.lengths[s])          # write position after +1
            blocks = self.req_blocks.get(s, [])
            if pos % self.block_size == 0:
                covered = min(-(-(pos + 1) // self.block_size),
                              max_blocks)
                need += len(blocks) < covered
            else:
                bi = pos // self.block_size
                need += (bi < len(blocks)
                         and self.allocator.ref_count(blocks[bi]) > 1)
        return need

    def release(self, slot: int) -> None:
        blocks = self.req_blocks.pop(slot, [])
        self._free(blocks)
        self.block_tables[slot, :] = -1
        self.lengths[slot] = 0

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by live requests.  Cached (refcount-0,
        reclaimable) blocks are excluded: they are opportunistic reuse
        of memory nobody demands, not resident footprint — a warm
        persistent cache must not read as KV pressure."""
        return (self.allocator.n_blocks - self.allocator.n_free
                - self.allocator.n_cached)

    def resident_bytes(self) -> int:
        """Bytes of KV actually occupied by live requests (both pools,
        all layers) — the paging win is this scaling with tokens rather
        than with n_slots * max_seq_len."""
        layers = self.k_pool.shape[0]
        per_block = int(np.prod(self.k_pool.shape[2:]))
        return 2 * self.used_blocks * layers * per_block \
            * self.k_pool.element_size()

    def utilization(self) -> float:
        return self.used_blocks / max(self.allocator.n_blocks, 1)

    # -- device-side ops ---------------------------------------------------
    def write_blocks(self, blocks, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write whole blocks of every layer in place: k/v are (layers,
        len(blocks), block, Hkv, hd), cast to the pool dtype."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.k_pool.device)
        self.k_pool[:, idx] = k.to(self.k_pool.dtype)
        self.v_pool[:, idx] = v.to(self.v_pool.dtype)

    def write_prompt(self, layer: int, slot: int, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """Scatter a prompt's KV (S, Hkv, hd) into this request's blocks."""
        S = k.shape[0]
        bs = self.block_size
        n = -(-S // bs)
        pad = n * bs - S
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kb = k.reshape(n, bs, *k.shape[1:])
        vb = v.reshape(n, bs, *v.shape[1:])
        idx = torch.as_tensor(self.block_tables[slot, :n].astype(np.int64),
                              device=self.k_pool.device)
        self.k_pool[layer, idx] = kb.to(self.k_pool.dtype)
        self.v_pool[layer, idx] = vb.to(self.v_pool.dtype)

    def write_token(self, layer: int, slot: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Write one token's KV (Hkv, hd) at the current length position.

        A frozen slot (length counted past a full block table — see
        :meth:`append_tokens`) has nowhere for the write to land: it is
        dropped, matching the batched decode path's ``in_cap`` clamp in
        ``cache_backend.py`` instead of indexing off the table row."""
        pos = int(self.lengths[slot]) - 1
        if pos // self.block_size >= self.block_tables.shape[1]:
            return                   # frozen KV: overflow write dropped
        blk = int(self.block_tables[slot, pos // self.block_size])
        off = pos % self.block_size
        self.k_pool[layer, blk, off] = k.to(self.k_pool.dtype)
        self.v_pool[layer, blk, off] = v.to(self.v_pool.dtype)
