"""Shared fixed-shape slot-table state for the serving runtime.

The host engine (:mod:`repro_torch.serving.engine`) models the fleet as
G workers x B KV-cache slots, flattened into one table of ``N = G * B``
slots where slot ``s`` belongs to worker ``s // B``.  This module is the
single definition of that layout:

* :func:`slot_worker_map` — the static slot -> worker index map;
* :class:`SlotTable` — numpy array state (``active``, ``load``, per-slot
  request bookkeeping) with vectorized per-worker reductions and free-slot
  allocation, replacing the per-slot Python loops of the seed engine;
* :func:`cap_assignment` — clamp a policy's worker assignment to the
  available per-worker capacities (a policy that over-subscribes a worker
  keeps the excess requests waiting instead of crashing placement).
"""
from __future__ import annotations

import numpy as np

__all__ = ["slot_worker_map", "SlotTable", "cap_assignment"]


def slot_worker_map(G: int, B: int) -> np.ndarray:
    """(G*B,) int64: worker owning each flat slot (slot s -> s // B)."""
    return np.repeat(np.arange(G, dtype=np.int64), B)


def cap_assignment(assignment: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Clamp ``assignment`` (candidate -> worker id, -1 = keep waiting) so
    that at most ``caps[g]`` candidates map to worker g, keeping the
    earliest candidates (arrival order).  Returns a new array with the
    excess entries reset to -1."""
    assignment = np.asarray(assignment, dtype=np.int64)
    out = assignment.copy()
    sel = np.flatnonzero(assignment >= 0)
    if sel.size == 0:
        return out
    g = assignment[sel]
    # running rank of each candidate within its worker (stable in order)
    order = np.argsort(g, kind="stable")
    gs = g[order]
    is_start = np.r_[True, gs[1:] != gs[:-1]]
    group_start = np.maximum.accumulate(
        np.where(is_start, np.arange(gs.size), 0))
    rank_sorted = np.arange(gs.size) - group_start
    rank = np.empty_like(rank_sorted)
    rank[order] = rank_sorted
    caps = np.asarray(caps, dtype=np.int64)
    out[sel[rank >= caps[g]]] = -1
    return out


class SlotTable:
    """Vectorized host-side slot state over the flat G*B table.

    Pure bookkeeping — holds no request objects, only per-slot scalars, so
    every per-worker reduction the engine hot path needs (loads, counts,
    caps, active set) is one numpy op instead of a Python loop over slots.
    """

    def __init__(self, G: int, B: int):
        self.G, self.B = int(G), int(B)
        N = self.G * self.B
        self.N = N
        self.worker = slot_worker_map(G, B)
        self.active = np.zeros(N, dtype=bool)
        self.load = np.zeros(N, dtype=np.float64)
        # chunked prefill: prompt tokens of each slot not yet prefilled.
        # An active slot with prefill_left > 0 holds a mid-prefill request
        # (occupies capacity, contributes its partial load, does not
        # decode).  Always zero when the engine runs synchronous prefill.
        self.prefill_left = np.zeros(N, dtype=np.int64)

    # -- per-worker reductions -----------------------------------------
    def loads(self) -> np.ndarray:
        """(G,) sum of active slot loads per worker."""
        return np.bincount(self.worker,
                           weights=np.where(self.active, self.load, 0.0),
                           minlength=self.G)

    def counts(self) -> np.ndarray:
        """(G,) number of active slots per worker."""
        return np.bincount(self.worker[self.active],
                           minlength=self.G).astype(np.int64)

    def caps(self) -> np.ndarray:
        """(G,) free slots per worker."""
        return self.B - self.counts()

    def active_indices(self) -> np.ndarray:
        """Ascending flat indices of active slots."""
        return np.flatnonzero(self.active)

    def decode_indices(self) -> np.ndarray:
        """Ascending flat indices of slots that are active AND done
        prefilling — the set a barrier decode step runs over."""
        return np.flatnonzero(self.active & (self.prefill_left == 0))

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    # -- mutation -------------------------------------------------------
    def allocate(self, workers: np.ndarray) -> np.ndarray:
        """Claim one free slot per entry of ``workers`` (worker ids, may
        repeat) and mark them active.  Returns the flat slot indices, in
        the same order as ``workers``.  Raises RuntimeError if any worker
        lacks enough free slots (callers should cap assignments first —
        see :func:`cap_assignment`)."""
        workers = np.asarray(workers, dtype=np.int64)
        slots = np.empty(workers.size, dtype=np.int64)
        for g in np.unique(workers):
            mask = workers == g
            lo, hi = g * self.B, (g + 1) * self.B
            free = np.flatnonzero(~self.active[lo:hi]) + lo
            need = int(mask.sum())
            if need > free.size:
                raise RuntimeError(
                    f"worker {g} over-subscribed: {need} placements for "
                    f"{free.size} free slots (policy assignment not capped?)")
            slots[mask] = free[:need]
        self.active[slots] = True
        return slots

    def release(self, slots: np.ndarray) -> None:
        self.active[slots] = False
        self.load[slots] = 0.0
        self.prefill_left[slots] = 0
