"""Memory-pressure subsystem for the paged KV backend: victim selection,
swap staging, and resume state.

When the :class:`~repro.serving.paged_cache.BlockAllocator` cannot serve a
growth or admission request, the engine asks the
:class:`~repro.serving.scheduler.Scheduler` for a *victim* among the
active slots (:class:`PreemptionPolicy`, LIFO by default — the vLLM
choice: the most recently admitted request has the least sunk work and,
under FCFS-ish admission, the longest expected wait ahead of it anyway).
The victim's blocks are then either

* **swapped** to a host-side staging buffer (``preemption_mode="swap"``) —
  a tiled device→host copy into pinned host memory
  (:func:`swap_out_blocks` / :func:`swap_in_blocks`; ``SWAP_TILE_BLOCKS``
  blocks per transfer), restored bit-for-bit on resume; or
* **dropped** for recompute-on-resume (``preemption_mode="recompute"``) —
  the request re-enters admission and its KV is rebuilt by re-prefilling
  ``prompt + generated[:-1]`` through the existing (chunked) prefill path.

Either way the victim keeps its generated tokens and re-enters the wait
queue at the front; :class:`PreemptedState` carries everything resume
needs.  Swap-resume is bit-exact on dense models (no arithmetic happens —
the reference's probe is ``tests/test_preemption.py``); recompute-resume is
numerically equivalent but not bit-pinned (prefill chunk boundaries on
the rebuilt prefix differ from the original incremental decode).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SWAP_TILE_BLOCKS",
    "PreemptContext",
    "PreemptionPolicy",
    "LIFOPreemption",
    "FIFOPreemption",
    "LargestPreemption",
    "make_preemption_policy",
    "PreemptedState",
    "swap_out_blocks",
    "swap_in_blocks",
]

#: Blocks moved per host<->device transfer when swapping a victim's KV.
#: Bounds the staging buffer at tile * block_size * Hkv * hd * layers
#: elements regardless of how long the victim's context is.
SWAP_TILE_BLOCKS = 32


# ----------------------------------------------------------------------
# Victim selection
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PreemptContext:
    """What a victim-selection policy may observe.  All arrays are
    aligned over the candidate slots (active requests only)."""

    slots: np.ndarray        # (m,) flat slot ids of the candidates
    admit_seq: np.ndarray    # (m,) monotonic admission sequence number
    kv_tokens: np.ndarray    # (m,) tokens resident in the pool
    blocks_held: np.ndarray  # (m,) KV blocks held
    prefilling: np.ndarray   # (m,) bool: slot is mid-(chunked-)prefill


class PreemptionPolicy:
    """Pick which active request loses its KV under memory pressure."""

    name = "base"

    def select(self, ctx: PreemptContext) -> int:
        raise NotImplementedError


class LIFOPreemption(PreemptionPolicy):
    """Evict the most recently admitted request (vLLM's default): least
    sunk prefill work, and its re-queue-at-front slot in the wait queue
    restores arrival order almost exactly."""

    name = "lifo"

    def select(self, ctx: PreemptContext) -> int:
        return int(ctx.slots[int(np.argmax(ctx.admit_seq))])


class FIFOPreemption(PreemptionPolicy):
    """Evict the oldest request — pathological on purpose (starves the
    head of the line); useful as an adversarial baseline in benchmarks."""

    name = "fifo"

    def select(self, ctx: PreemptContext) -> int:
        return int(ctx.slots[int(np.argmin(ctx.admit_seq))])


class LargestPreemption(PreemptionPolicy):
    """Evict the request holding the most KV blocks (frees the most pool
    per preemption; ties broken toward the most recently admitted)."""

    name = "largest"

    def select(self, ctx: PreemptContext) -> int:
        held = ctx.blocks_held.astype(np.int64)
        score = held * (ctx.admit_seq.max() + 1) + ctx.admit_seq
        return int(ctx.slots[int(np.argmax(score))])


_POLICIES = {p.name: p for p in
             (LIFOPreemption, FIFOPreemption, LargestPreemption)}


def make_preemption_policy(name: str) -> PreemptionPolicy:
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown preemption policy {name!r} "
            f"(expected one of {sorted(_POLICIES)})") from None


# ----------------------------------------------------------------------
# Resume state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PreemptedState:
    """Everything a preempted request needs to resume.

    ``mode="swap"`` carries the victim's KV blocks in host memory
    (``k_host``/``v_host``: CPU tensors, pinned when the pool is on a
    card, shape (layers, n_blocks, block, Hkv, hd));
    ``mode="recompute"`` carries only the bookkeeping and the KV is
    rebuilt by re-prefilling on resume.  ``prefill_done >= 0`` marks a
    victim taken mid-(chunked-)prefill: resume re-registers its prefill
    job at that offset instead of entering decode.
    """

    mode: str                # "swap" | "recompute"
    length: int              # KV tokens resident at preemption
    next_token: int = -1     # pending decode input (decode-phase victims)
    k_host: Optional[torch.Tensor] = None
    v_host: Optional[torch.Tensor] = None
    prefill_done: int = -1   # -1: victim was decoding
    prefill_tokens: Optional[np.ndarray] = None
    resume_token: Optional[int] = None   # carried PrefillJob.resume_token
    resume_length: Optional[int] = None  # carried PrefillJob.resume_length

    @property
    def n_blocks(self) -> int:
        return 0 if self.k_host is None else int(self.k_host.shape[1])


# ----------------------------------------------------------------------
# Tiled swap copies
# ----------------------------------------------------------------------

def swap_out_blocks(pool, blocks, tile: int = SWAP_TILE_BLOCKS):
    """Copy ``blocks`` of a device pool (layers, n_blocks, block, Hkv, hd)
    into one host tensor, ``tile`` blocks per transfer.  The host tensor
    is pinned when the pool lives on a card, so each tile is one DMA."""
    blocks = np.asarray(blocks, np.int64)
    if blocks.size == 0:
        return None
    host = torch.empty((pool.shape[0], blocks.size) + tuple(pool.shape[2:]),
                       dtype=pool.dtype, pin_memory=pool.is_cuda)
    for i in range(0, blocks.size, tile):
        idx = torch.as_tensor(blocks[i:i + tile], device=pool.device)
        host[:, i:i + tile] = pool[:, idx].cpu()
    return host


def swap_in_blocks(pool, blocks, host, tile: int = SWAP_TILE_BLOCKS):
    """Copy a host tensor from :func:`swap_out_blocks` back into fresh
    ``blocks`` of the device pool, tile by tile, in place.  Returns the
    pool."""
    blocks = np.asarray(blocks, np.int64)
    if blocks.size == 0:
        return pool
    for i in range(0, blocks.size, tile):
        idx = torch.as_tensor(blocks[i:i + tile], device=pool.device)
        pool[:, idx] = host[:, i:i + tile].to(pool.device, pool.dtype)
    return pool
