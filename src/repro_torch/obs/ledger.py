"""Straggler ledger: cause-decomposed barrier-idle accounting.

The fleet's energy theorem prices barrier idle as
``sum_r (dt - dt_r) * P_idle_r`` per step (plus the between-arrival
fast-forward).  This module decomposes those joules by *cause* without
perturbing them: every step's split is reconciled so that a plain
left-fold sum over :data:`IDLE_CAUSES` order reproduces the step's idle
total bit-exactly, and the fleet-wide ledger folds charges in the same
order as ``FleetServer.idle_j`` accumulates — so the two totals are
equal to the last bit, by construction rather than by tolerance.

All arithmetic is plain Python floats + numpy (the charge sites sit on
``host_hot`` paths — see ``repro/analysis/registry.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["IDLE_CAUSES", "StragglerLedger", "attribute_step_idle",
           "fold_sum", "reconcile_split"]

# Cause taxonomy (order is the wire order of telemetry v4 `idle_split`
# rows — append-only; see repro_torch.obs package docstring for semantics).
IDLE_CAUSES = ("prefill_wave", "decode_tail", "preempt_swap",
               "routing_miss", "warmup", "arrival_gap")
N_CAUSES = len(IDLE_CAUSES)
CAUSE_INDEX = {name: i for i, name in enumerate(IDLE_CAUSES)}

# engine step phase -> cause charged to the replicas the gating
# (slowest) replica kept waiting
PHASE_CAUSE = {"preempt": CAUSE_INDEX["preempt_swap"],
               "prefill": CAUSE_INDEX["prefill_wave"]}
_DECODE = CAUSE_INDEX["decode_tail"]


def fold_sum(xs) -> float:
    """Left-fold float sum starting at 0.0 — the canonical
    reconstruction order every exactness gate uses.  (``np.sum`` uses
    pairwise summation and ``math.fsum`` compensated summation; both
    may round differently from the sequential ``+=`` the fleet's
    accumulators perform.)"""
    total = 0.0
    for x in xs:
        total += float(x)
    return total


def reconcile_split(total: float, split: np.ndarray) -> np.ndarray:
    """Return a copy of ``split`` whose :func:`fold_sum` reproduces
    ``total`` bit-exactly: one entry absorbs the (at most few-ulp)
    residual between the independently-summed causes and the
    sequentially-accumulated total.

    The preferred fix-up point is the *last nonzero* entry — it is the
    final inexact term of the fold (trailing ``+ 0.0`` are exact), so
    adjusting it never re-rounds a later addition.  A single entry can
    still provably miss: when it shares ``total``'s binade, the
    reachable fold values step by one ulp of ``total`` and the target
    can fall in a gap.  Each candidate entry has a differently-phased
    rounding grid, so on a miss the fix-up cascades through the
    remaining indices; no real fleet step has ever needed the cascade
    (same-step slack magnitudes are homogeneous), but adversarial
    inputs spanning many decades do (see ``tests/test_obs.py``)."""
    out0 = np.asarray(split, dtype=np.float64).copy()
    nz = np.nonzero(out0)[0]
    last = int(nz[-1]) if nz.size else N_CAUSES - 1
    order = [last] + [k for k in range(N_CAUSES - 1, -1, -1)
                      if k != last]
    for j in order:
        out = out0.copy()
        scale = 1.0
        prev = None
        for _ in range(64):
            delta = float(total) - fold_sum(out)
            if delta == 0.0:
                return out
            if prev is not None and abs(delta) >= prev:
                scale *= 0.5        # overshot: damp onto the target
                if scale == 0.0:
                    break
            prev = abs(delta)
            out[j] += delta * scale
    raise ArithmeticError(
        f"idle split failed to reconcile with total={total!r} "
        f"(split={out0.tolist()!r})")


def attribute_step_idle(idle: float, slack: np.ndarray,
                        causes: np.ndarray) -> np.ndarray:
    """Split one barrier step's idle joules by cause.

    ``slack[r]`` is replica r's idle joules this step and ``causes[r]``
    its cause index; the per-cause masked sums are reconciled against
    ``idle`` (the step total the fleet actually accumulated) so the
    split's fold reproduces it bit-exactly."""
    split = np.zeros(N_CAUSES)
    for c in np.unique(causes):
        split[int(c)] = float(slack[causes == c].sum())
    return reconcile_split(idle, split)


class StragglerLedger:
    """Fleet-wide accumulation of cause-attributed idle charges.

    ``charge`` is called exactly once per ``idle_j += ...`` site in the
    fleet (the barrier accounting's per-step charge; the async fleet's
    per-replica advance charges), with the same float, in the same
    order — so :attr:`total_idle_j` folds to ``FleetServer.idle_j``
    bit-exactly.  ``gating_steps`` counts how often each replica gated
    a barrier step (``-1`` charges — troughs, async ticks — land in
    :attr:`trough_steps`)."""

    def __init__(self):
        self.total_idle_j = 0.0
        self.cause_j = np.zeros(N_CAUSES)
        self.gating_steps: dict[int, int] = {}
        self.trough_steps = 0
        self.charges = 0

    def charge(self, idle: float, split: np.ndarray,
               gating: int = -1) -> None:
        """One attributed idle charge: ``split`` must fold to ``idle``
        (see :func:`attribute_step_idle` / :func:`reconcile_split`)."""
        self.total_idle_j += float(idle)
        self.cause_j += split
        if gating >= 0:
            self.gating_steps[gating] = \
                self.gating_steps.get(gating, 0) + 1
        else:
            self.trough_steps += 1
        self.charges += 1

    def charge_one(self, idle: float, cause: int) -> None:
        """Single-cause charge (the async fleet's per-replica advance):
        the whole charge lands on one cause, trivially exact."""
        split = np.zeros(N_CAUSES)
        split[int(cause)] = float(idle)
        self.charge(idle, split)

    def report(self) -> dict:
        """JSON-native ledger summary."""
        return {
            "total_idle_j": float(self.total_idle_j),
            "by_cause": {name: float(self.cause_j[i])
                         for i, name in enumerate(IDLE_CAUSES)},
            "gating_steps": {str(r): int(n) for r, n
                             in sorted(self.gating_steps.items())},
            "trough_steps": int(self.trough_steps),
            "charges": int(self.charges),
        }

    def format(self) -> str:
        """Human-readable ledger table (the serve-cluster demo print)."""
        lines = [f"straggler ledger: {self.total_idle_j:.3f} J idle "
                 f"over {self.charges} charges"]
        tot = max(self.total_idle_j, 1e-300)
        for i, name in enumerate(IDLE_CAUSES):
            j = float(self.cause_j[i])
            if j != 0.0:
                lines.append(f"  {name:<13s} {j:12.3f} J "
                             f"({100.0 * j / tot:5.1f}%)")
        if self.gating_steps:
            top = sorted(self.gating_steps.items(),
                         key=lambda kv: -kv[1])[:5]
            lines.append("  gating replicas: " + ", ".join(
                f"r{r}x{n}" for r, n in top))
        return "\n".join(lines)
