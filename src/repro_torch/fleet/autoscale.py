"""Autoscaling policies for the event-driven fleet.

The async fleet (:mod:`repro_torch.fleet.async_server`) closes a control loop
the barrier fleet cannot: replica count R becomes a *decision variable*.
At every decision boundary (``interval_s`` on the fleet clock) the
server hands the active :class:`Autoscaler` a dict of signals derived
from the same telemetry stream the offline scorecard reads —
utilization over the window, queue depth, windowed SLO attainment —
and the policy returns a target replica count in ``[r_min, r_max]``.
The server then warms cold replicas (they join after ``warmup_s`` with
*shared* params — one copy of the weights serves every replica, so
scale-up loads nothing) or drains active ones (resident requests hand
off bit-exactly via the engine's host-staged swap path and re-enter the
fleet queue; see ``AsyncFleetServer._drain_now``).

Policies mirror production autoscalers:

* :class:`TargetUtilizationAutoscaler` — hold busy-fraction near a
  target (the classic CPU-target loop): R rises when the fleet runs
  hot or a queue builds, falls on the diurnal trough when replicas sit
  idle drawing ``P_idle`` — the paper's waste term, removed at the
  fleet tier by powering the idle replicas off;
* :class:`SLOAutoscaler` — scale on the *outcome* instead of the
  proxy: windowed SLO attainment below target (or a building queue)
  adds replicas, sustained low utilization at healthy attainment
  removes them.

Both are deliberately deterministic pure functions of the signal dict,
so autoscaled runs are reproducible end to end.
"""
from __future__ import annotations

import math

__all__ = [
    "Autoscaler",
    "TargetUtilizationAutoscaler",
    "SLOAutoscaler",
    "make_autoscaler",
]


class Autoscaler:
    """Decision protocol: signals in, target replica count out.

    ``signals`` (all fleet-clock / windowed since the last decision):

    * ``t`` — fleet clock (s);
    * ``n_active`` — replicas currently active (serving or drainable);
    * ``n_on`` — replicas drawing power (active + warming + draining);
    * ``utilization`` — busy-seconds / powered-seconds over the window,
      or None when the window had no powered time;
    * ``queue_depth`` — requests waiting at the fleet router plus
      requests queued inside replicas;
    * ``window_slo`` — SLO attainment over requests finished in the
      window, or None when none finished;
    * ``pending`` — not-yet-due future arrivals still scheduled.

    ``decide`` may return any int; the server clips it to
    ``[r_min, min(r_max, R)]``.
    """

    name = "base"

    def __init__(self, r_min: int = 1, r_max: int = 8,
                 interval_s: float = 0.5, warmup_s: float = 0.25):
        if r_min < 1:
            raise ValueError(f"r_min must be >= 1, got {r_min}")
        if r_max < r_min:
            raise ValueError(
                f"r_max ({r_max}) must be >= r_min ({r_min})")
        self.r_min = int(r_min)
        self.r_max = int(r_max)
        self.interval_s = float(interval_s)
        self.warmup_s = float(warmup_s)

    def decide(self, signals: dict) -> int:
        raise NotImplementedError


class TargetUtilizationAutoscaler(Autoscaler):
    """Hold windowed busy-fraction near ``target``.

    Want = ceil(n_active * utilization / target): the replica count at
    which the window's observed busy-seconds would have run at exactly
    the target utilization.  A non-empty queue with the fleet already
    at-or-above target bumps the want by one (the queue is demand the
    busy-fraction has not absorbed yet).  With no utilization signal
    (nothing powered in the window) the policy holds R steady.
    """

    name = "util"

    def __init__(self, r_min: int = 1, r_max: int = 8,
                 target: float = 0.6, interval_s: float = 0.5,
                 warmup_s: float = 0.25):
        super().__init__(r_min=r_min, r_max=r_max,
                         interval_s=interval_s, warmup_s=warmup_s)
        if not 0.0 < target <= 1.0:
            raise ValueError(
                f"target utilization must be in (0, 1], got {target}")
        self.target = float(target)

    def decide(self, signals: dict) -> int:
        util = signals.get("utilization")
        n_active = int(signals["n_active"])
        if util is None:
            return n_active
        want = max(int(math.ceil(n_active * util / self.target)), 1)
        if signals.get("queue_depth", 0) > 0 and util >= self.target:
            want = max(want, n_active + 1)
        return want


class SLOAutoscaler(Autoscaler):
    """Scale on windowed SLO attainment (the outcome) with a
    low-utilization scale-down guard.

    * attainment below ``attain_target`` (or a queue at least as deep
      as the active replica count) -> add a replica;
    * attainment healthy *and* utilization under ``low_util`` with an
    empty queue -> remove one;
    * otherwise hold.  Missing signals (no requests finished, nothing
      powered) never trigger a move on their own.
    """

    name = "slo"

    def __init__(self, r_min: int = 1, r_max: int = 8,
                 attain_target: float = 0.95, low_util: float = 0.35,
                 interval_s: float = 0.5, warmup_s: float = 0.25):
        super().__init__(r_min=r_min, r_max=r_max,
                         interval_s=interval_s, warmup_s=warmup_s)
        self.attain_target = float(attain_target)
        self.low_util = float(low_util)

    def decide(self, signals: dict) -> int:
        n_active = int(signals["n_active"])
        slo = signals.get("window_slo")
        util = signals.get("utilization")
        queue = signals.get("queue_depth", 0)
        if (slo is not None and slo < self.attain_target) \
                or queue >= max(n_active, 1):
            return n_active + 1
        if (slo is None or slo >= self.attain_target) \
                and util is not None and util < self.low_util \
                and queue == 0:
            return n_active - 1
        return n_active


def make_autoscaler(name, **kw) -> Autoscaler:
    """Factory mirroring :func:`~repro_torch.fleet.router.make_router`:
    ``"util"`` / ``"slo"`` (an :class:`Autoscaler` instance passes
    through)."""
    if isinstance(name, Autoscaler):
        return name
    name = str(name).lower()
    if name in ("util", "utilization", "target_util"):
        return TargetUtilizationAutoscaler(**kw)
    if name == "slo":
        return SLOAutoscaler(**kw)
    raise ValueError(f"unknown autoscaler {name!r}")
