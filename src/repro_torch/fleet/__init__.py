"""Fleet serving layer: two-tier BF-IO routing across engine replicas.

The tier above :mod:`repro_torch.serving` — R independent engine replicas
behind a pluggable :class:`~repro_torch.fleet.router.FleetRouter`
(round-robin / least-loaded / power-of-two / BF-IO via the batched
solver / two-level hierarchical pod BF-IO for R in the hundreds),
driven barrier-stepped by :class:`~repro_torch.fleet.server.FleetServer`
(``fleet_mode="vec"`` hot path with a bit-identical ``"ref"``
baseline) or event-driven by
:class:`~repro_torch.fleet.async_server.AsyncFleetServer` (per-replica
clocks, staleness-bounded routing, optional
:mod:`repro_torch.fleet.autoscale` policies with bit-exact drain handoff,
and a ``barrier_compat`` parity oracle), fed by the named scenario
traces of :mod:`repro_torch.fleet.workloads`, and observed through the
JSONL-exporting :mod:`repro_torch.fleet.telemetry` subsystem."""
from .async_server import AsyncFleetServer  # noqa: F401
from .autoscale import (  # noqa: F401
    Autoscaler,
    SLOAutoscaler,
    TargetUtilizationAutoscaler,
    make_autoscaler,
)
from .router import (  # noqa: F401
    BFIORouter,
    FleetRouter,
    LeastLoadedRouter,
    PodBFIORouter,
    PowerOfDRouter,
    RoundRobinRouter,
    RouterContext,
    make_router,
)
from .server import FleetServer  # noqa: F401
from .telemetry import FleetTelemetry, SLOSpec, percentiles  # noqa: F401
from .workloads import (  # noqa: F401
    SCENARIOS,
    FleetRequest,
    Scenario,
    make_scenario,
    validate_scenario,
)
