"""Observability: per-request span recording (the engine's and fleet's
tracing hooks) and the barrier straggler ledger that attributes the
fleet's idle energy to causes, bit-exactly against telemetry."""
from .ledger import (  # noqa: F401
    IDLE_CAUSES,
    StragglerLedger,
    attribute_step_idle,
    fold_sum,
    reconcile_split,
)
from .trace import (  # noqa: F401
    FLEET_TRACK,
    NULL_RECORDER,
    NullRecorder,
    SpanRecorder,
    read_trace,
    to_chrome_trace,
    write_trace,
)
