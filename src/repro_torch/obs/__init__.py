"""Per-request span recording (the engine's tracing hooks)."""
from .trace import (  # noqa: F401
    FLEET_TRACK,
    NULL_RECORDER,
    NullRecorder,
    SpanRecorder,
    read_trace,
    to_chrome_trace,
    write_trace,
)
