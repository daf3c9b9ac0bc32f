"""Data pipeline: synthetic token batches, workload length distributions,
and arrival traces (Poisson / bursty / batched-rounds)."""
from .synthetic import (  # noqa: F401
    BURSTGPT_LIKE,
    LONGBENCH_HEAVY,
    LONGBENCH_LIKE,
    UNIFORM_PREFILL,
    WorkloadSpec,
    decode_sampler,
    prefill_sampler,
    token_batches,
)
from .traces import (  # noqa: F401
    batched_rounds_instance,
    bursty_trace,
    diurnal_trace,
    overload_rate,
    poisson_trace,
)
