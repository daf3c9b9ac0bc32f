"""Serving runtime: the multi-worker decode engine with router-integrated
load balancing, the contiguous slot and paged KV backends (the paged one
vLLM-style blocks with prefix caching), the admission scheduler with
chunked prefill and preemption under memory pressure, and the
device-side routed serving loop."""
from .engine import (  # noqa: F401
    EngineConfig,
    LoadSnapshot,
    ServeRequest,
    ServingEngine,
)
from .cache_backend import (  # noqa: F401
    CacheBackend,
    PagedCacheBackend,
    SlotCacheBackend,
    make_cache_backend,
)
from .device_loop import (  # noqa: F401
    LoopState,
    init_loop_state,
    make_device_serving_loop,
)
from .paged_cache import BlockAllocator, PagedKVCache, PrefixIndex  # noqa: F401
from .preemption import (  # noqa: F401
    FIFOPreemption,
    LargestPreemption,
    LIFOPreemption,
    PreemptContext,
    PreemptedState,
    PreemptionPolicy,
    make_preemption_policy,
)
from .scheduler import PrefillJob, Scheduler  # noqa: F401
from .slot_table import SlotTable, cap_assignment, slot_worker_map  # noqa: F401
