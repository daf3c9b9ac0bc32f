"""Serving runtime: the multi-worker decode engine with router-integrated
load balancing, the contiguous slot and paged KV backends (the paged one
vLLM-style blocks with prefix caching), and the admission scheduler with
chunked prefill and preemption under memory pressure."""
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
