"""Serving substrate of the port: the multi-group retrieval stack.

Sync and async weight-routed frontends over a shared batching core,
group states paged through a budgeted ``StateCache``, a real-time
``ServiceDriver`` with predictive prefetch and cost-aware eviction, and
multi-tenant QoS (admission control, weighted-fair dequeue, SLO-aware
(c, k) degradation), streaming inserts, deletes and compaction
(``DeltaIndex``), plus the LM decode loop and samplers.
"""

from .async_service import (
    AsyncRetrievalService,
    ManualClock,
    Overloaded,
    QueryAnswer,
    QueryFuture,
    replay_open_loop,
)
from .batching import (
    Batcher,
    BatchPlan,
    coalesce,
    merge_topk,
    pad_take,
    run_plans,
)
from .decode import SamplerConfig, generate, make_serve_step
from .delta import DeltaIndex, DeltaStats
from .qos import (
    DEFAULT_TENANT,
    DeficitRoundRobin,
    DegradeStep,
    QosClass,
    QosScheduler,
    RateLimited,
    TenantStats,
    TokenBucket,
)
from .scheduler import (
    CostAwareEviction,
    DeadlinePrefetch,
    DriverStats,
    EvictionPolicy,
    LRUEviction,
    PrefetchPolicy,
    ServiceDriver,
    replay_with_driver,
)
from .state_cache import (
    CacheStats,
    EvictionCandidate,
    RestoreCostModel,
    StateCache,
)
from .retrieval import (
    GroupServeStats,
    RetrievalResult,
    RetrievalService,
    ServiceConfig,
)

__all__ = [
    "AsyncRetrievalService",
    "BatchPlan",
    "Batcher",
    "CacheStats",
    "CostAwareEviction",
    "DEFAULT_TENANT",
    "DeadlinePrefetch",
    "DeficitRoundRobin",
    "DegradeStep",
    "DeltaIndex",
    "DeltaStats",
    "DriverStats",
    "EvictionCandidate",
    "EvictionPolicy",
    "GroupServeStats",
    "LRUEviction",
    "ManualClock",
    "Overloaded",
    "PrefetchPolicy",
    "QosClass",
    "QosScheduler",
    "QueryAnswer",
    "QueryFuture",
    "RateLimited",
    "RestoreCostModel",
    "RetrievalResult",
    "RetrievalService",
    "SamplerConfig",
    "ServiceConfig",
    "ServiceDriver",
    "StateCache",
    "TenantStats",
    "TokenBucket",
    "coalesce",
    "generate",
    "make_serve_step",
    "merge_topk",
    "pad_take",
    "replay_open_loop",
    "replay_with_driver",
    "run_plans",
]
