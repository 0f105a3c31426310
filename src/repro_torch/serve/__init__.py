"""Serving: continuous-batching engine, scheduler, step executors, paged
cache storage and execution policy (port of `repro.serve`, one device)."""
from .batching import (
    CacheOps,
    DenseCacheOps,
    PackedSpikeCache,
    bucket_key,
    pad_batch,
)
from .engine import Cohort, Engine
from .executor import PendingStep, PipelinedExecutor, SyncExecutor, make_executor
from .metrics import EngineMetrics, RequestMetrics
from .paging import (
    CacheStore,
    PagedCache,
    PagedCacheOps,
    PagedSpikeCache,
    PageLayout,
    PagePoolExhausted,
    PrefixEntry,
    RadixPrefixIndex,
    SpikeSlotPool,
)
from .policy import (
    FLOAT_DENSE,
    PACKED_DENSE,
    PACKED_DUAL,
    PACKED_DUAL_ADAPTIVE,
    Exactness,
    ExecutionPolicy,
    Paging,
    ParityError,
    Temporal,
    adaptive_t,
    approximate,
    bitwise,
    check_parity,
    drift_report,
    max_logit_drift,
    paged,
)
from .scheduler import (
    AdmissionError,
    AdmissionTicket,
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "AdmissionError", "AdmissionTicket", "CacheOps", "CacheStore", "Cohort",
    "DenseCacheOps", "Engine", "EngineMetrics", "Exactness",
    "ExecutionPolicy", "FLOAT_DENSE", "PACKED_DENSE", "PACKED_DUAL",
    "PACKED_DUAL_ADAPTIVE", "PackedSpikeCache", "PageLayout",
    "PagePoolExhausted", "PagedCache", "PagedCacheOps", "PagedSpikeCache",
    "Paging", "ParityError", "PendingStep", "PipelinedExecutor",
    "PrefixEntry", "RadixPrefixIndex", "Request", "RequestMetrics",
    "RequestState", "Scheduler", "SpikeSlotPool", "SyncExecutor", "Temporal",
    "adaptive_t", "approximate", "bitwise", "bucket_key", "check_parity",
    "drift_report", "make_executor", "max_logit_drift", "pad_batch", "paged",
]
