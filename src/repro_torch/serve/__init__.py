"""Serving: continuous-batching engine, scheduler, step executors, paged
cache storage, speculative decoding, event-stream prompts, the preemption
handoff, execution policy and the (data, model) serve mesh (port of
`repro.serve`)."""
from .batching import (
    CacheOps,
    DenseCacheOps,
    PackedSpikeCache,
    bucket_key,
    cache_pad_rows,
    pad_batch,
)
from .engine import Cohort, Engine
from .executor import PendingStep, PipelinedExecutor, SyncExecutor, make_executor
from .handoff import Handoff, HandoffRequest, capture_handoff
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
    propose_chain,
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
    Placement,
    Speculation,
    Temporal,
    acceptance_lengths,
    adaptive_t,
    approximate,
    bitwise,
    check_parity,
    draft,
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
    rebalance_pad,
)
from .sharding import make_serve_mesh, mesh_summary, parse_mesh_spec
from .streaming import Backpressure, EventStream, Frame, StreamSession

__all__ = [
    "AdmissionError", "AdmissionTicket", "Backpressure", "CacheOps",
    "CacheStore", "Cohort", "DenseCacheOps", "Engine", "EngineMetrics",
    "EventStream", "Exactness", "ExecutionPolicy", "FLOAT_DENSE", "Frame",
    "Handoff", "HandoffRequest",
    "PACKED_DENSE", "PACKED_DUAL", "PACKED_DUAL_ADAPTIVE", "PackedSpikeCache",
    "PageLayout", "PagePoolExhausted", "PagedCache", "PagedCacheOps",
    "PagedSpikeCache", "Paging", "ParityError", "PendingStep",
    "PipelinedExecutor", "Placement", "PrefixEntry", "RadixPrefixIndex",
    "Request",
    "RequestMetrics", "RequestState", "Scheduler", "Speculation",
    "SpikeSlotPool", "StreamSession", "SyncExecutor", "Temporal",
    "acceptance_lengths", "adaptive_t", "approximate", "bitwise",
    "bucket_key", "cache_pad_rows", "capture_handoff", "check_parity",
    "draft", "drift_report", "make_executor", "make_serve_mesh",
    "max_logit_drift", "mesh_summary", "pad_batch", "paged",
    "parse_mesh_spec", "propose_chain", "rebalance_pad",
]
