"""Serving: continuous-batching engine, scheduler and execution policy
(port of `repro.serve`, the sync dense-cache single-device path)."""
from .batching import DenseCacheOps, PackedSpikeCache, bucket_key, pad_batch
from .engine import Cohort, Engine
from .metrics import EngineMetrics, RequestMetrics
from .policy import (
    FLOAT_DENSE,
    PACKED_DENSE,
    PACKED_DUAL,
    PACKED_DUAL_ADAPTIVE,
    Exactness,
    ExecutionPolicy,
    ParityError,
    Temporal,
    adaptive_t,
    approximate,
    bitwise,
    check_parity,
    drift_report,
    max_logit_drift,
)
from .scheduler import (
    AdmissionError,
    AdmissionTicket,
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "AdmissionError", "AdmissionTicket", "Cohort", "DenseCacheOps", "Engine",
    "EngineMetrics", "Exactness", "ExecutionPolicy", "FLOAT_DENSE",
    "PACKED_DENSE", "PACKED_DUAL", "PACKED_DUAL_ADAPTIVE", "PackedSpikeCache",
    "ParityError", "Request", "RequestMetrics", "RequestState", "Scheduler",
    "Temporal", "adaptive_t", "approximate", "bitwise", "bucket_key",
    "check_parity", "drift_report", "max_logit_drift", "pad_batch",
]
