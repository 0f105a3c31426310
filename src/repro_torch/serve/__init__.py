"""Serving: continuous-batching engine, scheduler and execution policy
(port of `repro.serve`, the sync dense single-device path)."""
from .batching import DenseCacheOps, PackedSpikeCache, bucket_key, pad_batch
from .engine import Cohort, Engine
from .metrics import EngineMetrics, RequestMetrics
from .policy import FLOAT_DENSE, PACKED_DUAL, ExecutionPolicy
from .scheduler import (
    AdmissionError,
    AdmissionTicket,
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "AdmissionError", "AdmissionTicket", "Cohort", "DenseCacheOps", "Engine",
    "EngineMetrics", "ExecutionPolicy", "FLOAT_DENSE", "PACKED_DUAL",
    "PackedSpikeCache", "Request", "RequestMetrics", "RequestState",
    "Scheduler", "bucket_key", "pad_batch",
]
