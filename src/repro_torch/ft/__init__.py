"""Fault tolerance of the training loop (port of `repro.ft`: preemption
and straggler detection; elastic re-meshing waits for the multi-device
slice)."""
from .preemption import PreemptionHandler
from .straggler import StepTimer

__all__ = ["PreemptionHandler", "StepTimer"]
