"""Fault tolerance (port of `repro.ft`: preemption, straggler detection,
and elastic re-meshing: the trainer's `elastic.plan_mesh` /
`elastic.reshard_state`, the serve engine's `elastic.plan_serve_mesh`)."""
from .preemption import PreemptionHandler
from .straggler import StepTimer

__all__ = ["PreemptionHandler", "StepTimer"]
