"""Fault tolerance (port of `repro.ft`: preemption, straggler detection,
and the serve half of elastic re-meshing, `elastic.plan_serve_mesh`; the
trainer's re-mesh is ROADMAP item 12c)."""
from .preemption import PreemptionHandler
from .straggler import StepTimer

__all__ = ["PreemptionHandler", "StepTimer"]
