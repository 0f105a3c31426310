"""Optimizers of the training path (port of `repro.optim`)."""
from .adafactor import adafactor
from .adamw import adamw
from .common import Optimizer, apply_updates, clip_by_global_norm, global_norm
from .compress import ErrorFeedbackInt8
from .schedules import constant, warmup_cosine

__all__ = [
    "Optimizer", "adamw", "adafactor", "warmup_cosine", "constant",
    "apply_updates", "clip_by_global_norm", "global_norm", "ErrorFeedbackInt8",
    "get_optimizer",
]


def get_optimizer(name: str, lr_schedule, **kw):
    if name == "adamw":
        return adamw(lr_schedule, **kw)
    if name == "adafactor":
        return adafactor(lr_schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
