"""LR schedules (port of `repro.optim.schedules`): callables from an int32
step tensor to an f32 learning-rate tensor on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=step.device)
