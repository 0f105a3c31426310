"""Optimizer plumbing (port of `repro.optim.common`): optax-like (init,
update) pairs over the port's trees of tensors."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params) -> (updates, opt_state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda t: (t * scale).to(t.dtype), tree), g


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u.to(p.dtype)).to(p.dtype), params,
                    updates)


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)
