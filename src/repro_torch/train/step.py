"""Train-step factory (port of `repro.train.step`): loss -> backward ->
clip -> (optional int8 error-feedback compression) -> optimizer -> params.

The state is a plain dict tree — ``{"params", "opt", "step"}`` plus
``"ef_err"`` with compression — so checkpointing stays structural.  A step
is functional, as the reference's: it returns a new state and leaves the
one it was given untouched (the caller drops the old one; the reference
donates it).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import Model
from repro_torch.optim import apply_updates, clip_by_global_norm, get_optimizer
from repro_torch.optim.compress import ErrorFeedbackInt8
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def default_optimizer(cfg: ArchConfig):
    sched = warmup_cosine(3e-4, 200, 10000)
    if cfg.optimizer == "adafactor":
        return get_optimizer("adafactor", sched)
    # bf16 moments for the bigger adamw archs (memory lever)
    mdt = torch.bfloat16 if cfg.fsdp else None
    return get_optimizer("adamw", sched, moment_dtype=mdt)


def init_train_state(model: Model, seed: int = 0, optimizer=None,
                     grad_compress: bool = False, *, device=None) -> dict:
    """Fresh params from ``seed`` (on the CUDA device unless ``device`` is
    given), the optimizer's state and step 0."""
    opt = optimizer or default_optimizer(model.cfg)
    params = model.init(seed, device=resolve_device(device))
    state = {
        "params": params,
        "opt": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if grad_compress:
        state["ef_err"] = ErrorFeedbackInt8().init(params)
    return state


def make_train_step(model: Model, optimizer=None, clip_norm: float = 1.0,
                    grad_compress: bool = False):
    """``train_step(state, batch) -> (new_state, {"loss", "grad_norm"})``;
    ``batch`` holds tensors on the params' device (`data.batch_to_torch`).
    The metrics are 0-d tensors: reading them waits for the device."""
    opt = optimizer or default_optimizer(model.cfg)

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        leaves = tree_leaves(params)
        loss = model.loss(params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            if grad_compress:
                grads, new_err, _ = ErrorFeedbackInt8().compress(
                    grads, state["ef_err"])
            updates, new_opt = opt.update(grads, state["opt"], state["params"])
            new_state = {
                "params": apply_updates(state["params"], updates),
                "opt": new_opt,
                "step": state["step"] + 1,
            }
        if grad_compress:
            new_state["ef_err"] = new_err
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
