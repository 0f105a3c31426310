"""Train-step factory (port of `repro.train.step`): loss -> backward ->
clip -> (optional int8 error-feedback compression) -> optimizer -> params.

The state is a plain dict tree — ``{"params", "opt", "step"}`` plus
``"ef_err"`` with compression — so checkpointing and sharding stay
structural (`train_state_axes`).  A step is functional, as the reference's:
it returns a new state and leaves the one it was given untouched (the
caller drops the old one; the reference donates it).

**The train mesh.**  ``make_train_step(model, mesh=...)`` runs the step on
a mesh of logical devices (`launch.mesh`; the state placed by
`ft.elastic.reshard_state`), where the reference's GSPMD placement becomes
explicit, so that one device's numerics are kept up to a fixed
reassociation of sums:

* ``batch`` -> (pod, data): the rows split into `Mesh.n_rows` contiguous
  data groups (`launch.mesh.data_groups`); group i runs the forward and
  backward on its rows on mesh row i.  The loss is the sum of the groups'
  cross-entropy sums over the batch's unmasked-label count (not a mean of
  group means), and the gradients add in group order 0 .. n-1.  An MoE
  arch runs its groups layer by layer in lockstep and routes the whole
  batch at once (`models.transformer.loss_parts_groups`), so capacity and
  drops are one device's.
* heads / ``d_ff`` / ``d_inner`` -> model: inside a group the TP weights
  run as `models.layers.TPSlabs` (`serve.sharding.shard_params(train=
  True)`), column- and row-parallel, the f32 partials added in shard order
  (`layers.psum`), each shard product one library call
  (`layers.plain_tp_products`: a step needs no row invariance).  The
  slabs are views of compute-dtype casts of the params that require grad,
  dealt anew each step, so autograd adds into the whole leaf.  The logits
  run over vocab slabs (`transformer.ce_sums`); the embedding lookup reads
  the whole table.
* ``d_model`` (fsdp archs) -> (pod, data), ``experts`` -> data (EP): the
  leaf's parts are slices per data index, gathered before use.  On one card
  the parts are views of one tensor, so the gather is that tensor.
* a spec that falls back to replicated: the leaf is whole on every device.

The clip's global norm, Adafactor's row and column means and the int8
compression's per-tensor max then run over whole leaves, on the lead
device, as on one device: no reduction is taken per shard.  Every sum
across groups or shards runs in a fixed order, so a repeated step repeats
bit for bit.
"""
from __future__ import annotations

import contextlib

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


def train_state_axes(model: Model, state_shapes=None,
                     grad_compress: bool = False) -> dict:
    """Logical axes of the whole train state (`init_train_state`'s tree):
    the params' axes propagated into the optimizer's moments (Adafactor's
    factored ``vr`` drops a leaf's last dim, ``vc`` its second last), the
    counters and ``step`` unsharded, ``ef_err`` like the params."""
    p_axes = model.axes()

    def walk(node, fn):
        if isinstance(node, dict):
            return {k: walk(v, fn) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, fn) for v in node]
        return fn(node)

    if model.cfg.optimizer == "adafactor":
        def fact(a):
            return {"vr": a[:-1], "vc": a[:-2] + a[-1:]} if len(a) >= 2 else {"v": a}

        opt = {"v": walk(p_axes, fact), "count": ()}
    else:
        opt = {"m": p_axes, "v": p_axes, "count": ()}
    axes = {"params": p_axes, "opt": opt, "step": ()}
    if grad_compress:
        axes["ef_err"] = p_axes
    return axes


def _loss_and_grads(model: Model, params, batch):
    """One device: the loss and its gradients."""
    leaves = tree_leaves(params)
    loss = model.loss(params, batch)
    return loss, torch.autograd.grad(loss, leaves)


def meshed_loss_and_grads(model: Model, params, batch, mesh, *,
                          need_grads: bool = True):
    """The loss of ``batch`` and its gradients over ``params`` (leaves that
    require grad) on the train mesh ``mesh`` (see the module docstring):
    the gradients one tuple per leaf, in `tree_leaves` order, on the leaves'
    device.  ``need_grads=False`` (under ``torch.no_grad``) gives the loss
    alone."""
    from repro_torch.kernels.ops import serve_mesh_scope
    from repro_torch.launch.mesh import data_groups, tree_to
    from repro_torch.models import transformer
    from repro_torch.models.layers import plain_tp_products
    from repro_torch.serve.sharding import APPROX_MODEL_SHARDED_DIMS, shard_params

    cfg = model.cfg
    lead = mesh.lead
    leaves = tree_leaves(params)
    n_rows = batch["labels"].shape[0]
    groups = data_groups(mesh, n_rows)
    count = torch.sum((batch["labels"] >= 0).float()).to(lead)
    denom = torch.clamp(count, min=1.0)
    moe = bool(cfg.n_experts)

    rows_of = [mesh.row(r) for r, _ in groups]

    @contextlib.contextmanager
    def scope(i):
        with serve_mesh_scope(rows_of[i]), plain_tp_products():
            yield

    def group_params(i):
        row = rows_of[i]
        dealt, _ = shard_params(params, row, APPROX_MODEL_SHARDED_DIMS, cfg,
                                train=True)
        return tree_to(dealt, row.lead)

    def group_batch(i):
        rows = groups[i][1]
        return {k: v[rows].to(rows_of[i].lead) for k, v in batch.items()}

    def objective(part):
        total, _, aux = part
        obj = total.to(lead) / denom
        if moe:
            obj = obj + 0.01 * aux.to(lead) / cfg.n_layers
        return obj

    parts, grads = [], None

    def add_grads(part, i):
        nonlocal grads
        with scope(i):
            g = torch.autograd.grad(objective(part), leaves, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x.to(p.device)
             for x, p in zip(g, leaves)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]

    if moe and len(groups) > 1:
        parts = transformer.loss_parts_groups(
            [group_params(i) for i in range(len(groups))], cfg,
            [group_batch(i) for i in range(len(groups))], scope)
        if need_grads:
            for i, part in enumerate(parts):
                add_grads(part, i)
    else:
        for i in range(len(groups)):
            with scope(i):
                part = model.loss_parts(group_params(i), group_batch(i))
            parts.append(part)
            if need_grads:
                add_grads(part, i)
    total, aux = parts[0][0].to(lead), parts[0][2]
    for p in parts[1:]:
        total, aux = total + p[0].to(lead), aux + p[2]
    loss = total / denom
    if moe:
        loss = loss + 0.01 * aux.to(lead) / cfg.n_layers
    return loss, (tuple(grads) if need_grads else None)


def make_train_step(model: Model, optimizer=None, clip_norm: float = 1.0,
                    grad_compress: bool = False, *, mesh=None):
    """``train_step(state, batch) -> (new_state, {"loss", "grad_norm"})``;
    ``batch`` holds tensors on the params' device (`data.batch_to_torch`).
    The metrics are 0-d tensors: reading them waits for the device.

    ``mesh`` (a `launch.mesh.Mesh`) runs the step on the train mesh (see
    the module docstring); the state's tensors live on its lead device
    (`ft.elastic.reshard_state`)."""
    opt = optimizer or default_optimizer(model.cfg)

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        if mesh is None:
            loss, flat = _loss_and_grads(model, params, batch)
        else:
            loss, flat = meshed_loss_and_grads(model, params, batch, mesh)
        grads = tree_unflatten(params, flat)
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
