"""The dry run's cells (port of `repro.launch.specs`): (arch x shape [x
mesh]) -> the step function and its inputs, and with a mesh their
placements.

Training cells run the port's `make_train_step`; prefill cells
`Model.prefill`; decode cells (decode_32k, long_500k) `Model.decode`, one
new token against a ``seq_len``-deep cache at its last position.  The
serving cells take their params through `Model.prepare`, as the engine
does.  On the meta device (the dry run) every input is a meta tensor:
shapes and dtypes without values or memory, the params drawn under
`FakeTensorMode` from a CPU `torch.Generator` and then made meta; on a real
device the inputs are real, the params `Model.init`'s from seed 0.

With a train mesh (`launch.mesh.make_production_mesh`) a cell also carries
its inputs' shardings (`repro_torch.sharding`, the reference's rules): a
train cell the train state's (`train.step.train_state_axes`) and the
batch's, a serving cell the params' (as the reference, the logical params
with every matrix in bf16) and the cache's (`Model.cache_axes`); and the
fallback log.  The step itself is the one-device step: the dry run counts
one data group of it (`launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ArchConfig, ShapeCell, applicable_shapes, skip_reason
from repro_torch.data.pipeline import SyntheticLMData, batch_shapes, batch_to_torch
from repro_torch.models.registry import build_model
from repro_torch.sharding import base_rules, batch_specs, tree_shardings
from repro_torch.train.step import default_optimizer, make_train_step, train_state_axes
from repro_torch.tree import tree_map


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    cfg: ArchConfig
    cell: ShapeCell
    # with a mesh: {input name: (tree, its tree of sharding.NamedSharding)}
    # (train: state, batch; prefill: params, batch, cache; decode: params,
    # tokens, cache) and the fallback log
    placed: dict | None = None
    fallback_log: list | None = None


def _meta_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _params(model, device: torch.device) -> dict:
    if device.type != "meta":
        return model.init(0, device=device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = model.init(0, device="cpu")
    return tree_map(_meta_like, fake)


def _batch(cfg: ArchConfig, cell: ShapeCell, device: torch.device) -> dict:
    if device.type == "meta":
        return batch_shapes(cfg, cell)
    data = SyntheticLMData(cfg, cell.seq_len, cell.global_batch)
    return batch_to_torch(data.batch(0), device)


def _bf16_matrices(t):
    """A serving param as the reference places it: every float matrix in
    bf16 (inference casts), vectors as they are."""
    if t.ndim >= 2 and t.is_floating_point():
        return torch.empty(t.shape, dtype=torch.bfloat16, device="meta")
    return _meta_like(t)


def build_cell(arch: str, shape: str, mesh=None, *, cfg: ArchConfig | None = None,
               cell: ShapeCell | None = None, n_layers: int | None = None,
               batch: int | None = None, seq: int | None = None,
               device="meta") -> Cell | None:
    """The cell ready to run (``cell.fn(*cell.args)``), or None if the shape
    is skipped for this arch (`configs.base.skip_reason`).  ``mesh`` adds
    the inputs' placements on it (`Cell.placed`, `Cell.fallback_log`).
    ``cfg`` and ``cell`` replace the arch's config and the shape's cell
    (small CPU tests); ``n_layers``, ``batch`` and ``seq`` cut the depth,
    the batch and the sequence (the dry run's counted points)."""
    cfg = cfg or get_config(arch)
    if cell is None:
        cell = applicable_shapes(cfg)[shape]
        if cell is None:
            return None
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cell = dataclasses.replace(cell, global_batch=batch or cell.global_batch,
                               seq_len=seq or cell.seq_len)
    device = torch.device(device)
    model = build_model(cfg)
    params = _params(model, device)
    B, S = cell.global_batch, cell.seq_len

    rules, log = base_rules(cfg.fsdp), []

    def shardings(tree, axes):
        return (tree, tree_shardings(tree, axes, mesh, rules, log))

    if cell.kind == "train":
        opt = default_optimizer(cfg)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        b = _batch(cfg, cell, device)
        out = Cell(arch, shape, make_train_step(model, opt), (state, b), cfg, cell)
        if mesh is not None:
            out.placed = {"state": shardings(state, train_state_axes(model)),
                          "batch": (b, batch_specs(b, mesh, rules))}
            out.fallback_log = log
        return out

    placed = {}
    if mesh is not None:
        placed["params"] = shardings(tree_map(_bf16_matrices, params),
                                     model.axes())
    params = model.prepare(params)
    cache = model.init_cache(B, S, device=device)
    if cell.kind == "prefill":
        b = _batch(cfg, cell, device)
        b.pop("labels")
        out = Cell(arch, shape, model.prefill, (params, b, cache), cfg, cell)
        if mesh is not None:
            placed["batch"] = (b, batch_specs(b, mesh, rules))
    else:
        # decode: one token at the last position of a seq_len cache
        cache = dict(cache, pos=S - 1)
        tokens = torch.zeros((B, 1), dtype=torch.int64, device=device)
        out = Cell(arch, shape, model.decode, (params, tokens, cache), cfg, cell)
        if mesh is not None:
            placed["tokens"] = shardings(tokens, ("batch", None))
    if mesh is not None:
        placed["cache"] = shardings(cache, model.cache_axes())
        out.placed, out.fallback_log = placed, log
    return out


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) pairs that run, in manifest order."""
    return [(arch, shape) for arch in ARCHS
            for shape, cell in applicable_shapes(get_config(arch)).items()
            if cell is not None]


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, cell in applicable_shapes(cfg).items():
            if cell is None:
                out.append((arch, shape, skip_reason(cfg, shape)))
    return out
