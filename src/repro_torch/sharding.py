"""Logical-axis sharding rules of the train mesh (port of `repro.sharding`,
MaxText-style, with the reference's divisibility fallback).

Every tensor dim carries a logical name; rules map names to mesh axes.
`spec_for` drops a mesh axis that the mesh lacks, that does not divide the
dim, or that another dim of the same tensor already took, so every arch
places on the fixed production mesh (qwen3's 40 heads or gemma's one KV
head do not split 16 ways and fall back to replicated, which the fallback
log records).

Parallelism encoding (the reference's):
  batch      -> (pod, data)                DP
  *_flat/d_ff/d_inner/vocab/heads -> model TP
  weight d_model (fsdp archs) -> (pod, data)  ZeRO-3 / FSDP
  experts    -> data                       EP
  cache_seq  -> model                      context-sharded KV cache
  residual activations: batch->(pod,data), seq->model     SP

A spec is a tuple with one entry per dim: None, a mesh axis, or a tuple of
mesh axes (the counterpart of a `PartitionSpec`), and a `NamedSharding` is
(mesh, spec).  The mesh is one process's grid of logical devices
(`launch.mesh`): a placed tensor lives whole on the mesh's lead device, and
each device's part (`NamedSharding.parts`) is a view of it when the device
maps onto that card, so on one card no state is held twice.  On another
card a part is a contiguous copy made when it is asked for; a state spread
in storage over several cards is not built (and the multi-card path is
unverified).
How the train step runs on the placement is `train.step`'s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def base_rules(fsdp: bool = False) -> dict:
    return {
        # activations
        "batch": ("pod", "data"),
        "seq": ("model",),            # SP on residual carries
        "act_d": (),                  # activation d_model: replicated
        # params
        "d_model": (("pod", "data") if fsdp else ()),
        "d_model2": (("pod", "data") if fsdp else ()),
        "heads_flat": ("model",),
        "kv_flat": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "d_ff": ("model",),
        "d_inner": ("model",),
        "vocab": ("model",),
        "experts": ("data",),
        "layers": (),
        # serving state
        "cache_seq": ("model",),
        None: (),
    }


def spec_for(shape: tuple, axes: tuple, rules: dict, mesh,
             log: list | None = None) -> tuple:
    """The spec of a tensor of ``shape`` whose dims carry the logical
    ``axes``.  ``mesh`` needs only ``shape`` ({axis: size}).  A mesh axis
    that the mesh lacks, that another dim already took or that does not
    divide the dim is dropped (the last case recorded in ``log``)."""
    used: set = set()
    spec = []
    for dim, name in zip(shape, axes):
        cand = rules.get(name, ())
        if cand is None:
            cand = ()
        if isinstance(cand, str):
            cand = (cand,)
        picked = []
        size = dim
        for ax in cand:
            if ax not in mesh.shape or ax in used:
                continue
            n = mesh.shape[ax]
            if size % n == 0:
                picked.append(ax)
                used.add(ax)
                size //= n
            elif log is not None:
                log.append(f"fallback: axis {name}={dim} not divisible by "
                           f"mesh[{ax}]={n}; replicated")
        spec.append(tuple(picked) if len(picked) > 1
                    else (picked[0] if picked else None))
    return tuple(spec)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement on ``mesh``: dim i split over the mesh axes of
    ``spec[i]`` (the first axis major), replicated over the others."""

    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        out = list(shape)
        for i, entry in enumerate(self.spec):
            out[i] //= math.prod(self.mesh.shape[a] for a in _entry_axes(entry))
        return tuple(out)

    def shard_bytes(self, shape, dtype) -> int:
        """Bytes of one device's part (every part has one size)."""
        item = torch.empty((), dtype=dtype).element_size()
        return math.prod(self.shard_shape(shape)) * item

    def index(self, idx: tuple, shape) -> tuple:
        """The slices of the part on the logical device at mesh index
        ``idx``."""
        at = dict(zip(self.mesh.axis_names, idx))
        sl = []
        for i, dim in enumerate(shape):
            axes = _entry_axes(self.spec[i]) if i < len(self.spec) else ()
            k, n = 0, 1
            for a in axes:
                k, n = k * self.mesh.shape[a] + at[a], n * self.mesh.shape[a]
            w = dim // n
            sl.append(slice(k * w, (k + 1) * w))
        return tuple(sl)

    def parts(self, t: torch.Tensor) -> dict:
        """Every logical device's part of ``t``, by mesh index: a view of
        ``t`` where the device maps onto ``t``'s device, else a contiguous
        copy on the device's own."""
        out = {}
        for idx in np.ndindex(*self.mesh.devices.shape):
            view = t[self.index(idx, t.shape)]
            dev = self.mesh.devices[idx].physical
            out[idx] = view if dev == t.device else view.to(dev).contiguous()
        return out


def _walk(tree, axes, fn, path=""):
    """``fn(leaf, axes, path)`` over ``tree`` (dicts and lists; a leaf is
    anything else) with ``axes`` (the same structure, a tuple of logical
    names at each leaf)."""
    if isinstance(tree, dict):
        if not isinstance(axes, dict) or set(tree) != set(axes):
            raise ValueError(f"{path or '<root>'}: keys {sorted(tree)} do not "
                             f"match the axes {axes!r}")
        return {k: _walk(tree[k], axes[k], fn, f"{path}/{k}") for k in tree}
    if isinstance(tree, list):
        if not isinstance(axes, list) or len(axes) != len(tree):
            raise ValueError(f"{path}: a list of {len(tree)} has axes {axes!r}")
        return [_walk(t, a, fn, f"{path}[{i}]")
                for i, (t, a) in enumerate(zip(tree, axes))]
    if not isinstance(axes, tuple):
        raise ValueError(f"{path}: leaf axes must be a tuple, got {axes!r}")
    return fn(tree, axes, path)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def tree_shardings(shapes_tree, axes_tree, mesh, rules: dict,
                   log: list | None = None):
    """A tree of leaves with ``shape`` (tensors, meta tensors, numpy arrays;
    a host int is a 0-d leaf) and its logical axes -> a tree of
    `NamedSharding`s.  A leaf whose rank differs from its axes' raises."""
    def one(leaf, axes, path):
        shape = _shape(leaf)
        if len(shape) != len(axes):
            raise ValueError(f"{path}: axes {axes} do not fit shape {shape}")
        return NamedSharding(mesh, spec_for(shape, axes, rules, mesh, log))

    return _walk(shapes_tree, axes_tree, one)


def _map_leaves(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_map_leaves(fn, t, o) for t, o in zip(tree, other)]
    return fn(tree, other)


def place(tree, shardings):
    """``tree``'s tensors and numpy arrays as tensors on the lead device of
    their sharding's mesh (their parts are views there, `NamedSharding.
    parts`); other leaves as they are."""
    def one(leaf, sh):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if isinstance(leaf, torch.Tensor):
            return leaf.to(sh.mesh.lead)
        return leaf

    return _map_leaves(one, tree, shardings)


def device_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree`` under ``shardings``: each
    leaf's part, summed (every device's part of a leaf has one size)."""
    total = 0

    def one(leaf, sh):
        nonlocal total
        if hasattr(leaf, "dtype") and isinstance(leaf.dtype, torch.dtype):
            total += sh.shard_bytes(leaf.shape, leaf.dtype)

    _map_leaves(one, tree, shardings)
    return total


def make_shard_hook(mesh, rules: dict):
    """The residual-stream hook (`models.transformer.set_shard_hook`): a
    (B, S, D) residual's spec is batch -> (pod, data), seq -> model (SP).
    On a one-process mesh the data groups have placed the rows already, so
    it moves nothing: it records (shape, spec) in ``hook.log`` and returns
    the tensor."""
    log: list = []

    def hook(x, name):
        if name != "residual" or x.ndim != 3:
            return x
        log.append((tuple(x.shape),
                    spec_for(x.shape, ("batch", "seq", "act_d"), rules, mesh)))
        return x

    hook.log = log
    return hook


def make_qkv_hook(mesh, rules: dict):
    """The (B, S, H, dh) attention-tensor hook (`models.layers.set_qkv_hook`):
    heads -> model, batch -> (pod, data), applied only when the heads divide
    the model axis (a fallback-to-replicated constraint is not neutral in
    the reference: it would unshard what GSPMD propagated).  On a
    one-process mesh it moves nothing (the TP slabs have placed the heads):
    it records (shape, spec) in ``hook.log`` and returns the tensor."""
    model_n = mesh.shape.get("model", 1)
    log: list = []

    def hook(t):
        if t.ndim != 4 or t.shape[2] % model_n != 0:
            return t
        log.append((tuple(t.shape),
                    spec_for(t.shape, ("batch", None, "heads", None), rules,
                             mesh)))
        return t

    hook.log = log
    return hook


def batch_specs(batch_shapes: dict, mesh, rules: dict) -> dict:
    """Shardings of an input batch dict: the leading dim is the batch, the
    others replicated (tokens / labels (B, S); frames / img_embed (B, S,
    D))."""
    out = {}
    for k, s in batch_shapes.items():
        axes = ("batch",) + (None,) * (len(s.shape) - 1)
        out[k] = NamedSharding(mesh, spec_for(s.shape, axes, rules, mesh))
    return out


def count_params(shapes_tree) -> int:
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif hasattr(node, "shape"):
            total += math.prod(node.shape)

    walk(shapes_tree)
    return total
