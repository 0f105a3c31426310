"""Elastic re-scale (port of `repro.ft.elastic`): choose a new mesh for the
surviving devices and re-place the state onto it.

Checkpoints store whole logical tensors (`ckpt/`) and placements come from
logical axes (`repro_torch.sharding`), so scaling from 8 to 4 devices is
`plan_mesh(4)` -> the shardings of the new mesh -> `reshard_state` of the
host state (or `ckpt.restore_checkpoint(..., shardings=)`).  The data
pipeline is stateless by step, so the batch schedule continues exactly: the
global batch is kept and each data group's share grows.

Serving has its own planner, `plan_serve_mesh`, which `serve.Engine.remesh`
uses to re-place a live engine.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import AXES, TRAIN_AXES, Mesh, logical_devices


def plan_mesh(n_chips: int, model_parallel: int = 16, devices=None, *,
              device=None) -> Mesh:
    """The largest (pod, data, model) mesh over ``n_chips`` logical devices
    at the given model degree (reference rule): a leading ``pod`` axis of
    16-row pods when more than 16 data rows remain and 16 divides them,
    else (data, model).  ``devices`` defaults to the first ``n_chips`` of
    `launch.mesh.logical_devices` on ``device``."""
    if n_chips % model_parallel:
        raise ValueError(f"{n_chips} devices do not divide model="
                         f"{model_parallel}")
    rest = n_chips // model_parallel
    if devices is None:
        devices = logical_devices(device)[:n_chips]
    if len(devices) != n_chips:
        raise ValueError(f"mesh needs {n_chips} devices, have {len(devices)}")
    dev = np.empty(n_chips, dtype=object)
    for i, d in enumerate(devices):
        dev[i] = d
    if rest > 16 and rest % 16 == 0:
        return Mesh(dev.reshape(rest // 16, 16, model_parallel), TRAIN_AXES)
    return Mesh(dev.reshape(rest, model_parallel), AXES)


def plan_serve_mesh(devices, model_parallel: int = 1) -> Mesh | None:
    """The largest (data, model) mesh over the surviving ``devices``
    (`launch.mesh.LogicalDevice`s) at up to ``model_parallel`` model
    shards (reference rule): the model axis halves until the survivors
    hold one row of it, trailing devices that fill no data row stay idle,
    and one usable device gives None (the engine's unsharded mode).  The
    model axis is kept where the survivors allow it, so an approximate-TP
    engine's `Engine.remesh` re-deals its TP slabs over it (an approximate
    policy left without a model axis is refused, as at construction).
    Serving has no pod axis: where `plan_mesh` would add one, it folds into
    data."""
    devices = list(devices)
    if not devices:
        raise ValueError("no surviving devices to plan a serve mesh over")
    n = len(devices)
    mp = max(1, model_parallel)
    while mp > 1 and n < mp:
        mp //= 2
    usable = (n // mp) * mp
    if usable <= 1:
        return None
    return Mesh([devices[i * mp:(i + 1) * mp] for i in range(usable // mp)])


def reshard_state(state_host, axes_tree, mesh: Mesh, rules: dict):
    """Place a host state tree (CPU tensors or numpy arrays) onto ``mesh``
    per its logical axes (`sharding.tree_shardings`): each leaf as a tensor
    on the mesh's lead device, its devices' parts views of it there
    (`sharding.NamedSharding.parts`).  Non-tensor leaves (a host ``pos``)
    stay as they are."""
    from repro_torch.sharding import place, tree_shardings

    return place(state_host, tree_shardings(state_host, axes_tree, mesh, rules))
