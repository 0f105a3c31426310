"""Elastic re-mesh for serving (port of `repro.ft.elastic`, the serve
half): `plan_serve_mesh` picks the largest (data, model) mesh the
surviving logical devices support, and `serve.Engine.remesh` re-places a
live engine onto it.  The trainer's `plan_mesh` / `reshard_state` belong
to the train mesh, ROADMAP item 12c."""
from __future__ import annotations

from repro_torch.launch.mesh import Mesh


def plan_serve_mesh(devices, model_parallel: int = 1) -> Mesh | None:
    """The largest (data, model) mesh over the surviving ``devices``
    (`launch.mesh.LogicalDevice`s) at up to ``model_parallel`` model
    shards (reference rule): the model axis halves until the survivors
    hold one row of it, trailing devices that fill no data row stay idle,
    and one usable device gives None (the engine's unsharded mode)."""
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
