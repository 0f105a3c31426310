"""Device meshes of logical devices in one process (port of
`repro.launch.mesh`, the serving half).

The reference's mesh is single-controller: one process drives every device
of a `jax.sharding.Mesh`.  The port keeps that: a `Mesh` is a (data, model)
grid of `LogicalDevice`s, each mapped to a physical `torch.device`, driven
by the one process that holds it (not `torch.distributed`).
``force_fake_devices(n)`` sets how many logical devices there are: n of
them map round-robin onto the process's physical devices (the CUDA cards,
or the CPU), as the reference's fake XLA host devices let one CPU stand in
for a pod.  Without it there is one logical device per physical device.

`make_production_mesh` (the training mesh) belongs to the train mesh, a
later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "model")

_FAKE_DEVICES = 0


def force_fake_devices(n: int) -> int:
    """Make ``n`` logical devices (0: one per physical device); returns the
    previous setting.  Unlike the reference's XLA flag, it may change at any
    time: meshes built before keep their devices."""
    global _FAKE_DEVICES
    if n < 0:
        raise ValueError(f"fake device count must be >= 0, got {n}")
    prev, _FAKE_DEVICES = _FAKE_DEVICES, n
    return prev


def physical_devices(device=None) -> list[torch.device]:
    """The physical devices logical devices map onto: every card when
    ``device`` is None or a CUDA device without an index, else ``device``
    alone.  Without a card and without ``device``, raise (as every entry
    point does)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return [device]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build a mesh "
            "of logical devices on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class LogicalDevice:
    """One device of a mesh: ``id`` among the process's logical devices,
    ``physical`` the torch device its tensors live on."""

    id: int
    physical: torch.device

    def __repr__(self) -> str:
        return f"LogicalDevice({self.id}->{self.physical})"


def logical_devices(device=None) -> list[LogicalDevice]:
    """The process's logical devices (`force_fake_devices`), mapped
    round-robin onto `physical_devices(device)`."""
    phys = physical_devices(device)
    n = _FAKE_DEVICES or len(phys)
    return [LogicalDevice(i, phys[i % len(phys)]) for i in range(n)]


class Mesh:
    """A (data, model) grid of logical devices.  ``shape`` is the dict
    {"data": dn, "model": mp}, as a jax mesh's; ``devices`` the (dn, mp)
    object array of `LogicalDevice`s."""

    axis_names = AXES

    def __init__(self, devices):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for i, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows must have one length")
            for j, d in enumerate(row):
                grid[i, j] = d
        ids = [d.id for d in grid.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"a logical device appears twice in the mesh: {ids}")
        self.devices = grid

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def physical(self, i: int, j: int) -> torch.device:
        """The torch device of logical device (i, j)."""
        return self.devices[i, j].physical

    @property
    def lead(self) -> torch.device:
        """The physical device of logical device (0, 0): where a cohort's
        cache, its tokens and the gathered outputs live."""
        return self.physical(0, 0)

    def physical_devices(self) -> list[torch.device]:
        """The distinct physical devices of the mesh, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d.physical not in out:
                out.append(d.physical)
        return out

    def row(self, i: int) -> "Mesh":
        """Mesh row ``i`` as a (1, model) mesh: the devices one data group
        of rows runs on."""
        return Mesh([list(self.devices[i])])

    def describe(self) -> str:
        return "x".join(f"{k}={v}" for k, v in self.shape.items())

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self) -> int:
        return hash(tuple(d.id for d in self.devices.flat))

    def __repr__(self) -> str:
        ids = [d.id for d in self.devices.flat]
        return f"Mesh({self.describe()}, devices={ids})"


def data_groups(mesh: Mesh | None, n_rows: int) -> list[tuple[int, slice]]:
    """The (mesh row, row slice) groups ``n_rows`` rows run as: ``data``
    contiguous groups when the rows divide the axis (the reference's
    ``_row_axis``), else the whole rows on mesh row 0 (its replicated
    fallback: a placement change, never a numerics change)."""
    dn = 1 if mesh is None else mesh.shape["data"]
    if dn <= 1 or n_rows % dn:
        return [(0, slice(0, n_rows))]
    per = n_rows // dn
    return [(i, slice(i * per, (i + 1) * per)) for i in range(dn)]


def tree_to(tree, device):
    """``tree``'s tensors (in dicts and lists) on ``device``; other leaves,
    join plans among them, as they are."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def make_mesh_for(n_devices: int, model_parallel: int | None = None, *,
                  device=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` logical devices
    (tests and examples): model 2 when the count is even, as the
    reference's."""
    mp = model_parallel or (2 if n_devices % 2 == 0 and n_devices > 1 else 1)
    devs = logical_devices(device)
    if n_devices > len(devs):
        raise ValueError(f"mesh needs {n_devices} devices, have {len(devs)}")
    if n_devices % mp:
        raise ValueError(f"{n_devices} devices do not divide model={mp}")
    grid = np.asarray(devs[:n_devices], dtype=object).reshape(
        n_devices // mp, mp)
    return Mesh(grid.tolist())
