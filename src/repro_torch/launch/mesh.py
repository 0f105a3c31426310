"""Device meshes of logical devices in one process (port of
`repro.launch.mesh`).

The reference's mesh is single-controller: one process drives every device
of a `jax.sharding.Mesh`.  The port keeps that: a `Mesh` is a grid of
`LogicalDevice`s, each mapped to a physical `torch.device`, driven by the
one process that holds it (not `torch.distributed`).
``force_fake_devices(n)`` sets how many logical devices there are: n of
them map round-robin onto the process's physical devices (the CUDA cards,
or the CPU), as the reference's fake XLA host devices let one CPU stand in
for a pod.  Without it there is one logical device per physical device.

A serve mesh is a (data, model) grid (`serve.sharding.make_serve_mesh`).
A train mesh may lead with a ``pod`` axis, (pod, data, model)
(`make_production_mesh`, `ft.elastic.plan_mesh`), whose batch runs in pod
x data groups (`data_groups`); the train mesh's placement rules are
`repro_torch.sharding`'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "model")
TRAIN_AXES = ("pod", "data", "model")

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
    """A grid of logical devices over ``axis_names``: (data, model), or
    (pod, data, model) for a multi-pod train mesh.  ``shape`` is the dict
    {axis: size}, as a jax mesh's; ``devices`` the object array of
    `LogicalDevice`s (``devices`` may be given as nested lists)."""

    def __init__(self, devices, axis_names=AXES):
        grid = np.empty(_nested_shape(devices), dtype=object)
        for idx in np.ndindex(*grid.shape):
            node = devices
            for i in idx:
                node = node[i]
            grid[idx] = node
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid cannot carry axes "
                             f"{axis_names}")
        ids = [d.id for d in grid.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"a logical device appears twice in the mesh: {ids}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def physical(self, *idx: int) -> torch.device:
        """The torch device of the logical device at mesh index ``idx``."""
        return self.devices[idx].physical

    @property
    def lead(self) -> torch.device:
        """The physical device of the mesh's first logical device: where a
        cohort's cache, its tokens and the gathered outputs live (and a
        train state's leaves)."""
        return self.devices.flat[0].physical

    def physical_devices(self) -> list[torch.device]:
        """The distinct physical devices of the mesh, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d.physical not in out:
                out.append(d.physical)
        return out

    def row(self, i: int) -> "Mesh":
        """Row ``i`` of the mesh's leading axes (pod x data, in that order)
        as a (1, model) mesh: the devices one data group of rows runs on."""
        rows = self.devices.reshape(-1, self.devices.shape[-1])
        return Mesh([list(rows[i])])

    @property
    def n_rows(self) -> int:
        """The rows of `row`: the product of every axis but ``model``."""
        return self.size // self.devices.shape[-1]

    def describe(self) -> str:
        return "x".join(f"{k}={v}" for k, v in self.shape.items())

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self) -> int:
        return hash(tuple(d.id for d in self.devices.flat))

    def __repr__(self) -> str:
        ids = [d.id for d in self.devices.flat]
        return f"Mesh({self.describe()}, devices={ids})"


def _nested_shape(devices) -> tuple:
    """The grid shape of nested lists (or an array) of devices; rows of one
    level must have one length."""
    if isinstance(devices, np.ndarray):
        return devices.shape
    shape, level = [], [devices]
    while isinstance(level[0], (list, tuple)):
        n = len(level[0])
        if any(len(x) != n for x in level):
            raise ValueError("mesh rows must have one length")
        shape.append(n)
        level = [y for x in level for y in x]
    return tuple(shape)


def data_groups(mesh: Mesh | None, n_rows: int) -> list[tuple[int, slice]]:
    """The (mesh row, row slice) groups ``n_rows`` rows run as: one
    contiguous group per `Mesh.row` (``data``, or pod x data on a train
    mesh: ``batch`` goes on both) when the rows divide them (the
    reference's ``_row_axis``), else the whole rows on mesh row 0 (its
    replicated fallback: a placement change, never a numerics change)."""
    dn = 1 if mesh is None else mesh.n_rows
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


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The training mesh (reference shapes): 16 x 16 (data, model), or 2 x
    16 x 16 (pod, data, model) with ``multi_pod``, over 256 / 512 logical
    devices on ``device`` (the CUDA cards by default; ``"meta"`` for the dry
    run, which needs no memory; ``"cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = TRAIN_AXES if multi_pod else AXES
    phys = physical_devices(device)
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = LogicalDevice(i, phys[i % len(phys)])
    return Mesh(devs.reshape(shape), axes)
