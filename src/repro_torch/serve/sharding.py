"""Mesh placement for the serving engine (port of `repro.serve.sharding`,
the reduction-free rules of bitwise serving).

Layout::

                         model axis ->
                  shard 0          shard 1
               +---------------+---------------+
        data   | plan slab 0   | plan slab 1   |   WeightJoinPlan column
        axis   | (dense W_out  | (dense W_out  |   slabs and unembedding
          |    |  cols 0),     |  cols 1),     |   column blocks, each on
          |    | vocab blocks  | vocab blocks  |   logical device (i, j)
          |    |  0 .. n/2-1   |  n/2 .. n-1   |
          v    +---------------+---------------+
               | a cohort's rows split into `data` contiguous groups,  |
               | each running the serving forward on its row's lead    |
               +-------------------------------------------------------+

* **data axis**: a cohort of B rows splits into ``data`` contiguous groups
  when B divides the axis (`data_groups`); each group runs the whole
  serving forward with its own cache rows on its mesh row's lead device.
  Otherwise the rows stay whole on mesh row 0: a placement change, never a
  numerics change (the serving forward is row-invariant, `layers.row_blocks`).
* **model axis**: inside a group, every spiking FFN's `WeightJoinPlan` is
  dealt out as column slabs (`join_plan.shard_plan`, placed by
  `place_plans`): slab j runs kernel 3 on logical device (i, j) with the
  whole plan's launch shape, and the slabs' outputs concatenate in order.
* **vocab**: the unembedding runs over fixed column blocks on every path
  (`models.layers.vocab_blocks`); when the model axis divides their count,
  slab j of the blocks runs on logical device (i, j) (`shard_vocab`).  The
  embedding lookup reads the whole table and stays whole on every mesh row.

As in the reference the default rule is REDUCTION-FREE: a dim goes on the
model axis only when no float sum crosses a shard (a plan slab keeps each
output column's full-K contraction in one shard, and a vocab slab each
logit's), so a sharded serve equals the single-device serve token for
token.  The psum-TP dims (`APPROX_MODEL_SHARDED_DIMS`) belong to
approximate-TP serving, ROADMAP.md item 12b.

The mesh is one process's grid of logical devices (`launch.mesh`), not
`torch.distributed`.  Two logical devices on one physical device share the
plans' and the vocab's slabs (views of one tensor); the dense-weight
route's W_out slabs are copies (`kernels.ops._dense_slabs`), so under a
mesh that weight is held twice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.join_plan import ShardedWeightJoinPlan
from repro_torch.launch.mesh import Mesh, logical_devices
from repro_torch.models.layers import VocabSlabs

# Logical weight-dim names that shard on the model axis at serve time under
# a bitwise policy (reduction-free; see the module docstring).
MODEL_SHARDED_DIMS = frozenset({"vocab"})

# The psum-TP set (Megatron column/row-parallel attention and MLP):
# reachable only through exactness=approximate(tol), item 12b.
APPROX_MODEL_SHARDED_DIMS = MODEL_SHARDED_DIMS | frozenset(
    {"heads_flat", "kv_flat", "d_ff", "d_inner"}
)


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

def parse_mesh_spec(spec: str, n_devices: int) -> tuple[int, int]:
    """Parse a ``--mesh`` spec into (data, model) axis sizes (reference
    rule).  Forms: ``data,model`` (auto: model=2 when the device count is
    even, the rest data), ``data=4,model=2``, ``4,2``."""
    parts = [s.strip() for s in spec.split(",") if s.strip()]
    if len(parts) != 2:
        raise ValueError(f"mesh spec {spec!r} must name two axes: data,model")

    def one(tok: str, name: str) -> int:
        if "=" in tok:
            k, v = tok.split("=", 1)
            if k.strip() != name:
                raise ValueError(f"expected axis {name!r} in {spec!r}")
            size = int(v)
        elif tok.isdigit():
            size = int(tok)
        elif tok == name:
            return 0  # auto
        else:
            raise ValueError(f"expected axis {name!r}, got {tok!r}")
        if size < 1:
            raise ValueError(f"axis {name!r} size must be >= 1 in {spec!r}")
        return size

    dn, mn = one(parts[0], "data"), one(parts[1], "model")
    if not mn:
        if dn:
            mn = max(1, n_devices // dn)
        else:
            mn = 2 if (n_devices > 1 and n_devices % 2 == 0) else 1
    if not dn:
        dn = max(1, n_devices // mn)
    if dn * mn > n_devices:
        raise ValueError(
            f"mesh {dn}x{mn} needs {dn * mn} devices, have {n_devices}"
        )
    return dn, mn


def make_serve_mesh(spec: str | None = "data,model", *, devices=None,
                    device=None) -> Mesh | None:
    """The serving (data, model) mesh over ``devices`` (default: the
    process's logical devices on ``device``, `launch.mesh.logical_devices`),
    or None for a single device: the engine then serves unsharded.  A spec
    that needs more devices than there are raises."""
    devices = logical_devices(device) if devices is None else list(devices)
    if spec is None or len(devices) == 1:
        return None
    dn, mn = parse_mesh_spec(spec, len(devices))
    if dn * mn == 1:
        return None
    return Mesh([devices[i * mn:(i + 1) * mn] for i in range(dn)])


def mesh_summary(mesh: Mesh | None) -> dict:
    """The reference's ``mesh`` / ``mesh_devices`` keys, and
    ``mesh_physical_devices``: how many distinct torch devices the logical
    devices map onto."""
    if mesh is None:
        return {"mesh": None, "mesh_devices": 1, "mesh_physical_devices": 1}
    return {
        "mesh": mesh.describe(),
        "mesh_devices": mesh.size,
        "mesh_physical_devices": len(mesh.physical_devices()),
    }


# ---------------------------------------------------------------------------
# placement: params / plans / caches / token batches
# ---------------------------------------------------------------------------

def check_model_dims(model_dims) -> None:
    """Refuse model dims that shard a float contraction (psum-TP): they
    need the column- and row-parallel model code of item 12b."""
    psum = set(model_dims) - MODEL_SHARDED_DIMS
    if psum:
        raise NotImplementedError(
            f"model dims {sorted(psum)} shard float contractions (psum-TP): "
            "approximate-TP serving, ROADMAP.md item 12b")


def shard_vocab(params: dict, mesh: Mesh, model_dims) -> dict:
    """``params`` with its ``unembed`` column blocks dealt over the model
    axis (`models.layers.VocabSlabs`, slab j placed on every logical device
    (i, j)) when ``vocab`` is in ``model_dims`` and the axis divides the
    block count; otherwise as they are: the unembedding whole on every mesh
    row, a placement change, never a numerics change."""
    check_model_dims(model_dims)
    w = params.get("unembed")
    mp = mesh.shape["model"]
    if (not isinstance(w, torch.Tensor) or mp == 1
            or "vocab" not in model_dims or w.shape[0] % mp):
        return params  # no unembedding, whole, or dealt out already
    slabs = VocabSlabs(w, mp)
    for i in range(mesh.shape["data"]):
        for j in range(mp):
            slabs.slab(j, mesh.physical(i, j))
    return dict(params, unembed=slabs)


def _place_plan(plan: ShardedWeightJoinPlan, mesh: Mesh):
    mp = mesh.shape["model"]
    if plan.shards != mp:
        raise ValueError(
            f"plan has {plan.shards} column slabs but the mesh's model axis "
            f"is {mp}; build it with join_plan.shard_plan(plan, {mp})")
    for i in range(mesh.shape["data"]):
        for j in range(mp):
            plan.slab(j, mesh.physical(i, j))  # copies kept on other devices
    return plan


def place_plans(params, mesh: Mesh):
    """Deal every attached `ShardedWeightJoinPlan` out over the mesh: slab j
    onto each logical device (i, j) (a slab whose device is the plan's own
    is a view of it; on another card, a copy made here, once)."""
    def walk(node):
        if isinstance(node, ShardedWeightJoinPlan):
            return _place_plan(node, mesh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def cache_sharding(leaf, axes: tuple, mesh: Mesh) -> tuple:
    """A cache leaf's placement: its batch dim on ``data`` when the axis
    divides it, every other dim replicated (position-like leaves replicate
    whole, the cohort-merge invariant)."""
    dn = mesh.shape.get("data", 1)
    spec = [None] * leaf.ndim
    for i, name in enumerate(axes):
        if name == "batch" and dn > 1 and leaf.shape[i] % dn == 0:
            spec[i] = "data"
    return tuple(spec)


def place_cache(cache: dict, axes: dict, mesh: Mesh) -> dict:
    """A cohort cache on the mesh: its tensors on the lead device, where the
    data groups read their row slices from (`data_groups`).  Keys are
    checked against ``axes``: a leaf without axes is an error."""
    if set(cache) != set(axes):
        raise ValueError(f"cache keys {sorted(cache)} do not match axes "
                         f"{sorted(axes)}")
    return {k: (v.to(mesh.lead) if isinstance(v, torch.Tensor) else v)
            for k, v in cache.items()}


def place_tokens(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A (B, S) token batch on the lead device (the groups slice it)."""
    return tokens.to(mesh.lead)


def place_pool(pool: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """One `paging.CacheStore` page pool on the mesh: on its lead device.
    Pages are whole-row fragments and every data group gathers its rows'
    pages from it, so a re-mesh that keeps the lead device moves no page."""
    return pool if mesh is None else pool.to(mesh.lead)
