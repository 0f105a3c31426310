"""Mesh placement for the serving engine (port of `repro.serve.sharding`:
the reduction-free rules of bitwise serving and the psum tensor
parallelism of approximate serving).

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
token.  Under ``exactness=approximate(tol)`` the psum-TP dims
(`APPROX_MODEL_SHARDED_DIMS`) go on the model axis too (`shard_params`):
attention, the dense MLPs, the MoE experts and the recurrent blocks run
Megatron-style, the column-parallel half at whole heads or ``d_ff`` /
``d_inner`` blocks on each shard, the row-parallel half's f32 partials
added on the mesh row's lead in shard order and rounded once
(`models.layers.psum`): the drift from one device is bounded by ``tol``
and repeats bit for bit from run to run.

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

# The psum-TP set (Megatron column/row-parallel attention, MLPs, MoE
# experts, recurrent blocks): reachable only through
# exactness=approximate(tol).
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


def mesh_summary(mesh: Mesh | None, tp_log=None) -> dict:
    """The reference's ``mesh`` / ``mesh_devices`` keys,
    ``mesh_physical_devices`` (how many distinct torch devices the logical
    devices map onto) and, given `shard_params`' placement log, the TP
    weights dealt over the model axis and those kept whole."""
    if mesh is None:
        s = {"mesh": None, "mesh_devices": 1, "mesh_physical_devices": 1}
    else:
        s = {"mesh": mesh.describe(), "mesh_devices": mesh.size,
             "mesh_physical_devices": len(mesh.physical_devices())}
    if tp_log is not None:
        whole = sum(1 for _, kind, _ in tp_log if kind == "whole")
        s.update(tp_weights_dealt=len(tp_log) - whole, tp_weights_whole=whole)
    return s


# ---------------------------------------------------------------------------
# placement: params / plans / caches / token batches
# ---------------------------------------------------------------------------

def _tp_rules(node: dict, cfg, ffn_tp: bool):
    """The TP weights of one param dict, found by name, as [(dim, unit
    count, {weight: "col" | "row"})]: a group deals out only when its dim
    is on the model axis and the model axis divides its unit count (whole
    heads, whole ``d_ff`` / ``d_inner`` blocks; a count of 0 keeps the
    group whole)."""
    if {"wr", "cm_k"} <= node.keys():  # rwkv6: time mix by heads, channel mix
        return [("heads_flat", cfg.ssm_heads,
                 dict.fromkeys(("wr", "wk", "wv", "wg", "w0", "wb"), "col")
                 | {"wo": "row"}),
                ("d_ff", cfg.d_ff, {"cm_k": "col", "cm_v": "row"})]
    if "in_x" in node:  # mamba2: whole SSD heads
        return [("d_inner", cfg.ssm_heads,
                 {"in_x": "col", "in_z": "col", "conv": "col", "out": "row"})]
    if "wq" in node:  # attention: q heads with wo, KV heads when they divide
        # a row-coupled arch (MoE capacity routing) keeps attention whole
        units = 0 if cfg.n_experts else cfg.n_heads
        return [("heads_flat", units, {"wq": "col", "wo": "row"}),
                ("kv_flat", cfg.n_kv, {"wk": "col", "wv": "col"})]
    if "router" in node:  # MoE experts (E, D, F) / (E, F, D): d_ff blocks
        return [("d_ff", cfg.d_ff, {k: ("row" if k == "wd" else "col")
                                    for k in ("wu", "wg", "wd") if k in node})]
    if {"wu", "wd"} <= node.keys() and (ffn_tp or not cfg.spiking_ffn):
        return [("d_ff", node["wu"].shape[-1],
                 {k: ("row" if k == "wd" else "col")
                  for k in ("wu", "wg", "wd") if k in node})]
    return []


def shard_params(params: dict, mesh: Mesh, model_dims, cfg, *,
                 ffn_tp: bool = True) -> tuple[dict, list]:
    """``params`` (prepared) with its psum-TP weights dealt over the model
    axis as `models.layers.TPSlabs` when their dims are in ``model_dims``
    (`APPROX_MODEL_SHARDED_DIMS` under approximate exactness), slab j
    placed on every logical device (i, j); and the placement log, one
    (weight path, "col" | "row" | "whole", dim) entry per TP weight.

    Found by name: attention's ``wq`` / ``wo`` (heads) and ``wk`` / ``wv``
    (KV heads; kept whole when the model axis does not divide them, and
    then every shard reads the KV heads its q heads map to), the dense
    MLPs' and MoE experts' ``wg`` / ``wu`` / ``wd`` (``d_ff``), rwkv6's
    ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``wo`` / ``w0`` / ``wb`` (heads)
    and ``cm_k`` / ``cm_v`` (``d_ff``), mamba2's ``in_x`` / ``in_z`` /
    ``conv`` / ``out`` (whole SSD heads of ``d_inner``).  A spiking FFN's
    weights deal out only with ``ffn_tp`` (its float path): under packed
    spikes its GEMMs shard as join-plan or dense column slabs instead
    (`kernels.ops`), which keep every contraction in one shard.

    An arch whose batch rows couple (MoE capacity routing, ``n_experts``)
    keeps its attention whole and deals only its experts' ``d_ff``: a
    token that flips at a near tie in one request changes the routed batch
    of every row from that step on, so each added source of drift puts
    every request's parity at stake, not only its own."""
    from repro_torch.models.layers import TPSlabs

    mp = mesh.shape["model"]
    log: list = []
    if mp == 1 or not set(model_dims) - MODEL_SHARDED_DIMS:
        return params, log

    devices = [[mesh.physical(i, j) for i in range(mesh.shape["data"])]
               for j in range(mp)]

    def deal(node: dict, path: str) -> dict:
        out = dict(node)
        for dim, units, kinds in _tp_rules(node, cfg, ffn_tp):
            if dim not in model_dims:
                continue
            ok = units > 0 and units % mp == 0
            if dim == "kv_flat" and not isinstance(out.get("wq"), TPSlabs):
                ok = False  # KV heads deal out with the q heads only
            for name, kind in kinds.items():
                w = node[name]
                if isinstance(w, TPSlabs):
                    continue
                if ok:
                    out[name] = TPSlabs(w, mp, kind, devices)
                log.append((f"{path}.{name}", kind if ok else "whole", dim))
        return out

    def walk(node, path):
        if isinstance(node, dict):
            node = {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
            return deal(node, path) if _tp_rules(node, cfg, ffn_tp) else node
        if isinstance(node, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return node

    return walk(params, ""), log


def shard_vocab(params: dict, mesh: Mesh, model_dims) -> dict:
    """``params`` with its ``unembed`` column blocks dealt over the model
    axis (`models.layers.VocabSlabs`, slab j placed on every logical device
    (i, j)) when ``vocab`` is in ``model_dims`` and the axis divides the
    block count; otherwise as they are: the unembedding whole on every mesh
    row, a placement change, never a numerics change."""
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
