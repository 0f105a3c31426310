"""Policy-dispatched front door to the FTP kernels (port of
`repro.kernels.ops`, the single-device routes).

``dispatch(a, weights_or_plan, policy, T)`` routes by the
`repro_torch.serve.policy.ExecutionPolicy` and the operand type:

* ``spike_format='float'`` -> the differentiable plain torch path
  ((T, M, K) float spikes);
* ``spike_format='packed'`` + dense (K, N) weights -> the dense-weight FTP
  kernels (`ftp_spmm`, or `ftp_spmm_fused_lif` with ``fuse_lif``); a
  (B, M, K) batch folds into rows;
* ``spike_format='packed'`` + a `WeightJoinPlan` -> the dual-sparse BSR
  kernel: the plan is the static weight side of the join, and the spike
  side is a block-activity map computed here, on the operand's device, per
  call.  Under ``temporal='adaptive'`` a timestep-activity map is computed
  on the device too, and the adaptive instance of the kernel skips the
  planes it gates;
* ``weight_sparsity='dual_sparse'`` + raw (pruned) weights -> the same
  kernel through a plan built per call (`_dual_sparse_once`), for
  examples, tests and offline experiments; serving builds its plans once
  at load.  ``execution='pipelined'`` refuses this route.

Under a serve mesh (`serve_mesh_scope`, or a policy whose placement
carries one) a `ShardedWeightJoinPlan` runs sharded (`_bsr_sharded`): the
rows split into ``data`` groups when they divide the axis, and each group
joins every column slab j on logical device (i, j) with the whole plan's
launch shape, so the concatenated result equals the unsharded call bit for
bit (no float sum crosses a shard).  The dense full-sum route (kernel 1)
shards the same way over column slabs of the weight (`_spmm_mesh`); the
fused dense route (kernel 2) keeps single-device semantics under a mesh,
as in the reference.

`dispatch_decode_window` is the speculative verify's (B, S, K) entry;
`build_block_join` is the fully joined host-side view for offline
analysis.  ``ftp_spmm.launch_counts()``
counts each kernel's launches: the port's counterpart of the reference's
``BSR_TRACE_COUNT`` (the port does not trace, so it counts launches).
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import (
    block_activity_map,
    mask_low_activity_timesteps,
    timestep_activity_map,
)
from repro_torch.launch.mesh import data_groups

from . import ftp_spmm as _k
from .join_plan import (
    ShardedWeightJoinPlan,
    WeightJoinPlan,
    build_block_csr,
    build_weight_plan,
)


# ---------------------------------------------------------------------------
# the serve mesh: a (data, model) grid of logical devices (launch.mesh)
# ---------------------------------------------------------------------------

_SERVE_MESH = None


def set_serve_mesh(mesh) -> None:
    """Install (or clear, with None) the serve mesh the sharded entries
    deal their work over."""
    global _SERVE_MESH
    _SERVE_MESH = mesh


def get_serve_mesh():
    return _SERVE_MESH


@contextlib.contextmanager
def serve_mesh_scope(mesh):
    prev = _SERVE_MESH
    set_serve_mesh(mesh)
    try:
        yield mesh
    finally:
        set_serve_mesh(prev)


# ---------------------------------------------------------------------------
# dense-weight routes (kernels 1 and 2)
# ---------------------------------------------------------------------------

def _spmm(a: torch.Tensor, b: torch.Tensor, T: int) -> torch.Tensor:
    """(M, K) packed x (K, N) -> (T, M, N) f32 full sums."""
    return _k.ftp_spmm(a.contiguous(), b.contiguous(), T)


# Column slabs of dense weights, made once per weight and device set and
# dropped with the weight (the serving forward passes the same tensor every
# step).
_DENSE_SLABS: dict = {}


def _dense_slabs(b: torch.Tensor, devices: tuple) -> list[torch.Tensor]:
    """The column slabs of the caller's (K, N) weight ``b`` on ``devices``:
    contiguous copies (kernel 1 reads a slab's rows back to back), so under
    a mesh the weight is held twice, once whole and once in slabs."""
    key = (id(b), devices)
    slabs = _DENSE_SLABS.get(key)
    if slabs is None:
        per = b.shape[1] // len(devices)
        slabs = [b[:, j * per:(j + 1) * per].to(d).contiguous()
                 for j, d in enumerate(devices)]
        _DENSE_SLABS[key] = slabs
        weakref.finalize(b, _DENSE_SLABS.pop, key, None)
    return slabs


def _spmm_mesh(a: torch.Tensor, b: torch.Tensor, T: int, mesh) -> torch.Tensor:
    """Kernel 1 under a serve mesh: rows in ``data`` groups, weight columns
    in ``model`` slabs, slab j of group i on logical device (i, j), each
    launched with the whole weight's shape (``parent_n``), so the result
    equals the unsharded `_spmm` bit for bit.  A column count the model
    axis does not divide runs unsharded, as in the reference."""
    M, N = a.shape[0], b.shape[1]
    mp = mesh.shape["model"]
    if mp > 1 and N % mp:
        return _spmm(a, b, T)
    a, out = a.contiguous(), []
    for i, rows in data_groups(mesh, M):
        devs = tuple(mesh.physical(i, j) for j in range(mp))
        parts = [_k.ftp_spmm(a[rows].to(d), w, T, parent_n=N).to(a.device)
                 for d, w in zip(devs, _dense_slabs(b, devs))]
        out.append(torch.cat(parts, dim=-1))
    return torch.cat(out, dim=1)


def _spmm_fused(a, b, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU):
    """(M, K) packed x (K, N) -> ((M, N) packed words, (M, N) f32 U)."""
    return _k.ftp_spmm_fused_lif(a.contiguous(), b.contiguous(), T, v_th, tau)


# A (B, M, K) batch is one (B*M, K) x (K, N) problem: the kernels are
# row-parallel, so folding the batch into rows is exact and the weight is
# streamed once for the whole batch and all T timesteps.

def _spmm_batched(a, b, T):
    """(B, M, K) packed x (K, N) -> (T, B, M, N) f32."""
    B, M, K = a.shape
    return _spmm(a.reshape(B * M, K), b, T).reshape(T, B, M, b.shape[1])


def _spmm_fused_batched(a, b, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU):
    """(B, M, K) packed x (K, N) -> ((B, M, N) words, (B, M, N) U)."""
    B, M, K = a.shape
    c, u = _spmm_fused(a.reshape(B * M, K), b, T, v_th, tau)
    N = b.shape[1]
    return c.reshape(B, M, N), u.reshape(B, M, N)


# ---------------------------------------------------------------------------
# dual-sparse routes (kernels 3 and 4)
# ---------------------------------------------------------------------------

def _activity(a: torch.Tensor, bm: int, plan: WeightJoinPlan) -> torch.Tensor:
    """(ceil(M/bm), nkb) int32 spike block-activity map, on a's device."""
    M, K = a.shape
    ap = F.pad(a, (0, plan.k_padded - K, 0, (-M) % bm))
    return block_activity_map(ap, bm, plan.bk).to(torch.int32)


def _bsr(
    a: torch.Tensor,
    plan: WeightJoinPlan,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
    *,
    n_out: int | None = None,
    fuse_lif: bool = True,
    adaptive: bool = False,
    min_spikes: int = 1,
    parent: tuple[int, int] | None = None,
):
    """Dual-sparse FTP spMspM of (M, K) packed spikes against a load-time
    plan.  Returns (packed spikes (M, n_out), U) when ``fuse_lif`` else
    ((T, M, n_out) full sums, zeros).  ``adaptive``: planes carrying fewer
    than ``min_spikes`` spikes over all rows add nothing (kernel 4).
    ``parent``: the (nnb, jmax) of the plan ``plan`` is a column slab of
    (its launch shape, `ftp_spmm.ftp_spmm_bsr`)."""
    M, K = a.shape
    if K > plan.k_padded:
        raise ValueError(f"spike width {K} exceeds plan K {plan.k_padded}")
    bm = _k.pick_bm(M, T)
    n_out = plan.n_padded if n_out is None else n_out
    # the temporal third of the join, scored on the device like `act`
    tmap = (timestep_activity_map(a, T, min_spikes).to(torch.int32)
            if adaptive else None)
    return _k.ftp_spmm_bsr(
        a.contiguous(), plan.payload, plan.kidx, plan.vidx, plan.cnt,
        _activity(a, bm, plan), n_out, T, v_th, tau, bm=bm,
        fuse_lif=fuse_lif, tmap=tmap, parent=parent,
    )


def _bsr_sharded(a: torch.Tensor, plan: ShardedWeightJoinPlan, T: int,
                 v_th: float, tau: float, mesh, *, n_out: int | None,
                 fuse_lif: bool, adaptive: bool, min_spikes: int):
    """Kernels 3 / 4 under a serve mesh: (M, K) rows in ``data`` groups
    (`launch.mesh.data_groups`), and in each group i every column slab j
    of the plan joined on logical device (i, j), launched with the whole
    plan's shape.
    Each output column's full-K contraction stays inside one slab, so the
    slabs' outputs, concatenated in slab order and the groups' in row
    order, equal the unsharded call bit for bit.  Under ``adaptive`` each
    group scores its own rows' planes: at ``min_spikes`` 1 still bitwise (a
    plane silent over a group's rows adds nothing to them either way).
    Launches: data groups x model slabs."""
    if plan.payload.ndim != 4:
        raise ValueError(
            "sharded dispatch needs a per-layer plan (payload rank 4); got "
            f"rank {plan.payload.ndim}: slice the layer axis first")
    mp = mesh.shape["model"]
    if plan.shards != mp:
        raise ValueError(
            f"plan has {plan.shards} column slabs but the mesh's model axis "
            f"is {mp}; build it with join_plan.shard_plan(plan, {mp})")
    n_out = mp * plan.n_padded if n_out is None else n_out
    cs, us = [], []
    for i, rows in data_groups(mesh, a.shape[0]):
        c_i, u_i = [], []
        for j in range(mp):
            dev = mesh.physical(i, j)
            slab = plan.slab(j, dev)
            c, u = _bsr(a[rows].to(dev), slab, T, v_th, tau,
                        n_out=slab.n_padded, fuse_lif=fuse_lif,
                        adaptive=adaptive, min_spikes=min_spikes,
                        parent=plan.parent)
            c_i.append(c.to(a.device))
            u_i.append(u.to(a.device))
        cs.append(torch.cat(c_i, dim=-1))
        us.append(torch.cat(u_i, dim=-1))
    u = torch.cat(us, dim=0)[:, :n_out]
    if fuse_lif:
        return torch.cat(cs, dim=0)[:, :n_out], u
    return torch.cat(cs, dim=1)[..., :n_out], u


def _bsr_plan(a, plan, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *, n_out=None,
              fuse_lif=True, adaptive=False, min_spikes=1, mesh=None):
    """The plan route of (M, K) rows: sharded over ``mesh`` (default: the
    serve mesh) when the plan is a `ShardedWeightJoinPlan` (the type
    decides, never the rank: a plain plan runs unsharded under any mesh)."""
    if isinstance(plan, ShardedWeightJoinPlan):
        mesh = get_serve_mesh() if mesh is None else mesh
        if mesh is None:
            raise ValueError(
                "a ShardedWeightJoinPlan runs under a serve mesh (a policy "
                "placement or ops.serve_mesh_scope); none is active")
        return _bsr_sharded(a, plan, T, v_th, tau, mesh, n_out=n_out,
                            fuse_lif=fuse_lif, adaptive=adaptive,
                            min_spikes=min_spikes)
    return _bsr(a, plan, T, v_th, tau, n_out=n_out, fuse_lif=fuse_lif,
                adaptive=adaptive, min_spikes=min_spikes)


def _bsr_batched(a, plan, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *,
                 n_out=None, fuse_lif=True, adaptive=False, min_spikes=1,
                 mesh=None):
    """(B, M, K) batched entry: the batch folds into rows (exact — the
    kernel is row-parallel), so one pass over the payload serves the whole
    batch and all T timesteps.  Temporal scoring is then over the folded
    batch: a plane is skipped only when silent across every request."""
    B, M, K = a.shape
    out, u = _bsr_plan(a.reshape(B * M, K), plan, T, v_th, tau,
                       n_out=n_out, fuse_lif=fuse_lif, adaptive=adaptive,
                       min_spikes=min_spikes, mesh=mesh)
    N = out.shape[-1]
    if fuse_lif:
        return out.reshape(B, M, N), u.reshape(B, M, N)
    return out.reshape(T, B, M, N), u.reshape(B, M, N)


def _dual_sparse_once(
    a: torch.Tensor,
    w: torch.Tensor,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
    *,
    fuse_lif: bool = True,
    adaptive: bool = False,
    min_spikes: int = 1,
):
    """One dual-sparse LoAS layer with its plan built per call: (M, K) or
    batched (B, M, K) packed words x raw (K, N) pruned weights -> kernel 3
    (kernel 4 under ``adaptive``) through a `WeightJoinPlan` built on
    ``w``'s device with the reference's block rule (`pick_plan_blocks`).
    Returns (packed words, U) with ``fuse_lif``, else (full sums, zeros),
    shaped as the plan route's.

    On the card the plan's column block may be wider than the reference's
    (`build_weight_plan`): its zero columns add +0 and the output is cut
    back to N, so the values are those of the reference's blocks."""
    fn = _bsr_batched if a.ndim == 3 else _bsr
    return fn(a, build_weight_plan(w), T, v_th, tau, n_out=w.shape[1],
              fuse_lif=fuse_lif, adaptive=adaptive, min_spikes=min_spikes)


def dispatch(
    a,
    weights_or_plan,
    policy,
    T: int,
    *,
    fuse_lif: bool = False,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
    n_out: int | None = None,
):
    """Run one FTP layer under an `ExecutionPolicy`.

    ``a``: float: (T, M, K) {0,1} planes; packed: (M, K) or batched
    (B, M, K) int32 words.  Returns (T, M[, N-batched], N) full sums without
    ``fuse_lif`` on the float and dense routes, and (spikes, U) with it; the
    dual-sparse routes (a plan, or raw weights under a ``dual_sparse``
    policy) always return a pair — (packed words, U) with ``fuse_lif``, else
    (full sums, zeros).

    Raw weights under a ``dual_sparse`` policy build their plan per call
    (offline convenience; serving builds plans once at load and passes
    them in).  Under ``execution='pipelined'`` that route raises: building
    a plan reads the weights' block map on the host, a device sync in the
    dispatch path the pipelined executor keeps sync-free.

    A policy whose placement carries a mesh shards the call over it;
    otherwise an ambient serve mesh (`serve_mesh_scope`) applies.  Under a
    mesh a `ShardedWeightJoinPlan` and the dense full-sum route run sharded
    (batched operands fold into rows first); the fused dense route and
    the per-call plan route keep single-device semantics."""
    from repro_torch.serve.policy import ExecutionPolicy  # serve sits above

    if not isinstance(policy, ExecutionPolicy):
        raise TypeError(
            f"dispatch needs an ExecutionPolicy, got {type(policy).__name__}"
        )
    plan_like = isinstance(weights_or_plan, WeightJoinPlan)
    if plan_like and policy.weight_sparsity != "dual_sparse":
        raise ValueError(
            "got a WeightJoinPlan but policy.weight_sparsity="
            f"{policy.weight_sparsity!r}; use a dual_sparse policy "
            "(repro_torch.serve.policy.PACKED_DUAL) or pass dense weights"
        )
    if (policy.execution == "pipelined"
            and policy.weight_sparsity == "dual_sparse" and not plan_like):
        raise ValueError(
            "execution='pipelined' forbids per-call plan building (it reads "
            "the weights' block map on the host, forcing a device sync in "
            "the dispatch hot path); build the WeightJoinPlan once at load "
            "(join_plan.build_weight_plan / "
            "models.layers.attach_spiking_ffn_plans) and pass it in"
        )
    if policy.spike_format == "float":
        from repro_torch.core.ftp import ftp_spmspm_unpacked
        from repro_torch.core.lif import lif_forward

        o = ftp_spmspm_unpacked(a, weights_or_plan)
        if fuse_lif:
            return lif_forward(o, v_th=v_th, tau=tau)
        return o
    batched = a.ndim == 3
    # The BSR kernel takes the scored map in-kernel; the dense-weight
    # kernels have no timestep gate, so a lossy threshold (min_spikes > 1)
    # becomes value masking of the operand there.  min_spikes=1 masking is
    # the identity (an all-silent plane has no bits), so it is skipped.
    adaptive = policy.temporal.enabled
    min_spikes = policy.temporal.min_spikes if adaptive else 1
    mesh = policy.mesh if policy.mesh is not None else get_serve_mesh()
    if plan_like:
        fn = _bsr_batched if batched else _bsr_plan
        return fn(a, weights_or_plan, T, v_th, tau, n_out=n_out,
                  fuse_lif=fuse_lif, adaptive=adaptive, min_spikes=min_spikes,
                  mesh=mesh)
    if policy.weight_sparsity == "dual_sparse":
        return _dual_sparse_once(a, weights_or_plan, T, v_th, tau,
                                 fuse_lif=fuse_lif, adaptive=adaptive,
                                 min_spikes=min_spikes)
    if adaptive and min_spikes > 1:
        a = mask_low_activity_timesteps(a, T, min_spikes)
    if fuse_lif:
        fn = _spmm_fused_batched if batched else _spmm_fused
        return fn(a, weights_or_plan, T, v_th, tau)
    if mesh is None:
        fn = _spmm_batched if batched else _spmm
        return fn(a, weights_or_plan, T)
    w = weights_or_plan
    if batched:  # fold the batch into rows, so rows shard as well
        B, M, K = a.shape
        return _spmm_mesh(a.reshape(B * M, K), w, T, mesh).reshape(
            T, B, M, w.shape[1])
    return _spmm_mesh(a, w, T, mesh)


def dispatch_decode_window(a, weights_or_plan, policy, T: int, **kwargs):
    """Decode-window entry for the speculative verify: ``a`` is a packed
    (B, S, K) operand, S = k + 1 positions of one round per batch row.  The
    window folds into B * S rows of `dispatch` (the weight side streams once
    per round), and every kernel under it is row-parallel, so each
    position's output equals its own (B, 1) dispatch bit for bit.  Under
    ``temporal='adaptive'`` the plane score is pooled over the folded window
    (a plane skips only when silent at every position of every row)."""
    if getattr(a, "ndim", None) != 3:
        raise ValueError(
            "dispatch_decode_window takes a packed (B, S, K) window, got "
            f"shape {getattr(a, 'shape', None)} — use dispatch() for "
            "unbatched or float operands"
        )
    if policy.spike_format != "packed":
        raise ValueError(
            "decode windows are packed-spike shaped; policy has "
            f"spike_format={policy.spike_format!r}"
        )
    return dispatch(a, weights_or_plan, policy, T, **kwargs)


# ---------------------------------------------------------------------------
# offline analysis
# ---------------------------------------------------------------------------

def build_block_join(a_packed: torch.Tensor, b: torch.Tensor, bm: int, bk: int,
                     bn: int):
    """The fully joined host-side view (offline analysis and debugging):
    for every output tile (i, j), the k-blocks where A's (bm, bk) spike
    block is active AND B's (bk, bn) block is non-zero, ascending.  The
    serving path never calls this: it splits the join into the load-time
    plan and the in-kernel activity skip.

    ``a_packed``: (M, K) int32 words; ``b``: (K, N) weights.  M, K and N
    must be block multiples.  Returns (payload (nnzb, bk, bn) on ``b``'s
    device, kidx (nm, nnb, jmax), vidx (nm, nnb, jmax), cnt (nm, nnb) as
    int32 numpy, jmax): the reference's join lists."""
    N = b.shape[1]
    payload, idx, bnz = build_block_csr(b, bk, bn)
    a_act = block_activity_map(a_packed, bm, bk).cpu().numpy()
    nnb = N // bn
    # joined[i, j, kb] = a_act[i, kb] & bnz[kb, j]
    joined = a_act[:, None, :] & bnz.T[None, :, :]  # (nm, nnb, nkb)
    cnt = joined.sum(axis=2).astype(np.int32)
    jmax = max(1, int(cnt.max()))
    # a stable argsort of ~joined brings the joined k-blocks to the front,
    # ascending, per (i, j) tile
    order = np.argsort(~joined, axis=2, kind="stable")[..., :jmax]
    live = np.arange(jmax)[None, None, :] < cnt[..., None]
    kidx = np.where(live, order, 0).astype(np.int32)
    vidx = np.where(
        live, idx[kidx, np.arange(nnb)[None, :, None]], 0
    ).astype(np.int32)
    return payload, kidx, vidx, cnt, jmax
