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
  planes it gates.

`dispatch_decode_window` is the speculative verify's (B, S, K) entry.
Per-call plan building (dual_sparse policy with raw weights) and the mesh
entries are later slices and raise.  ``ftp_spmm.launch_counts()`` counts
each kernel's launches: the port's counterpart of the reference's
``BSR_TRACE_COUNT`` (the port does not trace, so it counts launches).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import (
    block_activity_map,
    mask_low_activity_timesteps,
    timestep_activity_map,
)

from . import ftp_spmm as _k
from .join_plan import WeightJoinPlan


# ---------------------------------------------------------------------------
# dense-weight routes (kernels 1 and 2)
# ---------------------------------------------------------------------------

def _spmm(a: torch.Tensor, b: torch.Tensor, T: int) -> torch.Tensor:
    """(M, K) packed x (K, N) -> (T, M, N) f32 full sums."""
    return _k.ftp_spmm(a.contiguous(), b.contiguous(), T)


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
):
    """Dual-sparse FTP spMspM of (M, K) packed spikes against a load-time
    plan.  Returns (packed spikes (M, n_out), U) when ``fuse_lif`` else
    ((T, M, n_out) full sums, zeros).  ``adaptive``: planes carrying fewer
    than ``min_spikes`` spikes over all rows add nothing (kernel 4)."""
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
        fuse_lif=fuse_lif, tmap=tmap,
    )


def _bsr_batched(a, plan, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *,
                 n_out=None, fuse_lif=True, adaptive=False, min_spikes=1):
    """(B, M, K) batched entry: the batch folds into rows (exact — the
    kernel is row-parallel), so one pass over the payload serves the whole
    batch and all T timesteps.  Temporal scoring is then over the folded
    batch: a plane is skipped only when silent across every request."""
    B, M, K = a.shape
    out, u = _bsr(a.reshape(B * M, K), plan, T, v_th, tau,
                  n_out=n_out, fuse_lif=fuse_lif, adaptive=adaptive,
                  min_spikes=min_spikes)
    N = out.shape[-1]
    if fuse_lif:
        return out.reshape(B, M, N), u.reshape(B, M, N)
    return out.reshape(T, B, M, N), u.reshape(B, M, N)


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
    plan route always returns a pair — (packed words, U) with ``fuse_lif``,
    else (full sums, zeros)."""
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
    if plan_like:
        fn = _bsr_batched if batched else _bsr
        return fn(a, weights_or_plan, T, v_th, tau, n_out=n_out,
                  fuse_lif=fuse_lif, adaptive=adaptive, min_spikes=min_spikes)
    if policy.weight_sparsity == "dual_sparse":
        raise NotImplementedError(
            "a dual_sparse policy with raw weights builds a plan per call, "
            "which is not ported yet; build the WeightJoinPlan at load "
            "(join_plan.build_weight_plan) — see ROADMAP.md"
        )
    if adaptive and min_spikes > 1:
        a = mask_low_activity_timesteps(a, T, min_spikes)
    if fuse_lif:
        fn = _spmm_fused_batched if batched else _spmm_fused
        return fn(a, weights_or_plan, T, v_th, tau)
    fn = _spmm_batched if batched else _spmm
    return fn(a, weights_or_plan, T)


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
