"""Policy-dispatched front door to the FTP kernels (port of
`repro.kernels.ops`, main-path routes only).

``dispatch(a, weights_or_plan, policy, T)`` routes by the
`repro_torch.serve.policy.ExecutionPolicy` and the operand type:

* ``spike_format='float'`` -> the differentiable plain torch path
  ((T, M, K) float spikes);
* ``spike_format='packed'`` + a `WeightJoinPlan` -> the dual-sparse BSR
  kernel: the plan is the static weight side of the join, and the spike
  side is a block-activity map computed here, on the operand's device, per
  call.

The dense-weight packed routes (the reference's `_spmm`/`_spmm_fused`
kernels) and per-call plan building are later slices and raise.
``ftp_spmm.LAUNCHES`` counts the CUDA kernel's launches: the port's
counterpart of the reference's ``BSR_TRACE_COUNT`` (the port does not
trace, so it counts launches).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import block_activity_map

from . import ftp_spmm as _k
from .join_plan import WeightJoinPlan


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
):
    """Dual-sparse FTP spMspM of (M, K) packed spikes against a load-time
    plan.  Returns (packed spikes (M, n_out), U) when ``fuse_lif`` else
    ((T, M, n_out) full sums, zeros)."""
    M, K = a.shape
    if K > plan.k_padded:
        raise ValueError(f"spike width {K} exceeds plan K {plan.k_padded}")
    bm = _k.pick_bm(M)
    n_out = plan.n_padded if n_out is None else n_out
    return _k.ftp_spmm_bsr(
        a.contiguous(), plan.payload, plan.kidx, plan.vidx, plan.cnt,
        _activity(a, bm, plan), n_out, T, v_th, tau, bm=bm,
        fuse_lif=fuse_lif,
    )


def _bsr_batched(a, plan, T, v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *,
                 n_out=None, fuse_lif=True):
    """(B, M, K) batched entry: the batch folds into rows (exact — the
    kernel is row-parallel), so one pass over the payload serves the whole
    batch and all T timesteps."""
    B, M, K = a.shape
    out, u = _bsr(a.reshape(B * M, K), plan, T, v_th, tau,
                  n_out=n_out, fuse_lif=fuse_lif)
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
    ``fuse_lif`` on the float route; the plan route always returns a pair —
    (packed words, U) with ``fuse_lif``, else (full sums, zeros)."""
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
    if not plan_like:
        raise NotImplementedError(
            "packed spikes against dense weights (the dense-weight FTP "
            "kernels, or a plan built per call) are not ported yet; build "
            "the WeightJoinPlan at load (join_plan.build_weight_plan) — see "
            "ROADMAP.md"
        )
    fn = _bsr_batched if a.ndim == 3 else _bsr
    return fn(a, weights_or_plan, T, v_th, tau, n_out=n_out, fuse_lif=fuse_lif)
