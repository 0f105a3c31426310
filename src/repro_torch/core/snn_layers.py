"""Dual-sparse spiking layers on the FTP dataflow (port of
`repro.core.snn_layers`).

* **train**: float {0,1} spikes, surrogate-gradient LIF, differentiable.
* **infer**: packed int32 spike words.  With load-time `WeightJoinPlan`s
  both GEMMs run through the dual-sparse BSR kernel; without plans they run
  against the dense weights: through the dense-weight FTP kernels when the
  words are on the card, through the plain `ftp_layer` / `ftp_spmspm` when
  they are on the CPU.  The route follows the tensors' device alone.

`spiking_ffn_apply` is the drop-in transformer MLP replacement: direct
encoding in, rate decoding out.  Pruning happens once, at init/load; the
apply paths never re-prune (the plans are built from the stored zeros).

``SpikingConfig.preprocess_min_spikes`` is the paper's silent-neuron
preprocessing (§V): presynaptic neurons firing fewer times are masked on
every path (train: multiplicatively, infer: their words zeroed).  The
default 0 leaves every path as it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .ftp import ftp_layer, ftp_spmspm, ftp_spmspm_unpacked
from .lif import DEFAULT_TAU, DEFAULT_VTH, direct_encode, lif_forward, rate_decode
from .packing import mask_low_activity, mask_low_activity_spikes, pack_spikes


@dataclass(frozen=True)
class SpikingConfig:
    T: int = 4
    v_th: float = DEFAULT_VTH
    tau: float = DEFAULT_TAU
    # silent-neuron preprocessing (paper §V): mask neurons firing fewer
    # times than this; 0 disables, the paper uses 2
    preprocess_min_spikes: int = 0
    # fraction of weights kept after LTH pruning (paper: 1.8-3.2 %)
    weight_density: float = 1.0


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(x.reshape(-1), k, sorted=False).values.min()


def prune_by_magnitude(
    w: torch.Tensor, density: float, block: tuple[int, int] | None = None
) -> torch.Tensor:
    """Magnitude pruning to the target density (one LTH round's pruning
    step); returns the pruned weights with hard zeros.

    ``block=(bk, bn)``: two-stage structured variant — keep the top
    ceil(nblocks * density) whole blocks by L2 norm, then element-prune
    inside them down to the exact element count.  Same thresholds and
    tie rule (keep ``>= threshold``) as the reference."""
    if density >= 1.0:
        return w
    if block is None:
        k = max(1, int(w.numel() * density))
        thresh = _kth_largest(w.abs(), k)
        return torch.where(w.abs() >= thresh, w, torch.zeros_like(w))
    bk, bn = block
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"shape {(K, N)} not divisible by block {block}")
    nkb, nnb = K // bk, N // bn
    blocks = w.reshape(nkb, bk, nnb, bn)
    score = blocks.to(torch.float32).square().sum(dim=(1, 3))  # (nkb, nnb)
    nblocks = nkb * nnb
    kb = min(nblocks, max(1, -int(-nblocks * density)))
    thresh = _kth_largest(score, kb)
    keep = (score >= thresh)[:, None, :, None]
    wb = (blocks * keep.to(w.dtype)).reshape(K, N)
    n_keep = max(1, int(w.numel() * density))
    if kb * bk * bn > n_keep:
        et = _kth_largest(wb.abs(), n_keep)
        wb = torch.where(wb.abs() >= et, wb, torch.zeros_like(wb))
    return wb


def weight_density(w: torch.Tensor) -> float:
    """Measured fraction of non-zero weights (host helper)."""
    return float((w != 0).float().mean())


def assert_weight_density(w, density: float, tol: float = 0.05) -> None:
    """Load-time check that stored params carry the hard zeros the config
    promises (the prune-once contract)."""
    got = weight_density(w)
    if got > density + tol:
        raise ValueError(
            f"stored weights have density {got:.3f} > configured "
            f"{density:.3f}; prune at init/load (prune_by_magnitude) before "
            "serving the dual-sparse path"
        )


def sparsity_mask(w: torch.Tensor) -> torch.Tensor:
    """The stored hard-zero pattern as a multiplicative {0,1} mask."""
    return (w != 0).to(w.dtype)


def freeze_pruned(w: torch.Tensor) -> torch.Tensor:
    """Identity on values; gradients reach surviving weights only."""
    return w * sparsity_mask(w).detach()


def _preprocess(packed: torch.Tensor, cfg: SpikingConfig) -> torch.Tensor:
    """Packed words after the silent-neuron preprocessing of ``cfg``."""
    if cfg.preprocess_min_spikes > 0:
        return mask_low_activity(packed, cfg.preprocess_min_spikes)
    return packed


def spiking_linear_train(
    spikes: torch.Tensor, w: torch.Tensor, cfg: SpikingConfig
) -> torch.Tensor:
    """(T, M, K) float spikes x (K, N) -> (T, M, N) float spikes: the
    differentiable training path (surrogate-gradient BPTT)."""
    if cfg.preprocess_min_spikes > 0:
        spikes = mask_low_activity_spikes(spikes, cfg.preprocess_min_spikes)
    out, _ = lif_forward(ftp_spmspm_unpacked(spikes, w), v_th=cfg.v_th,
                         tau=cfg.tau)
    return out


def spiking_linear_infer(
    packed: torch.Tensor, w: torch.Tensor, cfg: SpikingConfig
) -> torch.Tensor:
    """(M, K) packed words x (K, N) dense weights -> (M, N) packed words
    (one LoAS layer): the fused dense-weight kernel (kernel 2) for words on
    the card, the plain `ftp_layer` for words on the CPU."""
    packed = _preprocess(packed, cfg)
    if packed.is_cuda:
        from repro_torch.kernels import ops
        from repro_torch.serve.policy import PACKED_DENSE

        out_packed, _ = ops.dispatch(
            packed, w, PACKED_DENSE, cfg.T,
            fuse_lif=True, v_th=cfg.v_th, tau=cfg.tau,
        )
        return out_packed
    out_packed, _ = ftp_layer(packed, w, cfg.T, v_th=cfg.v_th, tau=cfg.tau)
    return out_packed


def init_spiking_ffn(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    dtype=torch.float32,
    weight_density: float = 1.0,
    prune_block: tuple[int, int] | None = None,
) -> dict:
    """Init (and, when ``weight_density < 1``, LTH-prune) the FFN weights
    with draws from ``generator`` (on the generator's device)."""
    dev = generator.device
    w_in = torch.randn((d_model, d_ff), generator=generator, device=dev)
    w_out = torch.randn((d_ff, d_model), generator=generator, device=dev)
    w_in = (w_in / math.sqrt(d_model)).to(dtype)
    w_out = (w_out / math.sqrt(d_ff)).to(dtype)
    if weight_density < 1.0:
        w_in = prune_by_magnitude(w_in, weight_density, block=prune_block)
        w_out = prune_by_magnitude(w_out, weight_density, block=prune_block)
    return {"w_in": w_in, "w_out": w_out}


def attach_join_plans(params: dict, cfg: SpikingConfig) -> dict:
    """Load-time step of the dual-sparse serving path: one `WeightJoinPlan`
    per GEMM from the stored (pruned) weights, attached as ``plan_in`` /
    ``plan_out``.  Also where the configured density is asserted."""
    from repro_torch.kernels.join_plan import build_weight_plan

    if cfg.weight_density < 1.0:
        assert_weight_density(params["w_in"], cfg.weight_density)
        assert_weight_density(params["w_out"], cfg.weight_density)
    return dict(
        params,
        plan_in=build_weight_plan(params["w_in"]),
        plan_out=build_weight_plan(params["w_out"]),
    )


def spiking_ffn_apply_packed(
    params: dict,
    packed_in: torch.Tensor,
    cfg: SpikingConfig,
    plans: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Spike-domain FFN: (..., d_model) packed int32 words in, (analog out
    (..., d_model), packed hidden words (..., d_ff)).

    Callers that already hold packed words skip the direct encode and keep
    the hidden activations packed.  With plans (argument or attached) both
    GEMMs run dual-sparse through the BSR kernel; without, against the dense
    weights (`_ffn_dense`)."""
    w_in, w_out = params["w_in"], params["w_out"]
    if plans is None:
        plans = (params.get("plan_in"), params.get("plan_out"))
    plan_in, plan_out = plans
    lead = packed_in.shape[:-1]
    pm = _preprocess(packed_in.reshape(-1, packed_in.shape[-1]), cfg)
    if plan_in is not None:
        packed_h, o = _ffn_dual_sparse(pm, plan_in, plan_out, w_in, w_out, cfg)
    else:
        packed_h, o = _ffn_dense(pm, w_in, w_out, cfg)
    return rate_decode(o).reshape(*lead, -1), packed_h.reshape(*lead, -1)


def _ffn_dense(pm, w_in, w_out, cfg: SpikingConfig):
    """Both FFN GEMMs against the dense weights: the dense-weight kernels
    (fused P-LIF on the hidden layer, full sums on the output layer) for
    words on the card, the plain FTP layer and contraction for words on the
    CPU.  Returns (packed hidden words (M, F), full sums (T, M, D))."""
    if pm.is_cuda:
        from repro_torch.kernels import ops
        from repro_torch.serve.policy import PACKED_DENSE

        packed_h, _ = ops.dispatch(
            pm, w_in, PACKED_DENSE, cfg.T,
            fuse_lif=True, v_th=cfg.v_th, tau=cfg.tau,
        )
        return packed_h, ops.dispatch(packed_h, w_out, PACKED_DENSE, cfg.T)
    packed_h, _ = ftp_layer(pm, w_in, cfg.T, cfg.v_th, cfg.tau)
    return packed_h, ftp_spmspm(packed_h, w_out, cfg.T)


def _ffn_dual_sparse(pm, plan_in, plan_out, w_in, w_out, cfg: SpikingConfig,
                     policy=None):
    """Both FFN GEMMs through the dual-sparse BSR kernel: fused P-LIF on the
    hidden layer (packed words out), full sums on the output layer, under
    ``policy`` (default PACKED_DUAL; an adaptive temporal axis gates the
    planes in the kernel).  Returns (packed hidden words (M, F), full sums
    (T, M, D))."""
    from repro_torch.kernels import ops
    from repro_torch.serve.policy import PACKED_DUAL

    policy = PACKED_DUAL if policy is None else policy
    packed_h, _ = ops.dispatch(
        pm, plan_in, policy, cfg.T,
        fuse_lif=True, v_th=cfg.v_th, tau=cfg.tau, n_out=w_in.shape[1],
    )
    o, _ = ops.dispatch(
        packed_h, plan_out, policy, cfg.T,
        fuse_lif=False, n_out=w_out.shape[1],
    )
    return packed_h, o


def spiking_ffn_apply(
    params: dict,
    x: torch.Tensor,
    cfg: SpikingConfig,
    mode: str = "train",
    plans: tuple | None = None,
    policy=None,
) -> torch.Tensor:
    """x: (..., d_model) analog activations -> (..., d_model).

    direct-encode(x) -> spikes --W_in--> LIF -> spikes --W_out--> full sums
    -> rate decode.  In ``infer`` mode a (plan_in, plan_out) pair (argument
    or attached by `attach_join_plans`) runs both GEMMs through the
    dual-sparse BSR kernel (under ``policy``, default PACKED_DUAL); without
    plans they run against the dense weights: the dense-weight kernels on
    the card, the plain FTP path on the CPU."""
    w_in, w_out = params["w_in"], params["w_out"]
    if plans is None:
        plans = (params.get("plan_in"), params.get("plan_out"))
    plan_in, plan_out = plans
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    spikes_in = direct_encode(xm, cfg.T, v_th=cfg.v_th, tau=cfg.tau)
    if mode == "train":
        if cfg.weight_density < 1.0:
            w_in, w_out = freeze_pruned(w_in), freeze_pruned(w_out)
        hidden = spiking_linear_train(spikes_in, w_in, cfg)
        o = ftp_spmspm_unpacked(hidden, w_out)
    elif mode == "infer":
        packed_in = _preprocess(pack_spikes(spikes_in), cfg)
        if plan_in is not None:
            _, o = _ffn_dual_sparse(packed_in, plan_in, plan_out, w_in, w_out,
                                    cfg, policy)
        else:
            _, o = _ffn_dense(packed_in, w_in, w_out, cfg)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return rate_decode(o).reshape(*lead, -1).to(x.dtype)
