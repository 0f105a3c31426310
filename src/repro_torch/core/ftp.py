"""Fully Temporal-Parallel (FTP) spMspM dataflow, plain torch (port of
`repro.core.ftp`): the reference semantics the kernels are held to.

T is folded into the row dimension, so one (T*M, K) x (K, N) contraction
shares every weight across all timesteps (the paper's `parallel-for t`).
"""
from __future__ import annotations

import torch

from .lif import DEFAULT_TAU, DEFAULT_VTH, lif_forward
from .packing import pack_spikes, unpack_spikes


def ftp_spmspm(packed_a: torch.Tensor, b: torch.Tensor, T: int) -> torch.Tensor:
    """(M, K) int32 packed spikes x (K, N) -> (T, M, N) f32 full sums."""
    a = unpack_spikes(packed_a, T, dtype=torch.float32)
    M, K = packed_a.shape
    o = a.reshape(T * M, K) @ b.to(torch.float32)
    return o.reshape(T, M, b.shape[1])


def ftp_layer(
    packed_a: torch.Tensor,
    b: torch.Tensor,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
):
    """One LoAS layer: FTP spMspM + P-LIF.  Returns (packed output spikes
    (M, N) int32, final potentials (M, N))."""
    o = ftp_spmspm(packed_a, b, T)
    spikes, u = lif_forward(o, v_th=v_th, tau=tau)
    return pack_spikes(spikes), u


def ftp_spmspm_unpacked(spikes: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Training-path FTP spMspM on float {0,1} spikes (differentiable):
    (T, M, K) x (K, N) -> (T, M, N) f32."""
    T, M, K = spikes.shape
    o = spikes.reshape(T * M, K).to(torch.float32) @ b.to(torch.float32)
    return o.reshape(T, M, b.shape[1])


def sequential_spmspm(packed_a: torch.Tensor, b: torch.Tensor, T: int) -> torch.Tensor:
    """Timestep-sequential spMspM, the baseline dataflow of SparTen-SNN /
    GoSPA-SNN / Gamma-SNN: one (M, K) x (K, N) product per timestep, each
    reading B again.  The same values as `ftp_spmspm`; it is a yardstick
    for the FTP schedule, not a kernel.  -> (T, M, N) f32."""
    a = unpack_spikes(packed_a, T, dtype=torch.float32)
    return torch.stack([a[t] @ b.to(torch.float32) for t in range(T)])
