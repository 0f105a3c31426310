"""Plain torch oracles for the FTP kernels (port of `repro.kernels.ref`):
unpack everything dense and contract."""
from __future__ import annotations

import torch

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import pack_spikes, unpack_spikes


def ftp_spmm_ref(a_packed: torch.Tensor, b: torch.Tensor, T: int) -> torch.Tensor:
    """(M, K) packed x (K, N) -> (T, M, N) f32."""
    a = unpack_spikes(a_packed, T, dtype=torch.float32)
    return torch.einsum("tmk,kn->tmn", a, b.to(torch.float32))


def lif_ref(o: torch.Tensor, v_th: float = DEFAULT_VTH, tau: float = DEFAULT_TAU):
    """(T, M, N) full sums -> (packed spikes (M, N) int32, final U (M, N))."""
    u = torch.zeros_like(o[0])
    fired = []
    for t in range(o.shape[0]):
        x = o[t] + u
        c = x > v_th
        u = tau * x * (1.0 - c.to(o.dtype))
        fired.append(c)
    return pack_spikes(torch.stack(fired)), u


def ftp_spmm_fused_lif_ref(
    a_packed: torch.Tensor,
    b: torch.Tensor,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
):
    return lif_ref(ftp_spmm_ref(a_packed, b, T), v_th=v_th, tau=tau)
