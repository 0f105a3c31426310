"""Plain torch oracles for the kernels (port of `repro.kernels.ref`): the
FTP kernels unpack everything dense and contract; the attention kernels
materialise the full (S, Skv) score matrix."""
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


# ---------------------------------------------------------------------------
# attention (kernels 5-7)
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the reference's mask value and initial running max


def _attn_mask(S: int, Skv: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, Skv) visibility by absolute index: causal keeps jk <= iq, a
    window also drops jk <= iq - window; without causal every key is seen."""
    iq = torch.arange(S, device=device)
    jk = torch.arange(Skv, device=device)
    if not causal:
        return torch.ones((S, Skv), dtype=torch.bool, device=device)
    m = jk[None] <= iq[:, None]
    if window:
        m &= jk[None] > (iq[:, None] - window)
    return m


def _masked_scores(q, k, causal: bool, window: int, scale=None) -> torch.Tensor:
    """(BH, S, Skv) f32 scores, scaled after the dot (by ``dh ** -0.5``
    unless ``scale`` is given), masked with -1e30."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    m = _attn_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return s.masked_fill(~m[None], NEG_INF)


def mha_ref(q, k, v, causal=True, window=0):
    """(BH, S, dh) multi-head attention oracle for the flash kernels."""
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_mha_fwd_plain(q, k, v, causal=True, window=0, scale=None):
    """Plain version of kernel 5: (o (BH, S, dh) in q's dtype, lse (BH, S)
    f32), lse the logsumexp of the masked, scaled f32 scores (``scale``
    defaults to ``dh ** -0.5``)."""
    s = _masked_scores(q, k, causal, window, scale)
    o = torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def _bwd_common(q, k, v, do, lse, delta, causal, window, scale):
    """(p, ds, do as f32) of the backward's recompute: p = exp(s - lse),
    ds = p * (dp - delta) * scale."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.exp(_masked_scores(q, k, causal, window, scale) - lse[..., None])
    g = do.float()
    dp = torch.einsum("bqd,bkd->bqk", g, v.float())
    return p, p * (dp - delta[..., None]) * scale, g


def flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, window=0,
                           scale=None):
    """Plain version of kernel 6's dq kernel: dq = ds k, in q's dtype."""
    _, ds, _ = _bwd_common(q, k, v, do, lse, delta, causal, window, scale)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, window=0,
                            scale=None):
    """Plain version of kernel 6's dk/dv kernel: dk = ds^T q, dv = p^T do,
    in k's and v's dtypes."""
    p, ds, g = _bwd_common(q, k, v, do, lse, delta, causal, window, scale)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, g)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd_plain(q, k, v, o, lse, do, causal=True, window=0):
    """Plain version of kernel 6, by the reference kernels' recompute
    formulas (not autograd of `mha_ref`): delta = rowsum(o * do), then the
    dq and dk/dv halves; returns (dq, dk, dv) in the inputs' dtypes."""
    delta = (o.float() * do.float()).sum(-1)
    dq = flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal, window)
    dk, dv = flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv
