"""Mamba2 (SSD) blocks and Zamba2's weight-shared attention block (port of
`repro.models.mamba2`).

Mamba2: in-projections -> a short depthwise causal conv -> the selective
state space h_t = exp(A dt) h_{t-1} + dt B_t x_t, y = C_t h_t + D x, gated
by silu(z), out-projection; one scalar A per head.  A sequence whose length
is a multiple of ``cfg.ssm_chunk`` runs the SSD chunked form (a masked
L x L product within a chunk, the state touched at chunk boundaries);
every other sequence, and every decode, the per-step scan.  Both are plain
torch, as they are plain JAX in the reference.

Zamba2's shared block sees concat(hidden, original embedding) projected
back to d_model, then attention and the MLP of the port's transformer
layers.

A serving forward (a state or cache is given) runs its projections and
norms over fixed row blocks and the SSD chunk or step over fixed blocks of
`layers.B_BLOCK` rows, so a row's values do not depend on the rows it is
batched with; the training forward keeps plain calls.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .layers import (
    TPSlabs,
    _ct,
    _dt,
    _sigmoid,
    attn_apply,
    attn_init,
    batch_blocks,
    dense_init,
    mlp_apply,
    mlp_init,
    partial_matmul,
    project,
    psum,
    rmsnorm,
    tp_devices,
)
from .scan_utils import chunked_seq_scan

# every use casts these to the compute dtype (`prepare` casts them once);
# dt_bias, a_log and d_skip are read in f32
CAST_KEYS = ("in_x", "in_z", "in_bc", "in_dt", "conv", "out")


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    H, dh, St = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if H * dh != d_in:
        raise ValueError(f"ssm_heads x ssm_head_dim = {H * dh} != d_inner {d_in}")
    dt, dev = _dt(cfg), gen.device
    return {
        "ln": torch.zeros((D,), dtype=dt, device=dev),
        "in_x": dense_init(gen, (D, d_in), dt),
        "in_z": dense_init(gen, (D, d_in), dt),
        "in_bc": dense_init(gen, (D, 2 * St), dt),
        "in_dt": dense_init(gen, (D, H), dt),
        "dt_bias": torch.zeros((H,), dtype=dt, device=dev),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=dev),  # A = -exp
        "d_skip": torch.ones((H,), dtype=dt, device=dev),
        "conv": dense_init(gen, (cfg.conv_width, d_in), dt, fan_in=cfg.conv_width),
        "out": dense_init(gen, (d_in, D), dt),
    }


def _causal_conv(x, w, prev=None):
    """Depthwise causal conv of width W.  x (B, S, C); w (W, C); prev
    (B, W-1, C) carry or None (zeros).  The taps add in Python order from
    0, as the reference's ``sum``.  Returns (y, new prev)."""
    B, S, C = x.shape
    W = w.shape[0]
    if prev is None:
        prev = x.new_zeros((B, W - 1, C))
    xp = torch.cat([prev, x], dim=1)                      # (B, S+W-1, C)
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(W))
    return y, (xp[:, -(W - 1):, :] if W > 1 else prev)


def _ssd_chunk(h, xg, bg, cg, ac, dtg):
    """One SSD chunk: the intra-chunk masked product and the incoming
    state's contribution; returns (state out, y)."""
    L = xg.shape[1]
    # intra-chunk: M[t,s] = exp(ac_t - ac_s) dt_s (B_s . C_t), s <= t
    g = torch.einsum("bts,bls->btl", cg, bg)              # (B, L, L)
    r = ac[:, :, None, :] - ac[:, None, :, :]             # (B, L, L, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=h.device))
    m = torch.where(mask[None, :, :, None], torch.exp(r),
                    torch.zeros((), dtype=r.dtype, device=r.device))
    m = m * g[..., None] * dtg[:, None, :, :]             # (B, t, s, H)
    y = torch.einsum("btsh,bshd->bthd", m, xg)
    # inter-chunk: the incoming state's contribution
    a_t = torch.exp(ac)                                   # (B, L, H)
    y = y + torch.einsum("bls,blh,bhds->blhd", cg, a_t, h)
    # h' = A_L h + sum_s (A_L / A_s) dt_s x_s B_s^T
    a_last = torch.exp(ac[:, -1])                         # (B, H)
    w = torch.exp(ac[:, -1][:, None, :] - ac) * dtg       # (B, L, H)
    dh_new = torch.einsum("blh,blhd,bls->bhds", w, xg, bg)
    return a_last[..., None, None] * h + dh_new, y


def _ssd_chunked(xh, b_t, c_t, decay, dt, ssm0, L: int):
    """Chunked-parallel selective state space (SSD, Mamba2 §6).  xh
    (B, S, H, dh) f32; b_t / c_t (B, S, St); decay (B, S, H) in (0, 1]; dt
    (B, S, H); ssm0 (B, H, dh, St).  Returns (state (B, H, dh, St), y
    (B, S, H, dh)).  Each chunk is checkpointed under autograd (the
    reference remats its chunk)."""
    B, S, H, dh = xh.shape
    St = b_t.shape[-1]
    n = S // L
    xc = xh.reshape(B, n, L, H, dh)
    bc = b_t.reshape(B, n, L, St)
    cc = c_t.reshape(B, n, L, St)
    la = torch.log(torch.clamp(decay, min=1e-20)).reshape(B, n, L, H)
    dtc = dt.reshape(B, n, L, H)
    acum = torch.cumsum(la, dim=2)                        # log A_t (B, n, L, H)
    h, ys = ssm0, []
    for c in range(n):
        args = (h, xc[:, c], bc[:, c], cc[:, c], acum[:, c], dtc[:, c])
        if torch.is_grad_enabled():
            h, y = checkpoint(_ssd_chunk, *args, use_reentrant=False)
        else:
            h, y = _ssd_chunk(*args)
        ys.append(y)
    return h, torch.stack(ys, dim=1).reshape(B, S, H, dh)


def _ssm_steps(xh, b_t, c_t, decay, dt, ssm0, chunk: int):
    """The per-step scan of the selective state space, the same arguments
    as `_ssd_chunked`.  Returns (state, y (B, S, H, dh))."""
    def step(h, inp):
        x_t, b_tt, c_tt, dc_t, dt_t = inp   # (B,H,dh) (B,St) (B,St) (B,H) (B,H)
        dbx = (dt_t[..., None, None] * x_t[..., None]) * b_tt[:, None, None, :]
        h = dc_t[..., None, None] * h + dbx               # (B, H, dh, St)
        return h, torch.einsum("bhds,bs->bhd", h, c_tt)

    xs = tuple(a.transpose(0, 1) for a in (xh, b_t, c_t, decay, dt))
    h, y = chunked_seq_scan(step, ssm0, xs, chunk)
    return h, y.transpose(0, 1)


def mamba_apply(p, x, cfg: ArchConfig, state=None):
    """One Mamba2 block.  ``state``: None (the training forward) or
    dict(conv (B, W-1, d_in) bf16, ssm (B, H, dh, St) f32).  Returns (x,
    new state or None)."""
    B, S, D = x.shape
    d_in = cfg.ssm_expand * D
    H, dh, St = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ct = _ct(cfg)
    serving = state is not None

    def mm(a, w):
        return project(a, w.to(ct), row_invariant=serving)

    xn = rmsnorm(x, p["ln"], cfg.norm_eps, row_invariant=serving).to(ct)
    bc = mm(xn, p["in_bc"])                               # (B, S, 2 St)
    b_t, c_t = bc[..., :St].float(), bc[..., St:].float()
    dt = _softplus(mm(xn, p["in_dt"]).float() + p["dt_bias"].float())  # (B,S,H)
    chunk = cfg.ssm_chunk
    if S > 1 and chunk and S % chunk == 0:
        def core(*a):
            return _ssd_chunked(*a, chunk)
    else:
        def core(*a):
            return _ssm_steps(*a, chunk)

    def heads(in_x, in_z, conv, out, hs, conv0, ssm0, dev=x.device, down=mm):
        """Heads ``hs`` (a slice) of the block, from the in / conv / out
        weights of their d_inner channels: (``down(y, out)``, conv state,
        ssm state)."""
        xd = xn.to(dev)
        xc = mm(xd, in_x)                                 # (B, S, n dh)
        z = mm(xd, in_z)
        n = xc.shape[-1] // dh
        xc, conv_new = _causal_conv(xc, conv, conv0)
        xh = _silu(xc).reshape(B, S, n, dh).float()
        dth = dt[..., hs].to(dev)
        a = -torch.exp(p["a_log"][hs].to(dev))            # (n,)
        decay = torch.exp(a[None, None] * dth)            # (B, S, n)
        if ssm0 is None:
            ssm0 = torch.zeros((B, n, dh, St), dtype=torch.float32, device=dev)
        args = (xh, b_t.to(dev), c_t.to(dev), decay, dth, ssm0)
        if serving:
            # padding rows: x, B, C, dt 0 and decay 1 (log 0), so all finite
            ssm_new, y = batch_blocks(core, args, (0.0, 0.0, 0.0, 1.0, 0.0, 0.0))
        else:
            ssm_new, y = core(*args)
        y = y + p["d_skip"][hs].to(dev).float()[None, None, :, None] * xh
        y = y.reshape(B, S, n * dh).to(ct) * _silu(z)
        return down(y, out), conv_new, ssm_new

    names = ("in_x", "in_z", "conv", "out")
    if isinstance(p["in_x"], TPSlabs):
        # whole SSD heads on each shard: its d_inner channels of in_x /
        # in_z / conv, the conv and SSM state of its channels and heads;
        # out is row-parallel, the states concatenate (exact)
        m = p["in_x"].shards
        hl, cl = H // m, d_in // m
        outs = []
        for j, dev in enumerate(tp_devices(m)):
            hs, cs = slice(j * hl, (j + 1) * hl), slice(j * cl, (j + 1) * cl)
            outs.append(heads(
                *(p[n].slab(j, dev) for n in names), hs,
                state["conv"][..., cs].to(dev) if serving else None,
                state["ssm"][:, hs].to(dev) if serving else None, dev,
                partial_matmul))
        y = psum([o[0] for o in outs], x.device, ct)
        conv_new, ssm_new = (torch.cat([o[i].to(x.device) for o in outs], dim=d)
                             for i, d in ((1, -1), (2, 1)))
    else:
        y, conv_new, ssm_new = heads(
            *(p[n].to(ct) for n in names), slice(None),
            state["conv"] if serving else None,
            state["ssm"] if serving else None)
    x = x + y.to(x.dtype)
    return x, ({"conv": conv_new, "ssm": ssm_new} if serving else None)


# ---------------------------------------------------------------------------
# Zamba2's weight-shared attention block
# ---------------------------------------------------------------------------

def shared_block_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, dt, dev = cfg.d_model, _dt(cfg), gen.device
    return {
        "in_proj": dense_init(gen, (2 * D, D), dt),
        "ln1": torch.zeros((D,), dtype=dt, device=dev),
        "attn": attn_init(gen, cfg),
        "ln2": torch.zeros((D,), dtype=dt, device=dev),
        "mlp": mlp_init(gen, cfg),
        "out_proj": dense_init(gen, (D, D), dt),
    }


def shared_block_apply(p, x, x0, cfg: ArchConfig, *, positions, cache=None,
                       spiking_mode: str = "train"):
    """The weight-shared attention block: it sees concat(hidden x,
    embedding x0).  ``cache``: None (training) or one application's
    dict(k, v, kv_pos, pos) as `layers.attn_apply` takes it (k / v written
    in place).  Returns the new residual stream."""
    ct = _ct(cfg)
    serving = cache is not None

    def norm(a, scale):
        return rmsnorm(a, scale, cfg.norm_eps, row_invariant=serving)

    h = project(torch.cat([x, x0], dim=-1).to(ct), p["in_proj"].to(ct),
                row_invariant=serving)
    h = h + attn_apply(p["attn"], norm(h, p["ln1"]), cfg, positions=positions,
                       cache=cache)
    h = h + mlp_apply(p["mlp"], norm(h, p["ln2"]), cfg, spiking_mode=spiking_mode,
                      row_invariant=serving)
    out = project(h.to(ct), p["out_proj"].to(ct), row_invariant=serving)
    return x + out.to(x.dtype)
