"""RWKV-6 ("Finch") blocks (port of `repro.models.rwkv6`): token-shift
mixing, low-rank data-dependent decay, bonus u, a per-head (dh x dh) WKV
state and a squared-ReLU channel mix.

The WKV recurrence is a per-step scan (`scan_utils.chunked_seq_scan`) in
plain torch, as in the reference, where it is plain JAX outside any Pallas
kernel.  A serving forward (a state is given) runs every projection over
fixed row blocks, its norms' row means likewise, and the recurrence over
fixed blocks of `layers.B_BLOCK` rows, so a row's values do not depend on
the rows it is batched with; the training forward keeps plain calls.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from .layers import (
    TPSlabs,
    _ct,
    _dt,
    _sigmoid,
    batch_blocks,
    dense_init,
    partial_matmul,
    project,
    psum,
    rmsnorm,
    tp_devices,
    tp_sum,
)
from .scan_utils import chunked_seq_scan, token_shift

DECAY_RANK = 64

# time-mix projections and channel-mix matrices: every use casts them to the
# compute dtype (`prepare` casts them once); u and w0 are read in f32
CAST_KEYS = ("mu", "wr", "wk", "wv", "wg", "wo", "wa", "wb",
             "cm_mu", "cm_k", "cm_v", "cm_r")


def block_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    H, dh = cfg.ssm_heads, cfg.ssm_head_dim
    if H * dh != D:
        raise ValueError(f"ssm_heads x ssm_head_dim = {H * dh} != d_model {D}")
    dt, dev = _dt(cfg), gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "ln1": full((D,), 0.0),
        "ln2": full((D,), 0.0),
        "mu": full((5, D), 0.5),          # r, k, v, g, w interpolation
        "wr": dense_init(gen, (D, D), dt),
        "wk": dense_init(gen, (D, D), dt),
        "wv": dense_init(gen, (D, D), dt),
        "wg": dense_init(gen, (D, D), dt),
        "wo": dense_init(gen, (D, D), dt),
        "w0": full((D,), -6.0),           # decay: w0 + tanh(x a) b
        "wa": dense_init(gen, (D, DECAY_RANK), dt),
        "wb": dense_init(gen, (DECAY_RANK, D), dt, fan_in=DECAY_RANK),
        "u": full((H, dh), 0.0),          # bonus
        "ln_x": full((D,), 0.0),
        "cm_mu": full((2, D), 0.5),
        "cm_k": dense_init(gen, (D, F), dt),
        "cm_v": dense_init(gen, (F, D), dt),
        "cm_r": dense_init(gen, (D, D), dt),
    }


def block_axes(cfg: ArchConfig) -> dict:
    """Logical axes of one layer's `block_init` leaves: the decay path is
    head-sharded like r / k / v, so the WKV recurrence is TP-local."""
    return {
        "ln1": (None,), "ln2": (None,), "mu": (None, "d_model"),
        "wr": ("d_model", "heads_flat"), "wk": ("d_model", "heads_flat"),
        "wv": ("d_model", "heads_flat"), "wg": ("d_model", "heads_flat"),
        "wo": ("heads_flat", "d_model"),
        "w0": ("heads_flat",), "wa": ("d_model", None), "wb": (None, "heads_flat"),
        "u": ("heads", None), "ln_x": (None,),
        "cm_mu": (None, "d_model"),
        "cm_k": ("d_model", "d_ff"), "cm_v": ("d_ff", "d_model"),
        "cm_r": ("d_model", "d_model"),
    }


def _wkv_scan(r, k, v, w, u, state, chunk: int):
    def step(state, inp):
        r_t, k_t, v_t, w_t = inp                          # (B, H, dh)
        kv = k_t[..., :, None] * v_t[..., None, :]       # (B, H, dh, dh)
        out = torch.einsum("bhk,bhkv->bhv", r_t, state + u[..., None] * kv)
        state = w_t[..., None] * state + kv
        return state, out

    xs = tuple(a.transpose(0, 1) for a in (r, k, v, w))
    state, out = chunked_seq_scan(step, state, xs, chunk)
    return out.transpose(0, 1), state


def _wkv(r, k, v, w, u, state, chunk: int, *, row_invariant: bool = False):
    """WKV recurrence.  r, k, v, w: (B, S, H, dh) f32; u: (H, dh); state
    (B, H, dh, dh) [key x value].  Returns (out (B, S, H, dh), state).
    ``row_invariant`` runs it over zero-padded blocks of `B_BLOCK` rows (a
    zero row's state stays zero)."""
    if not row_invariant:
        return _wkv_scan(r, k, v, w, u, state, chunk)
    return batch_blocks(lambda *a: _wkv_scan(*a[:4], u, a[4], chunk),
                        (r, k, v, w, state), (0.0,) * 5)


def block_apply(p, x, cfg: ArchConfig, state=None):
    """One RWKV6 block.  ``state``: None (the training forward: zero
    states, row-plain calls) or dict(tm_prev (B, D), cm_prev (B, D), wkv
    (B, H, dh, dh) f32) for a serving forward.  Returns (x, new state)."""
    B, S, D = x.shape
    H, dh = cfg.ssm_heads, cfg.ssm_head_dim
    ct = _ct(cfg)
    serving = state is not None
    if state is None:
        state = {
            "tm_prev": x.new_zeros((B, D)),
            "cm_prev": x.new_zeros((B, D)),
            "wkv": torch.zeros((B, H, dh, dh), dtype=torch.float32,
                               device=x.device),
        }

    def mm(a, w):
        return project(a, w.to(ct), row_invariant=serving)

    def norm(a, scale):
        return rmsnorm(a, scale, cfg.norm_eps, row_invariant=serving)

    # ---- time mix ----
    xn = norm(x, p["ln1"])
    shifted, tm_prev = token_shift(xn, state["tm_prev"])
    mu = p["mu"].to(ct)

    def mix(i):
        return (xn + (shifted - xn) * mu[i]).to(ct)

    mixes = [mix(i) for i in range(5)]
    # data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x a) b))
    da = torch.tanh(mm(mixes[4], p["wa"]))

    def heads(r, k, v, g, wb, w0, u, wkv, dev=x.device):
        """The WKV of the heads whose projections are given."""
        r = mm(mixes[0].to(dev), r)
        n = r.shape[-1] // dh
        k = mm(mixes[1].to(dev), k)
        v = mm(mixes[2].to(dev), v)
        g = mm(mixes[3].to(dev), g)
        dd = mm(da.to(dev), wb)
        w = torch.exp(-torch.exp(w0.float() + dd.float())).reshape(B, S, n, dh)
        out, wkv = _wkv(*(t.float().reshape(B, S, n, dh) for t in (r, k, v)),
                        w, u.float(), wkv, cfg.ssm_chunk, row_invariant=serving)
        return out, g * _sigmoid(g), wkv

    names = ("wr", "wk", "wv", "wg", "wb", "w0")
    if isinstance(p["wr"], TPSlabs):
        # heads [j H / m, (j + 1) H / m) on shard j; the WKV outputs, gates
        # and states concatenate (exact), ln_x needs the whole vector
        m = p["wr"].shards
        hl = H // m
        outs = [heads(*(p[n].slab(j, dev) for n in names),
                      p["u"][j * hl:(j + 1) * hl].to(dev),
                      state["wkv"][:, j * hl:(j + 1) * hl].to(dev), dev)
                for j, dev in enumerate(tp_devices(m))]
        out, g, wkv = (torch.cat([o[i].to(x.device) for o in outs], dim=d)
                       for i, d in ((0, 2), (1, -1), (2, 1)))
    else:
        out, g, wkv = heads(*(p[n] for n in names), p["u"], state["wkv"])
    out = norm(out.reshape(B, S, D).to(x.dtype), p["ln_x"])
    x = x + _row_parallel(out.to(ct) * g, p["wo"], mm)

    # ---- channel mix ----
    xn2 = norm(x, p["ln2"])
    shifted2, cm_prev = token_shift(xn2, state["cm_prev"])
    cmu = p["cm_mu"].to(ct)
    xk = (xn2 + (shifted2 - xn2) * cmu[0]).to(ct)
    xr = (xn2 + (shifted2 - xn2) * cmu[1]).to(ct)
    rr = _sigmoid(mm(xr, p["cm_r"]))

    def channel(ws, j, m, dev, down):
        ck, cv = ws
        return down(torch.square(torch.relu(mm(xk.to(dev), ck))), cv)

    x = x + rr * tp_sum(p, ("cm_k", "cm_v"), channel, ct=ct, lead=x.device,
                        down=mm)
    from .transformer import _shard_hook

    x = _shard_hook(x, "residual")  # SP: residual carry (batch, seq->model)
    return x, {"tm_prev": tm_prev, "cm_prev": cm_prev, "wkv": wkv}


def _row_parallel(a: torch.Tensor, w, mm) -> torch.Tensor:
    """``mm(a, w)``; for `TPSlabs` row slabs, shard j's f32 partial of a's
    column block j by slab j (`partial_matmul`), the partials added in
    `psum`."""
    if not isinstance(w, TPSlabs):
        return mm(a, w)
    kl = a.shape[-1] // w.shards
    parts = [partial_matmul(a[..., j * kl:(j + 1) * kl].to(dev), w.slab(j, dev))
             for j, dev in enumerate(tp_devices(w.shards))]
    return psum(parts, a.device, a.dtype)


def state_init(cfg: ArchConfig, batch: int, *, device) -> dict:
    """The serving state: token-shift rows in bf16, the WKV state in f32,
    ``pos`` (positions consumed) a host int."""
    H, dh, D, L = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_model, cfg.n_layers
    return {
        "tm_prev": torch.zeros((L, batch, D), dtype=torch.bfloat16, device=device),
        "cm_prev": torch.zeros((L, batch, D), dtype=torch.bfloat16, device=device),
        "wkv": torch.zeros((L, batch, H, dh, dh), dtype=torch.float32,
                           device=device),
        "pos": 0,
    }


def state_axes(cfg: ArchConfig) -> dict:
    return {
        "tm_prev": ("layers", "batch", "d_model"),
        "cm_prev": ("layers", "batch", "d_model"),
        "wkv": ("layers", "batch", "heads", None, None),
        "pos": (),
    }
