"""LM assembly of the recurrent backbones (port of `repro.models.ssm_lm`):
RWKV6 (the ``ssm`` family) and Zamba2 (the ``hybrid`` family).

The embedding, final norm, unembedding and chunked cross entropy are the
transformer module's; only the layer stack differs.  Params are dicts with
per-layer lists where the reference stacks a leading layer axis
(``layers`` for RWKV6, ``mamba`` for Zamba2; Zamba2's ``shared`` block is
one dict), walked in Python loops with `torch.utils.checkpoint` per layer
where the reference remats its scan body.

Serving state.  RWKV6: ``tm_prev`` / ``cm_prev`` (L, B, D) bf16, ``wkv``
(L, B, H, dh, dh) f32 and ``pos``, a host int advanced by every forward's
S.  Zamba2 keeps the reference's leaves under flat keys: ``conv`` (L, B,
W-1, d_in) bf16, ``ssm`` (L, B, H, dh, St) f32, and the shared block's
attention cache ``attn_k`` / ``attn_v`` (G, B, S_cache, KV, dh) bf16 (one
slab per application, written in place), ``kv_pos`` (S_cache,) and
``pos``, where the reference nests ``attn: {k, v, kv_pos, pos}``.  The
engine's cache code (`serve/batching.py`, `serve/paging.py`) classifies
flat leaves by their axes.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from . import mamba2, rwkv6
from .layers import _ct, _dt, dense_init, rmsnorm
from . import transformer
from .transformer import (
    cast_matrices,
    ce_sums,
    embed_tokens,
    unembed,
    unembed_blocks,
)


def _maybe_checkpoint(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, checkpointed when ``cfg.remat`` and autograd records
    (the reference's remat of its scan body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _cast(tree: dict, keys, ct) -> dict:
    return {k: (w.to(ct) if k in keys else w) for k, w in tree.items()}


def _head_init(cfg: ArchConfig, gen: torch.Generator):
    return (dense_init(gen, (cfg.vocab, cfg.d_model), _dt(cfg), fan_in=cfg.d_model),
            torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=gen.device))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def rwkv_init(cfg: ArchConfig, gen: torch.Generator) -> dict:
    embed, final_norm = _head_init(cfg, gen)
    return {
        "embed": embed,
        "layers": [rwkv6.block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "final_norm": final_norm,
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), _dt(cfg)),
    }


def rwkv_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `rwkv_init`'s tree (``layers`` a per-layer list)."""
    return {
        "embed": ("vocab", "d_model"),
        "layers": [rwkv6.block_axes(cfg) for _ in range(cfg.n_layers)],
        "final_norm": (None,),
        "lm_head": ("d_model", "vocab"),
    }


def rwkv_prepare(cfg: ArchConfig, params: dict) -> dict:
    """Load-time casts the forward repeats on every call: each layer's
    projections and mixing factors in the compute dtype, the unembedding as
    the f32 column blocks (`layers.vocab_blocks`) of its compute-dtype
    cast.  Every forward sees the same values; only the per-call casts
    go."""
    ct = _ct(cfg)
    return dict(params,
                layers=[_cast(lp, rwkv6.CAST_KEYS, ct) for lp in params["layers"]],
                unembed=unembed_blocks(params, cfg))


def _rwkv_stack(p, x, cfg: ArchConfig, states=None):
    """``states``: None (training: zero states, discarded) or the stacked
    serving state; returns (x, new states or None)."""
    if states is None:
        def body(lp, x):
            return rwkv6.block_apply(lp, x, cfg)[0]

        for lp in p["layers"]:
            x = _maybe_checkpoint(cfg, body, lp, x)
        return x, None
    new = {k: [] for k in ("tm_prev", "cm_prev", "wkv")}
    for i, lp in enumerate(p["layers"]):
        x, st = rwkv6.block_apply(lp, x, cfg,
                                  state={k: states[k][i] for k in new})
        for k in new:
            new[k].append(st[k])
    out = {k: torch.stack(v) for k, v in new.items()}
    out["pos"] = states["pos"] + x.shape[1]
    return x, out


def _hooked_embed(p, cfg: ArchConfig, tokens):
    return transformer._shard_hook(embed_tokens(p, cfg, tokens), "residual")


def rwkv_loss_parts(p, cfg: ArchConfig, batch: dict):
    """(cross-entropy sum, token count, 0.0): `transformer.loss_parts` of
    the RWKV6 stack."""
    x, _ = _rwkv_stack(p, _hooked_embed(p, cfg, batch["tokens"]), cfg)
    total, count = ce_sums(p, cfg, rmsnorm(x, p["final_norm"], cfg.norm_eps),
                           batch["labels"])
    return total, count, 0.0


def rwkv_loss(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    total, count, _ = rwkv_loss_parts(p, cfg, batch)
    return total / torch.clamp(count, min=1.0)


def rwkv_prefill(p, cfg: ArchConfig, batch: dict, states, *,
                 spiking_mode: str = "train"):
    """The prompt through the stack from ``states``: last-position logits
    (B, 1, V) and the new states (``pos`` advanced by S).  ``spiking_mode``
    is the engine's; no FFN of this family reads it."""
    x, new = _rwkv_stack(p, _hooked_embed(p, cfg, batch["tokens"]), cfg, states)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x[:, -1:]), new


def rwkv_decode(p, cfg: ArchConfig, tokens, states, *,
                spiking_mode: str = "train"):
    """tokens (B, S) -> (logits (B, S, V), new states)."""
    x, new = _rwkv_stack(p, embed_tokens(p, cfg, tokens), cfg, states)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x), new


# ---------------------------------------------------------------------------
# Zamba2
# ---------------------------------------------------------------------------

def _zamba_groups(cfg: ArchConfig):
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return every, n_groups, cfg.n_layers - n_groups * every


def zamba_init(cfg: ArchConfig, gen: torch.Generator) -> dict:
    embed, final_norm = _head_init(cfg, gen)
    return {
        "embed": embed,
        "mamba": [mamba2.mamba_init(gen, cfg) for _ in range(cfg.n_layers)],
        "shared": mamba2.shared_block_init(gen, cfg),
        "final_norm": final_norm,
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), _dt(cfg)),
    }


def zamba_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `zamba_init`'s tree (``mamba`` a per-layer list)."""
    return {
        "embed": ("vocab", "d_model"),
        "mamba": [mamba2.mamba_axes(cfg) for _ in range(cfg.n_layers)],
        "shared": mamba2.shared_block_axes(cfg),
        "final_norm": (None,),
        "lm_head": ("d_model", "vocab"),
    }


def zamba_prepare(cfg: ArchConfig, params: dict) -> dict:
    """`rwkv_prepare` for Zamba2: each mamba layer's projections and conv,
    the shared block's projections and its attention and MLP matrices (as
    `transformer.prepare_params` casts them), and the unembedding."""
    ct = _ct(cfg)
    sh = params["shared"]
    shared = dict(_cast(sh, ("in_proj", "out_proj"), ct),
                  attn=cast_matrices(sh["attn"], ct),
                  mlp=cast_matrices(sh["mlp"], ct))
    return dict(params,
                mamba=[_cast(lp, mamba2.CAST_KEYS, ct) for lp in params["mamba"]],
                shared=shared, unembed=unembed_blocks(params, cfg))


def _zamba_stack(p, x, cfg: ArchConfig, x0, positions, states=None,
                 spiking_mode: str = "train"):
    """Groups of ``shared_attn_every`` mamba layers, each followed by the
    shared block, then the tail layers.  ``states``: None (training) or the
    flat serving state; x0 is the embedding the shared block sees."""
    every, n_groups, tail = _zamba_groups(cfg)
    layers = p["mamba"]
    if states is None:
        def mamba_body(lp, x):
            return mamba2.mamba_apply(lp, x, cfg)[0]

        def shared_body(x):
            return mamba2.shared_block_apply(p["shared"], x, x0, cfg,
                                             positions=positions,
                                             spiking_mode=spiking_mode)

        for g in range(n_groups):
            for lp in layers[g * every:(g + 1) * every]:
                x = _maybe_checkpoint(cfg, mamba_body, lp, x)
            x = _maybe_checkpoint(cfg, shared_body, x)
        for lp in layers[n_groups * every:]:
            x = _maybe_checkpoint(cfg, mamba_body, lp, x)
        return x, None
    S = x.shape[1]
    pos = states["pos"]
    s_cache = states["attn_k"].shape[2]
    # the slots this forward writes, at pos % s_cache with the start clamped
    # as the reference's dynamic_update_slice clamps it
    start = min(pos % s_cache, s_cache - S)
    kv_pos = states["kv_pos"].clone()
    kv_pos[start:start + S] = pos + torch.arange(S, dtype=torch.int32,
                                                 device=kv_pos.device)
    convs, ssms = [], []

    def run(i, x):
        x, st = mamba2.mamba_apply(layers[i], x, cfg, state={
            "conv": states["conv"][i], "ssm": states["ssm"][i]})
        convs.append(st["conv"])
        ssms.append(st["ssm"])
        return x

    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            x = run(i, x)
        lc = {"k": states["attn_k"][g], "v": states["attn_v"][g],
              "kv_pos": kv_pos, "pos": pos}
        x = mamba2.shared_block_apply(p["shared"], x, x0, cfg, positions=positions,
                                      cache=lc, spiking_mode=spiking_mode)
    for i in range(n_groups * every, n_groups * every + tail):
        x = run(i, x)
    return x, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
               "attn_k": states["attn_k"], "attn_v": states["attn_v"],
               "kv_pos": kv_pos, "pos": pos + S}


def zamba_loss_parts(p, cfg: ArchConfig, batch: dict):
    """(cross-entropy sum, token count, 0.0) of the Zamba2 stack."""
    x0 = _hooked_embed(p, cfg, batch["tokens"])
    B, S = x0.shape[:2]
    positions = torch.arange(S, device=x0.device)[None].expand(B, S)
    x, _ = _zamba_stack(p, x0, cfg, x0, positions)
    total, count = ce_sums(p, cfg, rmsnorm(x, p["final_norm"], cfg.norm_eps),
                           batch["labels"])
    return total, count, 0.0


def zamba_loss(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    total, count, _ = zamba_loss_parts(p, cfg, batch)
    return total / torch.clamp(count, min=1.0)


def zamba_state_init(cfg: ArchConfig, batch: int, max_len: int, *, device) -> dict:
    _, n_groups, _ = _zamba_groups(cfg)
    d_in = cfg.ssm_expand * cfg.d_model
    kv = (n_groups, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, d_in),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "attn_k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "attn_v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "kv_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def zamba_state_axes(cfg: ArchConfig) -> dict:
    return {
        "conv": ("layers", "batch", None, "d_inner"),
        "ssm": ("layers", "batch", "heads", None, None),
        "attn_k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "attn_v": ("layers", "batch", "cache_seq", "kv_heads", None),
        "kv_pos": (None,),
        "pos": (),
    }


def zamba_prefill(p, cfg: ArchConfig, batch: dict, states, *,
                  spiking_mode: str = "train"):
    """The prompt at positions 0..S-1 whatever the state's ``pos`` (as the
    reference); last-position logits (B, 1, V) and the new state."""
    x0 = _hooked_embed(p, cfg, batch["tokens"])
    B, S = x0.shape[:2]
    positions = torch.arange(S, device=x0.device)[None].expand(B, S)
    x, new = _zamba_stack(p, x0, cfg, x0, positions, states, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x[:, -1:]), new


def zamba_decode(p, cfg: ArchConfig, tokens, states, *,
                 spiking_mode: str = "train"):
    """tokens (B, S) -> (logits (B, S, V), new state); every position of
    the window is RoPE'd at the state's ``pos``, as in the reference."""
    x0 = embed_tokens(p, cfg, tokens)
    B, S = x0.shape[:2]
    positions = torch.full((B, S), states["pos"], dtype=torch.long,
                           device=x0.device)
    x, new = _zamba_stack(p, x0, cfg, x0, positions, states, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x), new
