"""Decoder-only transformer LM, dense-attention family (port of
`repro.models.transformer`): the training forward and loss, and serving's
prefill and decode over a KV cache.

Params are a dict; ``params["layers"]`` is a list of per-layer dicts (the
reference stacks them on a leading axis and scans; the port walks them in a
Python loop, with `torch.utils.checkpoint` per layer where the reference
remats its scan body).  The KV cache keeps the reference's stacked layout —
``k/v (L, B, S, KV, dh)`` — with ``kv_pos`` (S,) the absolute position held
by each slot (-1 = empty) and ``pos`` the number of positions written, a
host int.  A serving forward writes its new k/v rows into the cache IN PLACE
and returns the cache dict with the advanced ``kv_pos``/``pos``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .layers import (
    _ct,
    _dt,
    attn_apply,
    attn_init,
    dense_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    row_blocks,
)


def _check_arch(cfg: ArchConfig) -> None:
    if (cfg.n_experts or not cfg.embed_inputs or cfg.encoder_only
            or cfg.n_img_tokens):
        raise NotImplementedError(
            f"{cfg.name}: MoE, audio/VLM front ends and encoders are later "
            "slices of the port; see ROADMAP.md"
        )


def block_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev),
        "attn": attn_init(gen, cfg),
        "ln2": torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev),
        "mlp": mlp_init(gen, cfg),
    }


def block_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
                spiking_mode: str = "train"):
    """Pre-norm transformer block; returns the new residual stream.  A
    serving forward (with a cache) takes its norms' row means row-invariant
    (`layers.row_blocks`)."""
    serving = cache is not None
    h = attn_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps,
                                      row_invariant=serving),
                   cfg, positions=positions, cache=cache)
    x = x + h
    h2 = mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps,
                                     row_invariant=serving),
                   cfg, spiking_mode=spiking_mode)
    return x + h2


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random params drawn from ``gen`` on its device: the reference's
    shapes, scaling and prune-once rule (not its numbers — torch and jax
    generators differ; parity tests bridge the reference's params).  An
    untied arch gets its (D, V) ``lm_head``, drawn after the layers."""
    _check_arch(cfg)
    p = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), _dt(cfg),
                            fan_in=cfg.d_model),
        "layers": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=_dt(cfg),
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), _dt(cfg))
    return p


def prepare_params(cfg: ArchConfig, params: dict) -> dict:
    """Load-time casts the reference repeats inside every forward: the
    attention and FFN matrices in the compute dtype, and the unembedding
    (the tied embedding transposed once, or the untied ``lm_head``) as the
    f32 values of its compute-dtype cast.  The values every forward sees
    are unchanged; only the per-call casts go.  The f32 embedding stays for
    the token lookup (`embed_tokens` casts the gathered rows), and the
    qk-norm scales stay in their dtype (the norm upcasts them to f32)."""
    ct = _ct(cfg)
    layers = [dict(lp, attn=cast_matrices(lp["attn"], ct),
                   mlp=cast_matrices(lp["mlp"], ct))
              for lp in params["layers"]]
    return dict(params, layers=layers,
                unembed=_unembed_weight(params, cfg))


def cast_matrices(tree: dict, ct: torch.dtype) -> dict:
    """``tree`` with its 2-D tensors (an attention's or an FFN's matrices)
    in ``ct``; other leaves (norm scales, join plans) as they are."""
    return {k: w.to(ct) if isinstance(w, torch.Tensor) and w.ndim == 2
            else w for k, w in tree.items()}


def embed_tokens(p, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The compute-dtype embedding rows of ``tokens``; a config with
    ``embed_scale`` (gemma) scales them by sqrt(d_model) rounded to that
    dtype first, as the reference does."""
    e = p["embed"][tokens].to(_ct(cfg))
    if cfg.embed_scale:
        e = e * float(torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype))
    return e


def _unembed_weight(p, cfg: ArchConfig) -> torch.Tensor:
    """(D, V) f32 weight of the logits contraction: the compute-dtype values
    of the tied embedding (transposed) or of the untied ``lm_head``, so an
    f32 product equals the reference's bf16 x bf16 contraction with f32
    accumulation."""
    if "unembed" in p:
        return p["unembed"]
    if not cfg.tie_embeddings:
        return p["lm_head"].to(_ct(cfg)).float()
    return p["embed"].to(_ct(cfg)).float().T.contiguous()


def unembed(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits of the serving forward: the
    product over fixed blocks of rows (`layers.row_blocks`), so a row's
    logits do not depend on how many rows share the dispatch."""
    B, S, D = x.shape
    xf = x.to(_ct(cfg)).float().reshape(B * S, D)
    return row_blocks(torch.matmul, xf, _unembed_weight(p, cfg)).reshape(B, S, -1)


def _stack_forward(layers, x, cfg: ArchConfig, positions):
    """Walk the layer stack without a cache (the training forward).  With
    ``cfg.remat`` and autograd recording, each layer is checkpointed (its
    activations recomputed in the backward), as the reference remats its
    scan body."""
    def body(lp, x):
        return block_apply(lp, x, cfg, positions=positions)

    for lp in layers:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x = body(lp, x)
    return x


def forward(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Training/eval forward: tokens (B, S) -> final-normed hidden states
    (B, S, D) in the compute dtype (the reference also returns the MoE
    auxiliary loss, which no ported arch has)."""
    x = embed_tokens(p, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = _stack_forward(p["layers"], x, cfg, positions)
    return rmsnorm(x, p["final_norm"], cfg.norm_eps)


def ce_loss(p, cfg: ArchConfig, x, labels) -> torch.Tensor:
    """Token-mean cross entropy of the f32 logits of final hidden states;
    label -1 is masked out.  With ``cfg.loss_chunk`` dividing B * S (and
    smaller), the logits exist ``loss_chunk`` tokens at a time, each chunk
    recomputed in the backward (the reference's remat'd map)."""
    B, S = labels.shape
    xt = x.reshape(B * S, -1)
    lt = labels.reshape(B * S).long()
    mask = (lt >= 0).float()
    lt = torch.clamp(lt, min=0)

    def ce(xc, lc):
        logits = xc.to(_ct(cfg)).float() @ _unembed_weight(p, cfg)  # (c, V)
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, lc[:, None])[:, 0]

    c = cfg.loss_chunk
    if c and (B * S) % c == 0 and (B * S) > c:
        run = ((lambda a, b: checkpoint(ce, a, b, use_reentrant=False))
               if torch.is_grad_enabled() else ce)
        losses = torch.cat([run(xt[i:i + c], lt[i:i + c])
                            for i in range(0, B * S, c)])
    else:
        losses = ce(xt, lt)
    return torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    return ce_loss(p, cfg, forward(p, cfg, batch), batch["labels"])


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device, dtype=torch.bfloat16) -> dict:
    if cfg.attn != "causal":
        raise NotImplementedError(
            f"attn={cfg.attn!r} ring caches are a later slice; see ROADMAP.md"
        )
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kv_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def cache_axes(cfg: ArchConfig) -> dict:
    return {
        "k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "cache_seq", "kv_heads", None),
        "kv_pos": (None,),
        "pos": (),
    }


def _stack_forward_cached(layers, x, cfg: ArchConfig, positions, cache,
                          spiking_mode: str):
    """Walk the layer stack, writing each layer's k/v rows into the cache."""
    S = x.shape[1]
    pos = cache["pos"]
    kv_pos = cache["kv_pos"].clone()
    kv_pos[pos:pos + S] = pos + torch.arange(S, dtype=torch.int32,
                                             device=kv_pos.device)
    for i, lp in enumerate(layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i], "kv_pos": kv_pos,
              "pos": pos}
        x = block_apply(lp, x, cfg, positions=positions, cache=lc,
                        spiking_mode=spiking_mode)
    return x, {"k": cache["k"], "v": cache["v"], "kv_pos": kv_pos,
               "pos": pos + S}


def prefill(p, cfg: ArchConfig, batch: dict, cache, *,
            spiking_mode: str = "train"):
    """Process the whole prompt, fill the cache, return last-token logits
    (B, 1, V) and the cache."""
    x = embed_tokens(p, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, new_cache = _stack_forward_cached(p["layers"], x, cfg, positions,
                                         cache, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x[:, -1:]), new_cache


def decode_step(p, cfg: ArchConfig, tokens, cache, *,
                spiking_mode: str = "train"):
    """tokens (B, S) -> (logits (B, S, V), cache).  S > 1 is a window of
    consecutive positions; the causal mask inside it comes from the
    absolute positions, as in the reference."""
    x = embed_tokens(p, cfg, tokens)
    B, S = x.shape[:2]
    positions = (cache["pos"] + torch.arange(S, device=x.device))[None].expand(B, S)
    x, new_cache = _stack_forward_cached(p["layers"], x, cfg, positions,
                                         cache, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x), new_cache
