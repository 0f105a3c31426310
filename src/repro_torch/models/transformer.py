"""Transformer LM (port of `repro.models.transformer`): decoder-only dense
and MoE archs (causal or sliding-window attention), the bidirectional
encoder (hubert: frame embeddings in, no decode) and the VLM backbone
(llava: projected image embeddings over the first positions); the training
forward and loss, and serving's prefill and decode over a KV cache.

Params are a dict; ``params["layers"]`` is a list of per-layer dicts (the
reference stacks them on a leading axis and scans; the port walks them in a
Python loop, with `torch.utils.checkpoint` per layer where the reference
remats its scan body).  The KV cache keeps the reference's stacked layout —
``k/v (L, B, S, KV, dh)`` — with ``kv_pos`` (S,) the absolute position held
by each slot (-1 = empty) and ``pos`` the number of positions written, a
host int.  A sliding-window arch's cache is a ring of ``window`` slots
(position p in slot p % window).  A serving forward writes its new k/v rows
into the cache IN PLACE and returns the cache dict with the advanced
``kv_pos``/``pos``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from .layers import (
    EXPERT_WEIGHTS,
    TPSlabs,
    _ct,
    _dt,
    attn_apply,
    attn_axes,
    attn_init,
    cache_slot,
    dense_init,
    mlp_apply,
    mlp_axes,
    mlp_init,
    moe_apply,
    moe_axes,
    moe_init,
    moe_route_groups,
    rmsnorm,
    vocab_blocks,
    vocab_logits,
)

# The residual-stream hook of the train mesh (`sharding.make_shard_hook`),
# called as hook(x, "residual") where the reference calls it; the identity
# off a mesh.
_shard_hook = lambda x, name: x


def set_shard_hook(fn) -> None:
    """Install ``fn`` ((tensor, name) -> the tensor) as the residual hook;
    `reset_shard_hook` puts the identity back."""
    global _shard_hook
    _shard_hook = fn


def reset_shard_hook() -> None:
    set_shard_hook(lambda x, name: x)


def block_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev),
        "attn": attn_init(gen, cfg),
        "ln2": torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def block_axes(cfg: ArchConfig) -> dict:
    """Logical axes of one layer's `block_init` leaves."""
    ax = {"ln1": (None,), "attn": attn_axes(cfg), "ln2": (None,)}
    if cfg.n_experts:
        ax["moe"] = moe_axes(cfg)
    else:
        ax["mlp"] = mlp_axes(cfg)
    return ax


def _attention_half(p, x, cfg: ArchConfig, *, positions, cache=None):
    """A block's attention and its residual add: (the new residual stream,
    its ln2 norm, the FFN's input).  A serving forward (with a cache) takes
    its norms' row means row-invariant (`layers.row_blocks`)."""
    serving = cache is not None
    h = attn_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps,
                                      row_invariant=serving),
                   cfg, positions=positions, cache=cache)
    x = _shard_hook(x + h, "residual")
    return x, rmsnorm(x, p["ln2"], cfg.norm_eps, row_invariant=serving)


def block_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
                spiking_mode: str = "train"):
    """Pre-norm transformer block; returns (the new residual stream, the
    MoE load-balancing term or 0.0).  A serving forward (with a cache)
    takes its norms' row means row-invariant (`layers.row_blocks`)."""
    x, h2 = _attention_half(p, x, cfg, positions=positions, cache=cache)
    if cfg.n_experts:
        h2, aux = moe_apply(p["moe"], h2, cfg)
    else:
        h2, aux = mlp_apply(p["mlp"], h2, cfg, spiking_mode=spiking_mode), 0.0
    return _shard_hook(x + h2, "residual"), aux


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random params drawn from ``gen`` on its device: the reference's
    shapes, scaling and prune-once rule (not its numbers — torch and jax
    generators differ; parity tests bridge the reference's params), in its
    order: the token embedding (archs that embed tokens), the layers, then
    the encoder's ``head`` or an untied arch's ``lm_head`` (D, V), the
    VLM's ``mm_proj`` (D, D), and the zero ``in_norm`` of frame inputs."""
    dev = gen.device
    p = {}
    if cfg.embed_inputs:
        p["embed"] = dense_init(gen, (cfg.vocab, cfg.d_model), _dt(cfg),
                                fan_in=cfg.d_model)
    p["layers"] = [block_init(gen, cfg) for _ in range(cfg.n_layers)]
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev)
    if cfg.encoder_only:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), _dt(cfg))
    elif not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), _dt(cfg))
    if cfg.n_img_tokens:
        p["mm_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), _dt(cfg))
    if not cfg.embed_inputs:
        p["in_norm"] = torch.zeros((cfg.d_model,), dtype=_dt(cfg), device=dev)
    return p


def logical_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `init_params`' tree: ``layers`` is a list of
    per-layer dicts (the reference stacks them under a ``layers`` dim, which
    its rules replicate, so every spec is the same without it)."""
    ax: dict = {}
    if cfg.embed_inputs:
        ax["embed"] = ("vocab", "d_model")
    ax["layers"] = [block_axes(cfg) for _ in range(cfg.n_layers)]
    ax["final_norm"] = (None,)
    if cfg.encoder_only:
        ax["head"] = ("d_model", "vocab")
    elif not cfg.tie_embeddings:
        ax["lm_head"] = ("d_model", "vocab")
    if cfg.n_img_tokens:
        ax["mm_proj"] = ("d_model", "d_model")
    if not cfg.embed_inputs:
        ax["in_norm"] = (None,)
    return ax


def prepare_params(cfg: ArchConfig, params: dict) -> dict:
    """Load-time casts the reference repeats inside every forward: the
    attention and FFN matrices, the experts' (E, ., .) weights and the VLM
    projector in the compute dtype, and the unembedding (the tied embedding
    transposed once, the untied ``lm_head`` or the encoder's ``head``) as
    the f32 column blocks (`layers.vocab_blocks`) of its compute-dtype
    cast.  The values every forward
    sees are unchanged; only the per-call casts go.  The MoE router stays
    f32 (the reference routes in f32: a rounded router would pick other
    experts), the f32 embedding stays for the token lookup (`embed_tokens`
    casts the gathered rows), and the norm scales stay in their dtype (the
    norms upcast them to f32)."""
    ct = _ct(cfg)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp, attn=cast_matrices(lp["attn"], ct))
        if "moe" in lp:
            lp["moe"] = cast_experts(lp["moe"], ct)
        else:
            lp["mlp"] = cast_matrices(lp["mlp"], ct)
        layers.append(lp)
    out = dict(params, layers=layers, unembed=unembed_blocks(params, cfg))
    if "mm_proj" in params:
        out["mm_proj"] = params["mm_proj"].to(ct)
    return out


def cast_matrices(tree: dict, ct: torch.dtype) -> dict:
    """``tree`` with its 2-D tensors (an attention's or an FFN's matrices)
    in ``ct``; other leaves (norm scales, join plans) as they are."""
    return {k: w.to(ct) if isinstance(w, torch.Tensor) and w.ndim == 2
            else w for k, w in tree.items()}


def cast_experts(moe: dict, ct: torch.dtype) -> dict:
    """An MoE dict with its expert weights (`layers.EXPERT_WEIGHTS`) in
    ``ct`` and the router as it is (f32)."""
    return {k: w.to(ct) if k in EXPERT_WEIGHTS else w for k, w in moe.items()}


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
    of the encoder's ``head``, the tied embedding (transposed) or the
    untied ``lm_head``, so an f32 product equals the reference's bf16 x
    bf16 contraction with f32 accumulation."""
    if cfg.encoder_only:
        return p["head"].to(_ct(cfg)).float()
    if not cfg.tie_embeddings:
        return p["lm_head"].to(_ct(cfg)).float()
    return p["embed"].to(_ct(cfg)).float().T.contiguous()


def unembed_blocks(p, cfg: ArchConfig):
    """The serving unembedding: prepared params' ``unembed`` (column blocks,
    or `layers.VocabSlabs` on a serve mesh), else the column blocks of
    `_unembed_weight`."""
    if "unembed" in p:
        return p["unembed"]
    return vocab_blocks(_unembed_weight(p, cfg))


def unembed(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits of the serving forward: the
    product over fixed blocks of rows and of vocab columns
    (`layers.vocab_logits`), so a row's logits do not depend on how many
    rows share the dispatch nor on how the vocab is sharded."""
    B, S, D = x.shape
    xf = x.to(_ct(cfg)).float().reshape(B * S, D)
    return vocab_logits(xf, unembed_blocks(p, cfg)).reshape(B, S, -1)


def embed_batch(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The first residual stream (B, S, D) in the compute dtype: token
    embeddings, with a VLM's projected image embeddings (``img_embed`` (B,
    n_img, D) @ ``mm_proj``) over the first n_img positions — the prompt's
    first S - n_img token embeddings shift right behind them, the rest are
    cut, as the reference's ``concat`` does — or a frame encoder's
    ``frames`` (B, S, D) through its input norm."""
    ct = _ct(cfg)
    if not cfg.embed_inputs:
        return rmsnorm(batch["frames"].to(ct), p["in_norm"], cfg.norm_eps)
    x = embed_tokens(p, cfg, batch["tokens"])
    if cfg.n_img_tokens:
        if "img_embed" not in batch:
            raise ValueError(
                f"{cfg.name} needs img_embed (B, {cfg.n_img_tokens}, "
                f"{cfg.d_model}) beside its tokens: its vision front end is a "
                "stub whose patch embeddings are an input")
        img = batch["img_embed"].to(ct) @ p["mm_proj"].to(ct)
        x = torch.cat([img, x[:, :x.shape[1] - img.shape[1]]], dim=1)
    return x


def _stack_forward(layers, x, cfg: ArchConfig, positions):
    """Walk the layer stack without a cache (the training forward); returns
    (x, the summed MoE load-balancing terms).  With ``cfg.remat`` and
    autograd recording, each layer is checkpointed (its activations
    recomputed in the backward), as the reference remats its scan body."""
    def body(lp, x):
        return block_apply(lp, x, cfg, positions=positions)

    aux = 0.0
    for lp in layers:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x, a = body(lp, x)
        aux = aux + a
    return x, aux


def forward(p, cfg: ArchConfig, batch: dict):
    """Training/eval forward: ``batch`` holds tokens (B, S), or frames
    (B, S, D) (audio), or tokens and img_embed (VLM) -> (final-normed hidden
    states (B, S, D) in the compute dtype, the MoE load-balancing term)."""
    x = _shard_hook(embed_batch(p, cfg, batch), "residual")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, aux = _stack_forward(p["layers"], x, cfg, positions)
    return rmsnorm(x, p["final_norm"], cfg.norm_eps), aux


def ce_loss(p, cfg: ArchConfig, x, labels) -> torch.Tensor:
    """Token-mean cross entropy of the f32 logits of final hidden states;
    label -1 is masked out (`ce_sums` over the count)."""
    total, count = ce_sums(p, cfg, x, labels)
    return total / torch.clamp(count, min=1.0)


def ce_sums(p, cfg: ArchConfig, x, labels):
    """(sum of the unmasked tokens' cross entropies, their count), f32: a
    train mesh adds its data groups' sums and divides by the batch's count.
    With ``cfg.loss_chunk`` dividing B * S (and smaller), the logits exist
    ``loss_chunk`` tokens at a time, each chunk recomputed in the backward
    (the reference's remat'd map).  Under a mesh whose model axis divides
    the vocab (a train step's data group, `kernels.ops.serve_mesh_scope`)
    the logits run over vocab slabs, column slab j of the unembedding on
    shard j's device: each slab's logsumexp, the label's logit from the slab
    that holds it, the slabs' logsumexps combined in shard order on the
    group's lead (Megatron's vocab-parallel cross entropy)."""
    B, S = labels.shape
    xt = x.reshape(B * S, -1)
    lt = labels.reshape(B * S).long()
    mask = (lt >= 0).float()
    lt = torch.clamp(lt, min=0)
    w = _unembed_weight(p, cfg)
    shards = _vocab_shards(w.shape[1])

    def ce(xc, lc):
        if shards > 1:
            return _ce_vocab_slabs(xc.to(_ct(cfg)).float(),
                                   TPSlabs(w, shards, "col"), lc)
        logits = xc.to(_ct(cfg)).float() @ w                        # (c, V)
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
    return torch.sum(losses * mask), torch.sum(mask)


def _vocab_shards(V: int) -> int:
    """The model shards the logits run over: the installed mesh's model
    axis when it divides V, else 1 (whole)."""
    from repro_torch.kernels.ops import get_serve_mesh

    mesh = get_serve_mesh()
    m = 1 if mesh is None else mesh.shape["model"]
    return m if m > 1 and V % m == 0 else 1


def _ce_vocab_slabs(xf: torch.Tensor, w: TPSlabs, lc: torch.Tensor):
    """Per-token cross entropy of f32 rows ``xf`` over the unembedding's
    column slabs (see `ce_sums`)."""
    from .layers import tp_devices

    lead = xf.device
    lses, picked = [], 0.0
    for j, dev in enumerate(tp_devices(w.shards)):
        slab = w.slab(j, w.device)
        width = slab.shape[1]
        logits = xf.to(dev) @ slab.to(dev)                       # (c, V / m)
        lses.append(torch.logsumexp(logits, dim=-1).to(lead))
        ld = lc.to(dev) - j * width
        hit = (ld >= 0) & (ld < width)
        mine = logits.gather(-1, ld.clamp(0, width - 1)[:, None])[:, 0]
        picked = picked + torch.where(hit, mine, torch.zeros_like(mine)).to(lead)
    return torch.logsumexp(torch.stack(lses), dim=0) - picked


def loss_parts(p, cfg: ArchConfig, batch: dict):
    """(cross-entropy sum, unmasked token count, summed load-balancing
    terms) of one batch: `loss_fn`'s pieces, which a train mesh's data
    groups add."""
    x, aux = forward(p, cfg, batch)
    total, count = ce_sums(p, cfg, x, batch["labels"])
    return total, count, aux


def loss_fn(p, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Cross entropy, plus 0.01 x the load-balancing term per layer for an
    MoE arch."""
    total, count, aux = loss_parts(p, cfg, batch)
    loss = total / torch.clamp(count, min=1.0)
    if cfg.n_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


def loss_parts_groups(ps: list, cfg: ArchConfig, batches: list, scope) -> list:
    """`loss_parts` of a train mesh's data groups (group i: params ``ps[i]``
    placed on its mesh row, rows ``batches[i]``, its ops under
    ``scope(i)``), run layer by layer in lockstep: an MoE layer routes the
    whole batch's tokens at once (`layers.moe_route_groups`), so capacity
    and drops are one device's, and each group then runs the experts on its
    own rows.  Each group's graph stays its own (the routing is chosen
    without a gradient), so its backward can run alone."""
    n = len(ps)
    xs, pos = [], []
    for i in range(n):
        with scope(i):
            x = _shard_hook(embed_batch(ps[i], cfg, batches[i]), "residual")
        B, S = x.shape[:2]
        xs.append(x)
        pos.append(torch.arange(S, device=x.device)[None].expand(B, S))

    def attn_half(lp, x, positions):
        return _attention_half(lp, x, cfg, positions=positions)

    def moe_half(mp, x, h2, route):
        y, aux = moe_apply(mp, h2, cfg, route=route)
        return _shard_hook(x + y, "residual"), aux

    def run(fn, *args):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    aux = [0.0] * n
    for li in range(cfg.n_layers):
        h2s = []
        for i in range(n):
            with scope(i):
                xs[i], h2 = run(attn_half, ps[i]["layers"][li], xs[i], pos[i])
            h2s.append(h2)
        routes = moe_route_groups(ps[0]["layers"][li]["moe"]["router"],
                                  [h.reshape(-1, h.shape[-1]) for h in h2s], cfg)
        for i in range(n):
            with scope(i):
                xs[i], a = run(moe_half, ps[i]["layers"][li]["moe"], xs[i],
                               h2s[i], routes[i])
            aux[i] = aux[i] + a
    out = []
    for i in range(n):
        with scope(i):
            x = rmsnorm(xs[i], ps[i]["final_norm"], cfg.norm_eps)
            total, count = ce_sums(ps[i], cfg, x, batches[i]["labels"])
        out.append((total, count, aux[i]))
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: torch.device, dtype=torch.bfloat16,
               full: bool = False) -> dict:
    """An empty KV cache: ``max_len`` slots, or for a sliding-window arch a
    ring of min(max_len, window) unless ``full``."""
    S = min(max_len, cfg.window) if (cfg.attn == "swa" and not full) else max_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kv_pos": torch.full((S,), -1, dtype=torch.int32, device=device),
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
    """Walk the layer stack, writing each layer's k/v rows into the cache
    from slot `layers.cache_slot` on."""
    S = x.shape[1]
    pos = cache["pos"]
    slot = cache_slot(pos, S, cache["k"].shape[2], cfg.attn)
    kv_pos = cache["kv_pos"].clone()
    kv_pos[slot:slot + S] = pos + torch.arange(S, dtype=torch.int32,
                                               device=kv_pos.device)
    for i, lp in enumerate(layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i], "kv_pos": kv_pos,
              "pos": pos}
        x, _ = block_apply(lp, x, cfg, positions=positions, cache=lc,
                           spiking_mode=spiking_mode)
    return x, {"k": cache["k"], "v": cache["v"], "kv_pos": kv_pos,
               "pos": pos + S}


def prefill(p, cfg: ArchConfig, batch: dict, cache, *,
            spiking_mode: str = "train"):
    """Process the whole prompt, fill the cache, return last-token logits
    (B, 1, V) and the cache.

    A sliding-window prompt longer than the ring runs through a temporary
    full-length cache and keeps its last ``window`` slots, which needs
    window | S (the ring's slots then line up with a plain tail).  An
    encoder (hubert) has no decode: its prefill is the encoder forward over
    the whole input, the last position's logits, and the cache untouched."""
    if cfg.encoder_only:
        x, _ = forward(p, cfg, batch)
        return unembed(p, cfg, x[:, -1:]), cache
    x = _shard_hook(embed_batch(p, cfg, batch), "residual")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    w = cache["k"].shape[2]
    if cfg.attn == "swa" and S > w:
        if S % w:
            raise ValueError(
                f"SWA prefill requires window | seq_len (ring of {w} slots, "
                f"prompt of {S})")
        tmp = init_cache(cfg, B, S, device=x.device, dtype=cache["k"].dtype,
                         full=True)
        x, full = _stack_forward_cached(p["layers"], x, cfg, positions, tmp,
                                        spiking_mode)
        cache["k"].copy_(full["k"][:, :, S - w:])
        cache["v"].copy_(full["v"][:, :, S - w:])
        new_cache = dict(cache, kv_pos=full["kv_pos"][S - w:].clone(),
                         pos=full["pos"])
    else:
        x, new_cache = _stack_forward_cached(p["layers"], x, cfg, positions,
                                             cache, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x[:, -1:]), new_cache


def decode_step(p, cfg: ArchConfig, tokens, cache, *,
                spiking_mode: str = "train"):
    """tokens (B, S) -> (logits (B, S, V), cache).  S > 1 is a window of
    consecutive positions; the causal mask inside it comes from the
    absolute positions, as in the reference."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode path")
    x = embed_tokens(p, cfg, tokens)
    B, S = x.shape[:2]
    positions = (cache["pos"] + torch.arange(S, device=x.device))[None].expand(B, S)
    x, new_cache = _stack_forward_cached(p["layers"], x, cfg, positions,
                                         cache, spiking_mode)
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps, row_invariant=True)
    return unembed(p, cfg, x), new_cache
