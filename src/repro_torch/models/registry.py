"""Uniform Model interface (port of `repro.models.registry`: the
transformer families ``dense``, ``moe``, ``audio`` and ``vlm``, RWKV6
(``ssm``) and Zamba2 (``hybrid``)).

    init(seed=0, *, device=None) -> params      (seeded torch.Generator)
    axes() -> logical-axes tree (the params' structure; `repro_torch.sharding`)
    loss(params, batch) -> scalar loss          (the training forward)
    loss_parts(params, batch) -> (CE sum, token count, MoE aux sum)
    prepare(params) -> params                   (load-time casts for serving)
    prefill(params, batch, cache, *, spiking_mode) -> (logits, cache)
    decode(params, tokens, cache, *, spiking_mode) -> (logits, cache)
    init_cache(batch, max_len, *, device=None) -> cache    cache_axes()
        (a transformer's also takes ``full=True``: a sliding-window arch's
        cache at full length instead of its ring)

``device=None`` means the CUDA device; without one the call raises rather
than run on the CPU — pass ``device="cpu"`` for that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig

from . import rwkv6, ssm_lm, transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    axes: Callable
    loss: Callable
    loss_parts: Callable
    prepare: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    cache_axes: Callable


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        init_params, axes = transformer.init_params, transformer.logical_axes
        loss, prepare = transformer.loss_fn, transformer.prepare_params
        loss_parts = transformer.loss_parts
        prefill, decode = transformer.prefill, transformer.decode_step

        def init_cache(batch, max_len, device, full=False):
            return transformer.init_cache(cfg, batch, max_len, device=device,
                                          full=full)

        cache_axes = transformer.cache_axes
    elif cfg.family == "ssm":
        init_params, axes = ssm_lm.rwkv_init, ssm_lm.rwkv_axes
        loss, prepare = ssm_lm.rwkv_loss, ssm_lm.rwkv_prepare
        loss_parts = ssm_lm.rwkv_loss_parts
        prefill, decode = ssm_lm.rwkv_prefill, ssm_lm.rwkv_decode

        def init_cache(batch, max_len, device):
            return rwkv6.state_init(cfg, batch, device=device)

        cache_axes = rwkv6.state_axes
    elif cfg.family == "hybrid":
        init_params, axes = ssm_lm.zamba_init, ssm_lm.zamba_axes
        loss, prepare = ssm_lm.zamba_loss, ssm_lm.zamba_prepare
        loss_parts = ssm_lm.zamba_loss_parts
        prefill, decode = ssm_lm.zamba_prefill, ssm_lm.zamba_decode

        def init_cache(batch, max_len, device):
            return ssm_lm.zamba_state_init(cfg, batch, max_len, device=device)

        cache_axes = ssm_lm.zamba_state_axes
    else:
        raise ValueError(f"unknown family {cfg.family!r}")

    def init(seed: int = 0, *, device=None):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return init_params(cfg, gen)

    return Model(
        cfg=cfg,
        init=init,
        axes=lambda: axes(cfg),
        loss=lambda p, b: loss(p, cfg, b),
        loss_parts=lambda p, b: loss_parts(p, cfg, b),
        prepare=lambda p: prepare(cfg, p),
        prefill=lambda p, b, c, **kw: prefill(p, cfg, b, c, **kw),
        decode=lambda p, t, c, **kw: decode(p, cfg, t, c, **kw),
        init_cache=lambda b, s, *, device=None, **kw: init_cache(
            b, s, resolve_device(device), **kw),
        cache_axes=lambda: cache_axes(cfg),
    )
