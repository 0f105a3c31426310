"""Uniform Model interface (port of `repro.models.registry`, the dense
transformer family only; ``axes`` waits for the multi-device slice).

    init(seed=0, *, device=None) -> params      (seeded torch.Generator)
    loss(params, batch) -> scalar loss          (the training forward)
    prepare(params) -> params                   (load-time casts for serving)
    prefill(params, batch, cache, *, spiking_mode) -> (logits, cache)
    decode(params, tokens, cache, *, spiking_mode) -> (logits, cache)
    init_cache(batch, max_len, *, device=None) -> cache    cache_axes()

``device=None`` means the CUDA device; without one the call raises rather
than run on the CPU — pass ``device="cpu"`` for that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig

from . import transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    prepare: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    cache_axes: Callable


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is a later slice of the port; "
            "see ROADMAP.md"
        )

    def init(seed: int = 0, *, device=None):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return transformer.init_params(cfg, gen)

    def init_cache(batch: int, max_len: int, *, device=None):
        return transformer.init_cache(cfg, batch, max_len,
                                      device=resolve_device(device))

    return Model(
        cfg=cfg,
        init=init,
        loss=lambda p, b: transformer.loss_fn(p, cfg, b),
        prepare=lambda p: transformer.prepare_params(cfg, p),
        prefill=lambda p, b, c, **kw: transformer.prefill(p, cfg, b, c, **kw),
        decode=lambda p, t, c, **kw: transformer.decode_step(p, cfg, t, c, **kw),
        init_cache=init_cache,
        cache_axes=lambda: transformer.cache_axes(cfg),
    )
