"""Architecture configs of the port, every arch of the reference: the dense
family (gemma-2b, qwen3-14b, nemotron-4-340b, llama3.2-1b), the recurrent
ones (rwkv6-1.6b, the ``ssm`` family; zamba2-7b, the ``hybrid`` one), the
MoE ones (mixtral-8x22b with its sliding window, phi3.5-moe) and the stub
front ends (hubert-xlarge, ``audio``; llava-next-mistral-7b, ``vlm``).
`snn_workloads` holds the paper's Table II workloads beside them; `base`
the assignment's four shape cells (`SHAPES`) and which of them each arch
runs."""
from __future__ import annotations

import importlib

from .base import (
    SHAPES,
    ArchConfig,
    ShapeCell,
    applicable_shapes,
    skip_reason,
    smoke_variant,
)

ARCHS = ["gemma_2b", "qwen3_14b", "nemotron_4_340b", "llama3_2_1b",
         "rwkv6_1_6b", "hubert_xlarge", "llava_next_mistral_7b",
         "mixtral_8x22b", "phi3_5_moe", "zamba2_7b"]

_ALIASES = {
    "gemma-2b": "gemma_2b",
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (known: {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeCell", "applicable_shapes",
           "get_config", "list_archs", "skip_reason", "smoke_variant"]
