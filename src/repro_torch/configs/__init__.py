"""Architecture configs of the port: the dense family (llama3.2-1b,
gemma-2b, qwen3-14b, nemotron-4-340b) and the recurrent ones (rwkv6-1.6b,
the ``ssm`` family; zamba2-7b, the ``hybrid`` one).  The reference's other
archs are later slices, listed in ROADMAP.md."""
from __future__ import annotations

import importlib

from .base import ArchConfig, smoke_variant

ARCHS = ["gemma_2b", "qwen3_14b", "nemotron_4_340b", "llama3_2_1b",
         "rwkv6_1_6b", "zamba2_7b"]

_ALIASES = {
    "gemma-2b": "gemma_2b",
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {ARCHS}); the other "
            "model families are later slices, see ROADMAP.md"
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "get_config", "list_archs", "smoke_variant"]
