"""Architecture configs of the port.  Only the main path's arch is ported
so far; the rest of the reference's zoo is listed in ROADMAP.md."""
from __future__ import annotations

import importlib

from .base import ArchConfig, smoke_variant

ARCHS = ["llama3_2_1b"]

_ALIASES = {"llama3.2-1b": "llama3_2_1b"}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {ARCHS}); the other "
            "model families are a later slice, see ROADMAP.md"
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


__all__ = ["ArchConfig", "get_config", "smoke_variant"]
