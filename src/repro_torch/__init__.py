"""PyTorch/CUDA port of the LoAS reproduction (`repro` is the JAX reference).

The sub-packages mirror `repro`'s layout (`configs`, `core`, `kernels`,
`models`, `serve`, `train`, `optim`, `data`, `ckpt`, `ft`, `launch`) so each
counterpart is found by name.  This
package imports torch and numpy only; every TPU kernel it needs has a
hand-written Hopper kernel under `kernels/csrc/`, and everything around the
kernels is plain torch.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU each kernel wrapper runs the
kernel's plain torch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  Without a card and without an explicit device, raise instead of
    silently running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the CPU"
        )
    return torch.device("cuda")
