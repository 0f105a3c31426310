"""Hand the JAX reference's arrays to the port, through numpy.

The reference's params come as a nested dict of numpy arrays (the caller
does ``jax.tree.map(np.asarray, params)``; this module imports no jax).
`params_from_reference` turns that tree into the port's layout: the same
dict, with each stacked layer axis (``layers``; Zamba2's ``mamba``) split
into a list of per-layer dicts and every other key carried as it is;
`train_state_from_reference` does the same for a whole AdamW train state
(params, the moments m and v, the step counts and the error-feedback
buffer), so both packages can start training from one state.

Dtypes that torch and numpy do not share travel by bit pattern:
bfloat16 (ml_dtypes) -> uint16 -> int16 -> ``view(torch.bfloat16)``, and
uint32 spike words -> int32 with the same bits (`words_to_torch`,
`words_to_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy array -> a torch tensor with the same values (bf16 and
    uint32 by bit pattern)."""
    a = np.array(a, copy=True, order="C")  # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def words_to_torch(words, device="cpu") -> torch.Tensor:
    """Reference uint32 spike words -> the port's int32 words (same bits)."""
    return to_torch(np.asarray(words, np.uint32), device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 spike words -> uint32 words (same bits)."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# the keys under which a family stacks its layers on a leading axis: the
# transformers' and RWKV6's ``layers``, Zamba2's ``mamba`` (its ``shared``
# block is one unstacked dict)
STACKED_KEYS = ("layers", "mamba")


def params_from_reference(tree: dict, *, device="cpu") -> dict:
    """Reference param tree (numpy leaves, layers stacked on axis 0 under
    `STACKED_KEYS`) -> the port's param tree (torch leaves on ``device``,
    a per-layer list under each of those keys)."""
    out = {k: _map(v, lambda a: to_torch(a, device))
           for k, v in tree.items() if k not in STACKED_KEYS}
    for key in STACKED_KEYS:
        if key not in tree:
            continue
        stacked = tree[key]
        n_layers = {np.shape(a)[0] for a in _leaves(stacked)}
        if len(n_layers) != 1:
            raise ValueError(f"{key} leaves disagree on depth: {n_layers}")
        out[key] = [
            _map(stacked, lambda a, i=i: to_torch(np.asarray(a)[i], device))
            for i in range(n_layers.pop())
        ]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def train_state_from_reference(state: dict, *, device="cpu") -> dict:
    """Reference train state (numpy leaves: ``params``, ``opt`` = AdamW's
    ``m``/``v``/``count``, ``step``, optional ``ef_err``) -> the port's.
    AdamW's moments mirror the params, so they split by layer as the params
    do.  (Adafactor's factored moments of stacked leaves have no per-layer
    counterpart and are not bridged.)"""
    opt = state["opt"]
    if set(opt) != {"m", "v", "count"}:
        raise ValueError(f"only AdamW states are bridged, got {sorted(opt)}")
    out = {
        "params": params_from_reference(state["params"], device=device),
        "opt": {"m": params_from_reference(opt["m"], device=device),
                "v": params_from_reference(opt["v"], device=device),
                "count": to_torch(opt["count"], device)},
        "step": to_torch(state["step"], device),
    }
    if "ef_err" in state:
        out["ef_err"] = params_from_reference(state["ef_err"], device=device)
    return out
