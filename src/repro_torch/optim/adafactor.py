"""Adafactor (Shazeer & Stern 2018), factored second moments (port of
`repro.optim.adafactor`, same formulas and operation order).

Factoring applies to the trailing two dims of every leaf with two or more.
The port keeps one leaf per layer where the reference stacks its layers on a
leading axis, so on a model's params the two differ: the reference factors a
stacked (L, D) norm scale and takes the update-clipping RMS over all L
layers at once, the port treats each layer's (D,) vector unfactored and
clips per layer.  On the same tree the two are the same computation.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .common import Optimizer, _lr_at

EPS1 = 1e-30
CLIP = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(lr, decay: float = 0.8):
    def init(params):
        def st(p):
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device),
                }
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}

        leaf = tree_leaves(params)[0]
        return {"v": tree_map(st, params),
                "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = _lr_at(lr, c)
        beta = 1.0 - c.float() ** -decay

        def upd(g, s):
            g32 = g.float()
            g2 = g32 * g32 + EPS1
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / (torch.mean(vr, dim=-1, keepdim=True)[..., None] + EPS1)
                    + EPS1
                )
                u = g32 / denom
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 / torch.sqrt(v + EPS1)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + EPS1)
            u = u / torch.clamp(rms / CLIP, min=1.0)
            return -lr_t * u, ns

        flat_g = tree_leaves(grads)
        # one state dict per grad leaf, in the grads' walk order
        flat_s = _state_leaves(grads, state["v"])
        outs = [upd(g, s) for g, s in zip(flat_g, flat_s)]
        updates = tree_unflatten(grads, [o[0] for o in outs])
        new_v = tree_unflatten(grads, [o[1] for o in outs])
        return updates, {"v": new_v, "count": c}

    return Optimizer(init=init, update=update)


def _state_leaves(grads, v):
    """The per-leaf state dicts of ``v`` in the walk order of ``grads``
    (``v`` mirrors ``grads`` with a dict where grads has a tensor)."""
    if isinstance(grads, dict):
        return [s for k in sorted(grads) for s in _state_leaves(grads[k], v[k])]
    if isinstance(grads, (list, tuple)):
        return [s for g, sv in zip(grads, v) for s in _state_leaves(g, sv)]
    return [v]
