"""AdamW with dtype-configurable moments (port of `repro.optim.adamw`).

The reference's formulas in its operation order (f32 moment math, bias
corrections ``1 - b ** count`` in f32, ``sqrt(v_hat) + eps``, decoupled
weight decay inside the step).  `torch.optim.AdamW` is not used: it places
eps and applies the bias corrections differently, which rounds differently.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .common import Optimizer, _lr_at


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype: torch.dtype | None = None,
):
    def init(params):
        dt = lambda p: moment_dtype or p.dtype
        leaf = tree_leaves(params)[0]
        return {
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=dt(p)), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt(p)), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = _lr_at(lr, c)
        cf = c.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=cf.device), cf)

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            mh = m32 / bc1
            vh = v32 / bc2
            u = -lr_t * (mh / (torch.sqrt(vh) + eps)
                         + weight_decay * p.float())
            return u, m32.to(m.dtype), v32.to(v.dtype)

        out = [upd(*a) for a in zip(tree_leaves(grads), tree_leaves(state["m"]),
                                    tree_leaves(state["v"]),
                                    tree_leaves(params))]
        updates = tree_unflatten(grads, [o[0] for o in out])
        m = tree_unflatten(grads, [o[1] for o in out])
        v = tree_unflatten(grads, [o[2] for o in out])
        return updates, {"m": m, "v": v, "count": c}

    return Optimizer(init=init, update=update)
