"""Int8 gradient compression with error feedback (port of
`repro.optim.compress`): gradients quantised to int8 with a per-tensor scale
before they would cross a data-parallel all-reduce; the quantisation error
is carried to the next step.  `compressed_psum` is the reference's
shard_map building block over a mesh axis of logical devices.

The scale is per leaf: over each layer's tensor here, over the stacked (L,
...) tensor in the reference, so on a model's params the two quantise
differently; on the same tree they are the same computation."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class ErrorFeedbackInt8:
    def init(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def compress(self, grads, err):
        """Returns (dequantised grads to feed the optimizer, new error state,
        payload tree of (int8 tensor, f32 scale))."""
        def one(g, e):
            g32 = g.float() + e
            scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            g_hat = q.float() * scale
            return g_hat, g32 - g_hat, (q, scale)

        out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(grads, [o[1] for o in out]),
                tree_unflatten(grads, [o[2] for o in out]))


def compressed_psum(gs: list) -> list:
    """The int8-compressed mean over one mesh axis of logical devices
    (`launch.mesh`): ``gs`` holds one tensor per device of the axis, in axis
    order, each on its device.  As the reference: the max of |g| across
    the axis (its pmax) sets one shared scale, each device quantises its
    tensor to int8, the int8 payloads add as int32 in axis order on the
    axis's first device (what would cross the wire is 1 byte an element
    instead of 4), and the sum times the scale over the axis size is the
    mean.  Returns the mean once per device, on that device."""
    lead = gs[0].device
    gmax = torch.stack([torch.max(torch.abs(g)).to(lead) for g in gs]).max()
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    acc = None
    for g in gs:
        q = torch.clamp(torch.round(g / scale.to(g.device)), -127, 127).to(torch.int8)
        q = q.to(lead, torch.int32)
        acc = q if acc is None else acc + q
    mean = acc.float() * scale / len(gs)
    return [mean.to(g.device) for g in gs]
