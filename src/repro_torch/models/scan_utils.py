"""Sequential scans of the recurrent layers (port of
`repro.models.scan_utils`).

The reference scans a step function over S steps with `jax.lax.scan` and,
for training, remats the scan per chunk of ``chunk`` steps: memory
O(S/chunk x state + chunk x step) instead of a residual per step.  Here the
scan is a Python loop over steps; under autograd each chunk runs in
`torch.utils.checkpoint`, so its steps are recomputed in the backward.
Without autograd there is nothing to checkpoint and the loop runs plain.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _scan(step_fn, state, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        state, y = step_fn(state, tuple(a[t] for a in xs))
        ys.append(y)
    return state, torch.stack(ys)


def chunked_seq_scan(step_fn, state, xs: tuple, chunk: int, remat: bool = True):
    """``scan(step_fn, state, xs)`` over the leading (S) dim of the tensors
    ``xs``: ``step_fn(state, per-step slices) -> (state, y)``.  Returns
    (final state, ys stacked on a leading S dim).  The reference's branch
    rule: no chunking when ``chunk`` is 0, ``S <= chunk`` or ``chunk`` does
    not divide S; otherwise each chunk is checkpointed when ``remat`` and
    autograd is recording."""
    S = xs[0].shape[0]
    if (not chunk or S <= chunk or S % chunk
            or not (remat and torch.is_grad_enabled())):
        return _scan(step_fn, state, xs)
    ys = []
    for c in range(0, S, chunk):
        state, y = checkpoint(_scan, step_fn, state,
                              tuple(a[c:c + chunk] for a in xs),
                              use_reentrant=False)
        ys.append(y)
    return state, torch.cat(ys)


def token_shift(x: torch.Tensor, prev: torch.Tensor):
    """RWKV token shift: the x_{t-1} stream.  x (B, S, D); prev (B, D), the
    previous segment's last row (zeros at a sequence start).  Returns
    (shifted (B, S, D), new prev (B, D))."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return shifted, x[:, -1, :]
