"""Leaky-Integrate-and-Fire dynamics (port of `repro.core.lif`).

Hard reset, as the paper fixes it:

    X[t] = O[t] + U[t-1]
    C[t] = 1 if X[t] > v_th else 0
    U[t] = tau * X[t] * (1 - C[t])

The recurrence runs in the dtype of its input, op by op in the reference's
order: the serving FFN direct-encodes bf16 activations, and the reference
rounds every step of that recurrence to bf16, so an f32 recurrence would
fire differently near the threshold.
"""
from __future__ import annotations

import math

import torch

from .packing import pack_spikes

DEFAULT_VTH = 1.0
DEFAULT_TAU = 0.5
SURROGATE_ALPHA = 2.0


class _SpikeFn(torch.autograd.Function):
    """Heaviside step 1[x > 0] with the ATan surrogate derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = math.pi / 2 * SURROGATE_ALPHA
        return g * SURROGATE_ALPHA / (2.0 * (1.0 + (s * x) ** 2))


def spike_fn(x: torch.Tensor) -> torch.Tensor:
    return _SpikeFn.apply(x)


def lif_forward(
    o: torch.Tensor,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
):
    """Run the LIF recurrence over a (T, ...) input-current tensor.

    Returns (spikes (T, ...), final membrane potential (...)); differentiable
    through the surrogate gradient."""
    u = torch.zeros_like(o[0])
    spikes = []
    for t in range(o.shape[0]):
        x = o[t] + u
        c = spike_fn(x - v_th)
        u = tau * x * (1.0 - c)
        spikes.append(c)
    return torch.stack(spikes), u


def plif_packed(
    o: torch.Tensor,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
):
    """The P-LIF unit (paper Fig. 7): full sums for all T in, packed spike
    words out.  o: (T, ...) full sums.  Returns (packed int32 words (...),
    final potential (...)); inference only (no gradient through packing)."""
    spikes, u = lif_forward(o, v_th=v_th, tau=tau)
    return pack_spikes(spikes), u


def direct_encode(
    x: torch.Tensor,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
) -> torch.Tensor:
    """Direct encoding: the analog input is a constant current for T
    timesteps through a LIF layer.  Returns (T, ...) spikes."""
    o = x[None].expand((T,) + tuple(x.shape))
    spikes, _ = lif_forward(o, v_th=v_th, tau=tau)
    return spikes


def rate_decode(spikes: torch.Tensor) -> torch.Tensor:
    """Decode a (T, ...) spike train to an analog value: firing rate."""
    return spikes.mean(0)
