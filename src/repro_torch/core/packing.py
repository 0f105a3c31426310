"""FTP-friendly spike compression: packing spikes along the temporal axis
(port of `repro.core.packing`).

Spike tensors carry time as the leading axis, ``spikes[t, ...]``; a packed
word places timestep ``t`` at bit ``t`` (LSB = t0).

Packed words travel as ``torch.int32`` with the same bits as the
reference's ``uint32`` words: torch implements neither shifts nor
comparisons for ``uint32`` on the CPU.  ``(w >> t) & 1`` is the bit at
``t`` for every t in 0..31 on int32 (the arithmetic shift only changes bits
above the one kept).  Convert to and from the reference with
``ndarray.view(np.int32)`` / ``.view(np.uint32)``.
"""
from __future__ import annotations

import torch

MAX_T = 32  # packed words are 32 bits


def pack_spikes(spikes: torch.Tensor) -> torch.Tensor:
    """Pack a (T, ...) boolean/{0,1} spike tensor into (...) int32 words;
    bit ``t`` of the output word equals ``spikes[t]``.

    The sum runs in int64 (no overflow at bit 31) and is folded back into
    int32 two's complement, so a word with bit 31 set is negative."""
    T = spikes.shape[0]
    if T > MAX_T:
        raise ValueError(f"T={T} exceeds MAX_T={MAX_T}")
    bits = (spikes != 0).to(torch.int64)
    weights = (1 << torch.arange(T, dtype=torch.int64, device=spikes.device))
    words = (bits * weights.reshape((T,) + (1,) * (spikes.ndim - 1))).sum(0)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_spikes(
    packed: torch.Tensor, T: int, dtype=torch.float32
) -> torch.Tensor:
    """Unpack (...) int32 words into a (T, ...) spike tensor of ``dtype``."""
    if T > MAX_T:
        raise ValueError(f"T={T} exceeds MAX_T={MAX_T}")
    shifts = torch.arange(T, dtype=torch.int32, device=packed.device).reshape(
        (T,) + (1,) * packed.ndim)
    return ((packed[None] >> shifts) & 1).to(dtype)


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Number of timesteps at which each neuron fires (int32)."""
    return unpack_spikes(packed, MAX_T, torch.int32).sum(0, dtype=torch.int32)


def mask_low_activity(packed: torch.Tensor, min_spikes: int = 2) -> torch.Tensor:
    """Silent-neuron preprocessing (paper §V): zero out presynaptic neurons
    that fire fewer than ``min_spikes`` times across all timesteps."""
    keep = popcount(packed) >= min_spikes
    return torch.where(keep, packed, torch.zeros_like(packed))


def block_activity_map(packed: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(M, K) packed words -> (M//bm, K//bk) bool, True where the block has
    at least one non-silent neuron."""
    M, K = packed.shape
    if M % bm or K % bk:
        raise ValueError(f"shape {(M, K)} not divisible by block {(bm, bk)}")
    blocks = packed.reshape(M // bm, bm, K // bk, bk)
    return (blocks != 0).any(dim=3).any(dim=1)


# ---------------------------------------------------------------------------
# Timestep (bit-plane) activity: the temporal third of the join.  A plane
# whose bit is clear in every word contributes exactly zero to every sum,
# so skipping its work is bitwise (the LIF still walks all T).  Scoring is
# popcount arithmetic over the words already on the device.
# ---------------------------------------------------------------------------

def timestep_popcount(packed: torch.Tensor, T: int) -> torch.Tensor:
    """Per-timestep spike totals of a packed tensor: (...) int32 words ->
    (T,) int32, entry t = number of words with bit t set."""
    if T > MAX_T:
        raise ValueError(f"T={T} exceeds MAX_T={MAX_T}")
    return unpack_spikes(packed, T, torch.int32).reshape(T, -1).sum(
        1, dtype=torch.int32)


def timestep_activity_map(
    packed: torch.Tensor, T: int, min_spikes: int = 1
) -> torch.Tensor:
    """(...) packed words -> (T,) bool, True where timestep plane t carries
    at least ``min_spikes`` spikes in total.  ``min_spikes=1`` marks exactly
    the all-silent planes inactive (skipping them is bitwise); larger
    thresholds also drop near-silent planes (approximate)."""
    return timestep_popcount(packed, T) >= min_spikes


def mask_low_activity_timesteps(
    packed: torch.Tensor, T: int, min_spikes: int = 1
) -> torch.Tensor:
    """Clear the bits of every timestep plane scoring below ``min_spikes``;
    bits at t >= T are preserved untouched.  Identity for ``min_spikes=1``
    and idempotent.  Computed on the words' device, with no host copy."""
    keep = timestep_activity_map(packed, T, min_spikes).to(torch.int64)
    planes = torch.arange(T, dtype=torch.int64, device=packed.device)
    live = (keep << planes).sum()
    above_t = 0xFFFFFFFF & ~((1 << T) - 1)
    bits = live | above_t                     # 0 .. 2**32 - 1
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return packed & bits
