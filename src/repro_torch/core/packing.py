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

import numpy as np
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


def silent_fraction(packed: torch.Tensor) -> torch.Tensor:
    """Fraction of silent neurons (packed word == 0): paper Table II
    'AvSpA packed'."""
    return (packed == 0).to(torch.float32).mean()


def spike_sparsity(spikes: torch.Tensor) -> torch.Tensor:
    """Per-timestep spike sparsity: paper Table II 'AvSpA origin'."""
    return (spikes == 0).to(torch.float32).mean()


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Number of timesteps at which each neuron fires (int32)."""
    return unpack_spikes(packed, MAX_T, torch.int32).sum(0, dtype=torch.int32)


def mask_low_activity(packed: torch.Tensor, min_spikes: int = 2) -> torch.Tensor:
    """Silent-neuron preprocessing (paper §V): zero out presynaptic neurons
    that fire fewer than ``min_spikes`` times across all timesteps."""
    keep = popcount(packed) >= min_spikes
    return torch.where(keep, packed, torch.zeros_like(packed))


def mask_low_activity_spikes(
    spikes: torch.Tensor, min_spikes: int = 2
) -> torch.Tensor:
    """The same preprocessing on an unpacked (T, ...) spike tensor, for
    fine-tuning: the mask comes from the spike counts and multiplies the
    spikes, so gradients flow through the surviving ones."""
    count = spikes.sum(0, keepdim=True)
    return spikes * (count >= min_spikes).to(spikes.dtype)


def block_activity_map(packed: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(M, K) packed words -> (M//bm, K//bk) bool, True where the block has
    at least one non-silent neuron."""
    M, K = packed.shape
    if M % bm or K % bk:
        raise ValueError(f"shape {(M, K)} not divisible by block {(bm, bk)}")
    blocks = packed.reshape(M // bm, bm, K // bk, bk)
    return (blocks != 0).any(dim=3).any(dim=1)


def block_nonzero_map(w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(K, N) weights -> (K//bk, N//bn) bool, True where the block holds a
    non-zero weight (the block view of the paper's column fibers)."""
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"shape {(K, N)} not divisible by block {(bk, bn)}")
    blocks = w.reshape(K // bk, bk, N // bn, bn)
    return (blocks != 0).any(dim=3).any(dim=1)


def compression_efficiency(spikes) -> dict:
    """The paper's compression-efficiency metric (§IV-A) for a (T, M, K)
    spike array (numpy, or a tensor moved to numpy): spike bits conveyed
    per coordinate-overhead bit of each format.

      * csr:  ceil(log2(K)) coordinate bits per non-zero spike, per
              timestep;
      * loas: one K-bit bitmask per row, shared by all T timesteps.

    Paper example: CSR spends 2 x 4 coordinate bits on 2 spikes (25 %);
    LoAS a 4-bit row bitmask on 5 spikes (125 %)."""
    if isinstance(spikes, torch.Tensor):
        spikes = spikes.detach().cpu().numpy()
    T, M, K = spikes.shape
    nnz_spikes = int(spikes.sum())
    packed = np.zeros((M, K), dtype=np.uint32)
    for t in range(T):
        packed |= (spikes[t].astype(np.uint32) & 1) << t
    nonsilent = int((packed != 0).sum())
    coord_bits = max(1, int(np.ceil(np.log2(K))))
    csr_overhead = nnz_spikes * coord_bits
    loas_overhead = M * K  # one bitmask bit per (row, position)
    return {
        "spike_bits": nnz_spikes,
        "csr_overhead_bits": csr_overhead,
        "loas_overhead_bits": loas_overhead,
        "loas_payload_bits": nonsilent * T,
        "csr_efficiency": nnz_spikes / max(csr_overhead, 1),
        "loas_efficiency": nnz_spikes / max(loas_overhead, 1),
        "silent_fraction": 1.0 - nonsilent / (M * K),
    }


# ---------------------------------------------------------------------------
# Event windows: the sensor-side producer of packed words.  One fixed-duration
# window of (x, y, polarity, t_us) events becomes one (H*W,) packed word
# vector, T timestep planes binned uniformly over the window; an empty window
# encodes to all-zero words, which the adaptive temporal axis skips.
# ---------------------------------------------------------------------------

def encode_event_window(
    events,
    height: int,
    width: int,
    T: int,
    window_us: int,
    t0: int = 0,
) -> torch.Tensor:
    """Encode one window of sensor events into packed spike words.

    ``events`` is an (N, 4) int array or tensor of ``(x, y, polarity,
    t_us)`` rows (N may be 0).  Events with ``t_us`` in ``[t0, t0 +
    window_us)`` bin into T uniform planes, ``tau = (t_us - t0) * T //
    window_us``; a pixel fires at plane tau if ANY event (either polarity)
    lands in that bin.  Events outside the window or the sensor are
    ignored.  Returns ``(height * width,)`` int32 words in row-major pixel
    order (``y * width + x``), bit t = plane t, on the events' device."""
    if T > MAX_T:
        raise ValueError(f"T={T} exceeds MAX_T={MAX_T}")
    if T <= 0 or height <= 0 or width <= 0:
        raise ValueError(
            f"height/width/T must be positive, got {(height, width, T)}"
        )
    if window_us <= 0:
        raise ValueError(f"window_us must be positive, got {window_us}")
    ev = torch.as_tensor(events, dtype=torch.int64).reshape(-1, 4)
    x, y, t = ev[:, 0], ev[:, 1], ev[:, 3]
    rel = t - int(t0)
    valid = ((rel >= 0) & (rel < window_us) & (x >= 0) & (x < width)
             & (y >= 0) & (y < height))
    # clip AFTER masking: an out-of-range row scatters a 0 into a safe slot,
    # and the max keeps every 1 another row put there
    tau = torch.clamp(rel * T // window_us, 0, T - 1)
    idx = torch.clamp(y * width + x, 0, height * width - 1)
    plane = torch.zeros((T * height * width,), dtype=torch.int64,
                        device=ev.device)
    plane.scatter_reduce_(0, tau * (height * width) + idx,
                          valid.to(torch.int64), reduce="amax")
    return pack_spikes(plane.reshape(T, height * width))


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
