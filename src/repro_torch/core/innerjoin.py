"""Functional + cycle-accurate model of the FTP-friendly inner-join unit
(paper §IV-C, Figs. 9 & 10); port of `repro.core.innerjoin`.

The circuit computes, for one output neuron (one row-fiber of A joined with
one column-fiber of B), the T per-timestep accumulations:

    O[t] = sum_{k : bmA[k] & bmB[k]} bit_t(packA[k]) * B[k]

Mechanism being modeled:
  * bitmask AND -> matched positions;
  * FAST prefix-sum (1 offset/cycle) walks B's offsets: every matched weight
    is *optimistically* accumulated into the PSEUDO-accumulator, presuming the
    presynaptic neuron fired at ALL timesteps;
  * LAGGY prefix-sum (n_adders in parallel over the 128-bit mask ->
    len(bm)/n_adders cycles) produces A's offsets later;
  * once laggy offsets are ready, buffered (position, weight) pairs from the
    FIFOs are checked against the packed word: for each timestep with a 0 bit,
    the weight is added to that timestep's CORRECTION accumulator;
  * final: O[t] = pseudo - correction[t].

On the GPU the trick is subsumed by the exact bit-plane pass of the FTP
kernels; this host-side numpy model exists to (a) prove functional
equivalence, (b) give the cycle/energy simulator the TPPE timing it needs,
and (c) reproduce the Fig. 10 walk-through in tests.  Packed words may be
the port's int32 words: bit 31 reads as in the reference's uint32 words.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _words(pack_a) -> np.ndarray:
    """Packed spike words as uint32 (int32 words keep their bits)."""
    pack_a = np.asarray(pack_a)
    if pack_a.dtype == np.int32:
        return pack_a.view(np.uint32)
    return pack_a.astype(np.uint32, copy=False)


@dataclass
class InnerJoinConfig:
    """TPPE inner-join parameters (paper Table III / §V)."""

    fiber_len: int = 128        # bitmask length processed per join
    n_adders: int = 16          # adders in the laggy prefix-sum
    fifo_depth: int = 8         # FIFO-mp / FIFO-B depth
    T: int = 4

    @property
    def laggy_cycles(self) -> int:
        # 128-bit mask / 16 adders = 8 cycles in the paper's config.
        return self.fiber_len // self.n_adders


@dataclass
class InnerJoinResult:
    out: np.ndarray             # (T,) accumulations for this output neuron
    cycles: int                 # TPPE cycles to drain this join
    matched: int                # matched (non-silent x non-zero) positions
    pseudo_accum_adds: int      # adds on the pseudo accumulator
    correction_adds: int        # adds across correction accumulators
    fifo_stall_cycles: int      # stalls because FIFO filled before laggy ready


def inner_join(
    bm_a: np.ndarray,
    pack_a: np.ndarray,
    bm_b: np.ndarray,
    vals_b: np.ndarray,
    cfg: InnerJoinConfig,
) -> InnerJoinResult:
    """Simulate one fiber-pair join.

    bm_a:    (L,) bool bitmask of non-silent A positions.
    pack_a:  (nnzA,) uint32 packed spike words, in position order.
    bm_b:    (L,) bool bitmask of non-zero B positions.
    vals_b:  (nnzB,) weights, in position order.
    """
    L = cfg.fiber_len
    assert bm_a.shape == (L,) and bm_b.shape == (L,)
    pack_a = _words(pack_a)
    matched_mask = bm_a & bm_b
    matched_pos = np.nonzero(matched_mask)[0]
    # Offsets = prefix sums (number of 1s before the position).
    off_a = np.cumsum(bm_a) - bm_a.astype(np.int64)   # fast circuit's job in
    off_b = np.cumsum(bm_b) - bm_b.astype(np.int64)   # SparTen; here B=fast

    T = cfg.T
    pseudo = 0.0
    corrections = np.zeros(T, dtype=np.float64)
    pseudo_adds = 0
    corr_adds = 0

    # --- timing model -----------------------------------------------------
    # Fast prefix-sum: 1 matched offset per cycle, starting cycle 1.
    # Laggy prefix-sum: all A offsets ready at cycle `laggy_cycles`.
    # Correction check: 1 buffered pair per cycle after laggy ready.
    # FIFO of depth D absorbs the head start; if more than D pairs are
    # produced before laggy readiness, the fast path stalls.
    n_match = len(matched_pos)
    laggy_ready = cfg.laggy_cycles
    produced_before_ready = min(n_match, laggy_ready)
    stalls = max(0, produced_before_ready - cfg.fifo_depth)

    for pos in matched_pos:
        w = float(vals_b[off_b[pos]])
        pseudo += w          # optimistic: fired at all T timesteps
        pseudo_adds += 1
        word = int(pack_a[off_a[pos]])
        for t in range(T):
            if not (word >> t) & 1:
                corrections[t] += w
                corr_adds += 1

    out = pseudo - corrections

    # Drain time: fast path finishes at n_match (+stalls); corrections finish
    # one-per-cycle after laggy_ready; the unit is done when both drain.
    fast_done = n_match + stalls
    corr_done = laggy_ready + n_match
    cycles = max(fast_done, corr_done, laggy_ready)

    return InnerJoinResult(
        out=out,
        cycles=int(cycles),
        matched=n_match,
        pseudo_accum_adds=pseudo_adds,
        correction_adds=corr_adds,
        fifo_stall_cycles=int(stalls),
    )


def inner_join_reference(
    bm_a: np.ndarray,
    pack_a: np.ndarray,
    bm_b: np.ndarray,
    vals_b: np.ndarray,
    T: int,
) -> np.ndarray:
    """Direct dense reference: O[t] = sum_k bit_t(A[k]) * B[k]."""
    L = bm_a.shape[0]
    dense_a = np.zeros(L, dtype=np.uint32)
    dense_a[np.nonzero(bm_a)[0]] = _words(pack_a)
    dense_b = np.zeros(L, dtype=np.float64)
    dense_b[np.nonzero(bm_b)[0]] = vals_b
    out = np.zeros(T)
    for t in range(T):
        bits = (dense_a >> t) & 1
        out[t] = float(np.dot(bits.astype(np.float64), dense_b))
    return out


def sparten_join_cycles(bm_a_t: np.ndarray, bm_b: np.ndarray) -> int:
    """Cycle cost of ONE timestep of a SparTen-style join (two fast prefix
    sums, 1 matched pair consumed per cycle) — used by the SparTen-SNN
    baseline model, which must re-run the join once per timestep."""
    return int(np.count_nonzero(bm_a_t & bm_b))
