"""Bitmask fiber compression (paper §IV-A and Fig. 8); port of
`repro.core.fibers`.

A *fiber* is one compressed row of the packed spike matrix A (or one
compressed column of the weight matrix B):

    [ bitmask | pointer | payload... ]

* bitmask — 1 bit per position; 1 marks a non-silent neuron (A) or a non-zero
  weight (B).
* pointer — start of the payload in the value store (NULL if the cache line
  holds the whole payload; we model it as an integer offset).
* payload — the packed T-bit spike words (A) or the non-zero weights (B), in
  position order.

This module is the *format* ground truth: the cycle-level simulator charges
memory traffic in units of these structures, and tests round-trip them
against dense tensors.  It is a host-side numpy model (ragged data gains
nothing from the device); the compute path uses the dense packed words plus
block maps instead.  A torch tensor given to it is moved to numpy first;
the port's int32 spike words keep their bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A numpy array of ``a`` (a torch tensor is moved to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class FiberSet:
    """A compressed matrix: one fiber per row (axis 0)."""

    bitmask: np.ndarray   # (R, L) bool — L = fiber length
    pointers: np.ndarray  # (R,) int64 — offset of each fiber's payload
    payload: np.ndarray   # (total_nnz,) — packed words (uint32) or weights
    shape: tuple          # dense shape (R, L)

    @property
    def nnz(self) -> int:
        return int(self.payload.shape[0])

    def bitmask_bits(self) -> int:
        return int(np.prod(self.bitmask.shape))

    def pointer_bits(self, ptr_bits: int = 32) -> int:
        return self.pointers.shape[0] * ptr_bits

    def payload_bits(self, elem_bits: int) -> int:
        return self.nnz * elem_bits


def compress_rows(dense: np.ndarray) -> FiberSet:
    """Compress a dense 2-D array row-wise: non-zero entries become payload.

    For the spike matrix A, ``dense`` is the (M, K) packed-word matrix and a
    zero word is a silent neuron.  For B (compressed column-wise in the
    paper), pass ``B.T`` and transpose back on decompression.
    """
    dense = _host(dense)
    if dense.ndim != 2:
        raise ValueError("fibers compress 2-D matrices")
    bitmask = dense != 0
    counts = bitmask.sum(axis=1)
    pointers = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    payload = dense[bitmask]
    return FiberSet(bitmask=bitmask, pointers=pointers, payload=payload,
                    shape=dense.shape)


def decompress_rows(fs: FiberSet) -> np.ndarray:
    out = np.zeros(fs.shape, dtype=fs.payload.dtype)
    out[fs.bitmask] = fs.payload
    return out


def compress_cols(dense: np.ndarray) -> FiberSet:
    """Column-wise compression (paper's layout for the weight matrix B)."""
    return compress_rows(np.ascontiguousarray(_host(dense).T))


def decompress_cols(fs: FiberSet) -> np.ndarray:
    return np.ascontiguousarray(decompress_rows(fs).T)


def fiber_traffic_bytes(
    fs: FiberSet, elem_bits: int, ptr_bits: int = 32
) -> dict:
    """Storage/traffic footprint of a fiber set, in bytes, split by component.

    Used by the simulator's DRAM/SRAM accounting and by the benchmark that
    reproduces the paper's Fig. 14 'compressed format' traffic bars.
    """
    bm = fs.bitmask_bits()
    pt = fs.pointer_bits(ptr_bits)
    pl = fs.payload_bits(elem_bits)
    return {
        "bitmask_bytes": bm / 8.0,
        "pointer_bytes": pt / 8.0,
        "payload_bytes": pl / 8.0,
        "total_bytes": (bm + pt + pl) / 8.0,
    }


def csr_traffic_bytes(dense_per_t: np.ndarray, coord_bits: int | None = None,
                      elem_bits: int = 1) -> dict:
    """Traffic of the conventional CSR-per-timestep format the paper argues
    against (GoSPA-SNN stores one coordinate per spike per timestep).

    dense_per_t: (T, M, K) spikes or a (K, N) weight matrix as (1, K, N).
    """
    dense_per_t = _host(dense_per_t)
    T = dense_per_t.shape[0]
    L = dense_per_t.shape[-1]
    if coord_bits is None:
        coord_bits = max(1, int(np.ceil(np.log2(L))))
    nnz = int((dense_per_t != 0).sum())
    rows = int(np.prod(dense_per_t.shape[:-1]))
    coord = nnz * coord_bits
    rowptr = rows * 32
    payload = nnz * elem_bits
    return {
        "coord_bytes": coord / 8.0,
        "rowptr_bytes": rowptr / 8.0,
        "payload_bytes": payload / 8.0,
        "total_bytes": (coord + rowptr + payload) / 8.0,
    }
