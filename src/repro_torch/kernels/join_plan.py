"""Load-time weight join plans for the dual-sparse FTP serving path (port
of `repro.kernels.join_plan`).

The weight side of the block-level inner join is a property of the pruned
model and never changes after load: `build_weight_plan` compresses a (K, N)
weight matrix once into a `WeightJoinPlan` (block-CSR payload plus
per-output-column join lists).  The spike side (which (m, k) spike blocks
are active) is computed per call on the device by `kernels.ops`.

The join-list logic is host numpy, identical to the reference, so
``payload/kidx/vidx/cnt/bmap`` equal the reference plan for the same
weights.  Only the payload gather runs in torch, on the weights' own device
and in their own dtype (numpy has no bfloat16).  Plans of a layer stack are
kept as a per-layer list: the port walks its layers in a Python loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .ftp_spmm import _COLS

# Default weight block (the reference's MXU-sized 128x128).
BK, BN = 128, 128


def pick_plan_blocks(K: int, N: int, bk: int = BK, bn: int = BN) -> tuple[int, int]:
    """Shrink default weight blocks for small problems (reference rule)."""
    return min(bk, max(8, K)), min(bn, max(128, N) if N >= 128 else N)


@dataclass(frozen=True)
class WeightJoinPlan:
    """Static weight-side half of the block-level inner join.

    payload: (nnzb, bk, bn)  gathered non-zero weight blocks, k-major order
             (all-zero weights keep one dummy zero block).
    kidx:    (nnb, jmax) int32 — k-block index of join slot jj of output
             column block j (tail slots 0-filled, masked by ``cnt``).
    vidx:    (nnb, jmax) int32 — payload index of the same join slot.
    cnt:     (nnb,) int32 — live join slots per column block.
    bmap:    (nkb, nnb) bool — per-(k, n)-block non-zero mask.
    """

    payload: torch.Tensor
    kidx: torch.Tensor
    vidx: torch.Tensor
    cnt: torch.Tensor
    bmap: torch.Tensor

    @property
    def bk(self) -> int:
        return self.payload.shape[-2]

    @property
    def bn(self) -> int:
        return self.payload.shape[-1]

    @property
    def jmax(self) -> int:
        return self.kidx.shape[-1]

    @property
    def nkb(self) -> int:
        return self.bmap.shape[-2]

    @property
    def nnb(self) -> int:
        return self.bmap.shape[-1]

    @property
    def k_padded(self) -> int:
        return self.nkb * self.bk

    @property
    def n_padded(self) -> int:
        return self.nnb * self.bn


def build_block_csr(b: torch.Tensor, bk: int, bn: int):
    """Compress (K, N) weights into block-CSR: gathered non-zero (bk, bn)
    blocks (on ``b``'s device) + a host (nkb, nnb) -> payload-index map (-1
    for zero blocks) + the host non-zero mask."""
    K, N = b.shape
    assert K % bk == 0 and N % bn == 0
    nkb, nnb = K // bk, N // bn
    blocks = b.reshape(nkb, bk, nnb, bn).permute(0, 2, 1, 3)
    nz_dev = (blocks != 0).any(dim=3).any(dim=2)  # (nkb, nnb)
    nz = nz_dev.cpu().numpy()
    payload = blocks[nz_dev].contiguous()  # (nnzb, bk, bn), k-major
    if payload.shape[0] == 0:  # fully-zero weights: keep one dummy block
        payload = torch.zeros((1, bk, bn), dtype=b.dtype, device=b.device)
    idx = -np.ones((nkb, nnb), dtype=np.int32)
    idx[nz] = np.arange(int(nz.sum()), dtype=np.int32)
    return payload, idx, nz


def build_weight_plan(
    w: torch.Tensor, *, bk: int | None = None, bn: int | None = None
) -> WeightJoinPlan:
    """Build the load-time join plan for one (K, N) weight matrix.

    Pads K/N up to block multiples, compresses to block-CSR, and derives the
    per-column-block join lists with vectorized numpy.  The plan lives on
    ``w``'s device; the payload keeps ``w``'s dtype.

    Blocks the caller does not give follow the reference's rule
    (`pick_plan_blocks`), except on the card, where a column block that is
    not a multiple of the BSR kernels' 32-column tile (N < 128 and not a
    multiple of 32, as in the Table II fc layers) widens to the next
    multiple: the padding columns are zero and add +0, and callers cut
    the output back to N."""
    K, N = w.shape
    if bk is None or bn is None:
        pbk, pbn = pick_plan_blocks(K, N)
        if w.is_cuda:
            pbn += (-pbn) % _COLS
        bk = bk if bk is not None else pbk
        bn = bn if bn is not None else pbn
    pk, pn = (-K) % bk, (-N) % bn
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    payload, idx, nz = build_block_csr(w, bk, bn)
    nkb, nnb = nz.shape
    cnt = nz.sum(axis=0).astype(np.int32)  # (nnb,)
    jmax = max(1, int(cnt.max()))
    jb, kb = np.nonzero(nz.T)  # j-major: sorted by j, then k ascending
    slot = np.arange(jb.size, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt
    )
    kidx = np.zeros((nnb, jmax), dtype=np.int32)
    vidx = np.zeros((nnb, jmax), dtype=np.int32)
    kidx[jb, slot] = kb.astype(np.int32)
    vidx[jb, slot] = idx[kb, jb]
    dev = w.device
    return WeightJoinPlan(
        payload=payload,
        kidx=torch.from_numpy(kidx).to(dev),
        vidx=torch.from_numpy(vidx).to(dev),
        cnt=torch.from_numpy(cnt).to(dev),
        bmap=torch.from_numpy(nz).to(dev),
    )


def prune_to_density(w: torch.Tensor, density: float) -> torch.Tensor:
    """Re-prune one (K, N) FFN weight to a lower block density: the
    speculative draft's weights (`ExecutionPolicy.speculation`'s
    ``draft_weight_density``).  The same block-magnitude rule and
    `pick_plan_blocks` geometry as `mlp_init`'s load-time prune (the
    reference's block count, a floor of ``nblocks * density``), so the
    draft's plan is built by the ordinary `build_weight_plan`."""
    from repro_torch.core.snn_layers import prune_by_magnitude

    K, N = w.shape
    bk, bn = pick_plan_blocks(K, N)
    block = (bk, bn) if (K % bk == 0 and N % bn == 0) else None
    return prune_by_magnitude(w, density, block=block)
