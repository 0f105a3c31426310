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

Mesh serving (`serve.sharding`): `shard_plan` splits a plan into ``shards``
self-contained column slabs (`split_plan`) stacked on a leading axis, as a
`ShardedWeightJoinPlan` that also records the whole plan's launch shape,
so each slab's kernel launch sums every element in the unsharded order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .ftp_spmm import _COLS

# Default weight block (the reference's MXU-sized 128x128).
BK, BN = 128, 128


def pick_plan_blocks(K: int, N: int, bk: int = BK, bn: int = BN) -> tuple[int, int]:
    """Shrink default weight blocks for small problems (reference rule)."""
    return min(bk, max(8, K)), min(bn, max(128, N) if N >= 128 else N)


def pick_shard_blocks(
    K: int, N: int, shards: int, bk: int = BK, bn: int = BN
) -> tuple[int, int]:
    """Block sizes for a plan to be column-split over ``shards`` model
    shards: ``bn`` halves (floor 8) until there are ``shards`` column blocks
    to deal out (reference rule)."""
    bk, bn = pick_plan_blocks(K, N, bk, bn)
    while bn > 8 and -(-N // bn) < shards:
        bn = max(8, bn // 2)
    return bk, bn


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

    def to(self, device) -> "WeightJoinPlan":
        """The same plan with every field on ``device``."""
        return WeightJoinPlan(*(getattr(self, f).to(device) for f in _FIELDS))


_FIELDS = ("payload", "kidx", "vidx", "cnt", "bmap")


@dataclass(frozen=True)
class ShardedWeightJoinPlan(WeightJoinPlan):
    """A column-split plan (`shard_plan`): every field carries a leading
    shard axis (after a layer axis, if `stack_plans` stacked one), slab j
    being a self-contained plan for the j-th contiguous range of column
    blocks.  A distinct type, so `kernels.ops` routes on the type and a
    layer-stacked plain plan is never taken for a sharded one.

    ``parent_nnb`` / ``parent_jmax``: the unsplit plan's column blocks and
    join width.  A slab's kernel launch takes the parent's shape
    (`ftp_spmm.bsr_tc_shape` of these), so each of its elements is summed
    in the unsharded order (the tensor-core instance's K split would
    otherwise follow the slab's own, narrower, geometry)."""

    parent_nnb: int = 0
    parent_jmax: int = 0
    _placed: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def shards(self) -> int:
        return self.payload.shape[-4]

    @property
    def parent(self) -> tuple[int, int]:
        return self.parent_nnb, self.parent_jmax

    def slab(self, j: int, device=None) -> WeightJoinPlan:
        """Slab ``j`` of a per-layer sharded plan, on ``device`` (default:
        the plan's own).  On the plan's device a slab is a view of the
        stacked fields: contiguous, and its payload base stays 16-byte
        aligned (a whole number of (bk, bn) blocks from an aligned base).
        On another device it is a copy made once and kept."""
        if self.payload.ndim != 4:
            raise ValueError(
                "a slab needs a per-layer sharded plan (payload rank 4); "
                f"got rank {self.payload.ndim}: slice the layer axis first"
            )
        home = WeightJoinPlan(*(getattr(self, f)[j] for f in _FIELDS))
        if device is None or torch.device(device) == self.payload.device:
            return home
        key = (j, str(torch.device(device)))
        if key not in self._placed:
            self._placed[key] = home.to(device)
        return self._placed[key]


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


def build_sharded_weight_plan(w: torch.Tensor, shards: int) -> WeightJoinPlan:
    """A plan ready for `split_plan(plan, shards)`: shard-aware blocks
    (`pick_shard_blocks`) and zero columns padded on until the column-block
    count divides ``shards`` (pad blocks have ``cnt == 0``: they join
    nothing).  On the card the column block widens to the BSR kernels'
    32-column tile, as in `build_weight_plan`."""
    K, N = w.shape
    bk, bn = pick_shard_blocks(K, N, shards)
    if w.is_cuda:
        bn += (-bn) % _COLS
    nnb = -(-N // bn)
    nnb += (-nnb) % shards
    pad = nnb * bn - N
    if pad:
        w = F.pad(w, (0, pad))
    return build_weight_plan(w, bk=bk, bn=bn)


def split_plan(plan: WeightJoinPlan, parts: int) -> list[WeightJoinPlan]:
    """Split one plan into ``parts`` self-contained plans over contiguous
    output-column-block slabs (reference rule, field for field).

    Each slab keeps only the payload blocks its own columns join with,
    re-indexed locally, and its join lists cut to its own widest column;
    running the kernel slab by slab and concatenating the outputs in order
    gives the unsplit result (each output column's full-K contraction stays
    inside one slab: no cross-slab sum).  ``plan.nnb`` must divide by
    ``parts``."""
    nnb = plan.nnb
    if parts < 1 or nnb % parts:
        raise ValueError(f"cannot split {nnb} column blocks into {parts} slabs")
    if parts == 1:
        return [plan]
    per = nnb // parts
    kidx = plan.kidx.cpu().numpy()
    vidx = plan.vidx.cpu().numpy()
    cnt = plan.cnt.cpu().numpy()
    dev = plan.payload.device
    subs = []
    for s in range(parts):
        sl = slice(s * per, (s + 1) * per)
        k_s, v_s, c_s = kidx[sl], vidx[sl], cnt[sl]
        live = np.arange(k_s.shape[1])[None, :] < c_s[:, None]
        used = np.unique(v_s[live])
        if used.size == 0:  # all-zero slab: keep one dummy payload block
            pay = plan.payload.new_zeros((1,) + tuple(plan.payload.shape[1:]))
            v_new = np.zeros_like(v_s)
        else:
            remap = np.zeros(plan.payload.shape[0], np.int32)
            remap[used] = np.arange(used.size, dtype=np.int32)
            pay = plan.payload[torch.from_numpy(used).to(dev)].contiguous()
            v_new = np.where(live, remap[v_s], 0).astype(np.int32)
        jm = max(1, int(c_s.max()))
        subs.append(WeightJoinPlan(
            payload=pay,
            kidx=torch.from_numpy(np.ascontiguousarray(k_s[:, :jm])).to(dev),
            vidx=torch.from_numpy(np.ascontiguousarray(v_new[:, :jm])).to(dev),
            cnt=torch.from_numpy(np.ascontiguousarray(c_s)).to(dev),
            bmap=plan.bmap[:, sl].contiguous(),
        ))
    return subs


def stack_plans(plans: list[WeightJoinPlan]) -> WeightJoinPlan:
    """Stack plans of one geometry on a new leading axis (reference rule):
    payloads zero-padded to the most blocks, join lists to the widest
    ``jmax`` (padding is unreachable: ``cnt`` masks the join tail).  Keeps
    the type, so stacking sharded plans (a layer axis over the shard axis)
    gives a sharded plan."""
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    geo = {(p.bk, p.bn, p.nkb, p.nnb) for p in plans}
    if len(geo) != 1:
        raise ValueError(f"cannot stack plans with differing geometry {geo}")
    nnzb = max(p.payload.shape[-3] for p in plans)
    jmax = max(p.jmax for p in plans)

    def pad_to(x, size, axis):
        pad = size - x.shape[axis]
        if pad == 0:
            return x
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    fields = dict(
        payload=torch.stack([pad_to(p.payload, nnzb, -3) for p in plans]),
        kidx=torch.stack([pad_to(p.kidx, jmax, -1) for p in plans]),
        vidx=torch.stack([pad_to(p.vidx, jmax, -1) for p in plans]),
        cnt=torch.stack([p.cnt for p in plans]),
        bmap=torch.stack([p.bmap for p in plans]),
    )
    if isinstance(plans[0], ShardedWeightJoinPlan):
        return ShardedWeightJoinPlan(
            **fields, parent_nnb=max(p.parent_nnb for p in plans),
            parent_jmax=max(p.parent_jmax for p in plans))
    return WeightJoinPlan(**fields)


def shard_plan(plan: WeightJoinPlan, shards: int) -> ShardedWeightJoinPlan:
    """`split_plan` + `stack_plans`: one plan whose leading axis deals the
    column slabs out to ``shards`` model shards, recording ``plan``'s
    (nnb, jmax) as the launch shape of every slab."""
    p = stack_plans(split_plan(plan, shards))
    return ShardedWeightJoinPlan(p.payload, p.kidx, p.vidx, p.cnt, p.bmap,
                                 parent_nnb=plan.nnb, parent_jmax=plan.jmax)
