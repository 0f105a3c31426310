"""The BSR kernels' host-side routing and launch shape, on the CPU.

`bsr_instance` decides which instance of kernels 3 and 4 runs (``tc`` on
the tensor cores, ``simt``) from the payload's dtype, block shape and
alignment alone; `bsr_tc_shape` gives the tensor-core instance's cluster
split and slot ranges from the plan alone, so the sum order of every
output element never depends on M.  The kernels themselves run on the card
(`tests/test_torch_gpu.py`, marked ``gpu``).
"""
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro_torch.bridge import words_to_torch
from repro_torch.kernels import ftp_spmm, ops
from repro_torch.kernels.join_plan import build_weight_plan, pick_plan_blocks
from repro_torch.serve.policy import PACKED_DUAL, PACKED_DUAL_ADAPTIVE


@pytest.mark.parametrize("dtype,bk,bn,aligned,want", [
    (torch.bfloat16, 128, 128, True, "tc"),    # the serve's plans
    (torch.bfloat16, 256, 256, True, "tc"),
    (torch.bfloat16, 16, 64, True, "tc"),
    (torch.bfloat16, 64, 192, True, "tc"),
    (torch.float32, 128, 128, True, "simt"),   # f32 payloads keep SIMT
    (torch.bfloat16, 128, 96, True, "simt"),   # bn % 64 != 0
    (torch.bfloat16, 128, 32, True, "simt"),
    (torch.bfloat16, 8, 128, True, "simt"),    # small bk (tiny layers)
    (torch.bfloat16, 40, 128, True, "simt"),   # bk % 16 != 0
    (torch.bfloat16, 128, 128, False, "simt"),  # an unaligned base
])
def test_bsr_instance_routes_by_dtype_blocks_and_alignment(dtype, bk, bn,
                                                           aligned, want):
    assert ftp_spmm.bsr_instance(dtype, bk, bn, aligned) == want


def test_bsr_instance_of_tiny_layers_plans_is_simt():
    """pick_plan_blocks shrinks the blocks of tiny layers below what the
    tensor-core instance takes: those plans stay on SIMT."""
    for K, N in ((8, 64), (24, 96), (100, 32)):
        bk, bn = pick_plan_blocks(K, N)
        assert ftp_spmm.bsr_instance(torch.bfloat16, bk, bn, True) == "simt"
    bk, bn = pick_plan_blocks(2048, 8192)
    assert ftp_spmm.bsr_instance(torch.bfloat16, bk, bn, True) == "tc"


@pytest.mark.parametrize("T", [1, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("nnb,bn,jmax", [
    (64, 128, 9),    # llama3.2-1b W_in (2048 -> 8192) at block density 0.3
    (16, 128, 29),   # W_out (8192 -> 2048)
    (3, 128, 4),
    (1, 64, 1),
    (2, 256, 9),
    (5, 192, 7),     # bn % 128 != 0: the 64-column tile
])
def test_bsr_tc_shape_is_independent_of_M(T, nnb, bn, jmax):
    """For every M from 1 to 4096 the keys that decide results (the column
    tile and its instruction, the cluster split, the slot ranges) are the
    same; only the block's rows follow M: one m64 tile while M * T' <= 64
    (T' = pow2(T) >= 4) or while 256-row blocks would not fill a wave of
    132 SMs, else 256 MMA rows, each m64 tile holding 64 / T' spike rows,
    so a block covers whole act row tiles (pick_bm's) or lies inside
    one."""
    t_pad = max(4, 1 << (T - 1).bit_length())
    fixed = set()
    for M in range(1, 4097):
        s = ftp_spmm.bsr_tc_shape(nnb, bn, jmax, T, M)
        fixed.add((s["bn"], s["mma"], s["splits"], s["slots_per_rank"]))
        n_cols = nnb * bn // s["bn"]
        wave = -(-M // (256 // t_pad)) * n_cols * s["splits"] >= 132
        assert s["rows"] == (256 if M * t_pad > 64 and wave else 64)
        assert s["bm"] * t_pad == s["rows"] and s["bm"] >= 2
        act_bm = ftp_spmm.pick_bm(M, T)
        assert s["bm"] % act_bm == 0 or act_bm % s["bm"] == 0
        if s["rows"] == 256:  # several act row tiles a block, or one whole
            assert s["bm"] >= act_bm
    assert len(fixed) == 1
    tile, mma, splits, per = fixed.pop()
    assert bn % tile == 0 and mma == f"m64n{tile}k16"
    assert splits in (1, 2, 4, 8) and splits <= max(1, jmax)
    assert per == -(-jmax // splits)  # every live slot has one rank


def test_bsr_tc_shape_reaches_2_and_8_on_the_llama_plans():
    """The serve's plans (128 x 128 blocks, so 128-column tiles): W_in's 64
    column blocks fill the 64-block floor alone and keep one rank (2 in
    the 64-column design); W_out's 16 split 4 ways, where 8 would leave a
    rank fewer than 4 of its 29 slots.  Ranks reach 8 only where the join
    lists are long and the columns few."""
    w_in = ftp_spmm.bsr_tc_shape(64, 128, 9, 4, 4)
    w_out = ftp_spmm.bsr_tc_shape(16, 128, 29, 4, 4)
    assert (w_in["splits"], w_in["slots_per_rank"]) == (1, 9)
    assert (w_out["splits"], w_out["slots_per_rank"]) == (4, 8)
    assert w_in["bn"] == w_out["bn"] == 128
    assert ftp_spmm.bsr_tc_shape(8, 128, 38, 4, 4)["splits"] == 8
    assert ftp_spmm.bsr_tc_shape(8, 128, 31, 4, 4)["splits"] == 4
    # a join list shorter than the doubling would want caps S
    assert ftp_spmm.bsr_tc_shape(1, 64, 8, 4, 4)["splits"] == 2
    assert ftp_spmm.bsr_tc_shape(1, 64, 7, 4, 4)["splits"] == 1


@pytest.mark.parametrize("bn,tile", [
    (64, 64), (128, 128), (192, 64), (256, 128), (320, 64), (384, 128),
])
def test_bsr_tc_shape_picks_the_n64_or_n128_instance(bn, tile):
    """The column tile (the MMA's N) is 128 where the plan's bn is a
    multiple of 128, else 64 (the tc route takes bn % 64 == 0); the same
    plan gets the same instance at every M and T, and its splits count
    column tiles of that width."""
    for M, T in ((1, 1), (4, 4), (300, 16), (4096, 32)):
        s = ftp_spmm.bsr_tc_shape(4, bn, 8, T, M)
        assert (s["bn"], s["mma"]) == (tile, f"m64n{tile}k16")
        assert ftp_spmm.bsr_instance(torch.bfloat16, 128, bn, True) == "tc"
    # 4 column blocks and long join lists: the splits count column tiles
    # of the instance's width, doubling while the grid is under 64 blocks
    n_cols = 4 * bn // tile
    splits = ftp_spmm.bsr_tc_shape(4, bn, 64, 4, 4)["splits"]
    assert n_cols * splits >= 64 or splits == 8
    assert splits == 1 or n_cols * splits // 2 < 64


def test_bsr_instance_counts_are_named_and_start_at_zero():
    """launch_counts() names one count per BSR instance beside the dense
    ones; all start at 0, and CPU calls (plain versions) move none."""
    ftp_spmm.reset_launch_counts()
    counts = ftp_spmm.launch_counts()
    assert counts["ftp_bsr_tc"] == counts["ftp_bsr_simt"] == 0
    assert tuple(counts)[-2:] == ("ftp_bsr_tc", "ftp_bsr_simt")
    rng = np.random.default_rng(3)
    packed, w = _mk(rng, 4, 12, 256, 128, density=0.2, w_density=0.5)
    a = words_to_torch(packed)
    for wt in (torch.from_numpy(w), torch.from_numpy(w).to(torch.bfloat16)):
        plan = build_weight_plan(wt)
        for policy in (PACKED_DUAL, PACKED_DUAL_ADAPTIVE):
            ops.dispatch(a, plan, policy, 4, n_out=128, fuse_lif=True)
    assert ftp_spmm.launch_counts() == counts


def test_bsr_instance_override_is_ignored_only_on_the_cpu():
    """On the CPU the wrapper runs the plain version whatever instance is
    asked for; the same outputs either way."""
    rng = np.random.default_rng(4)
    packed, w = _mk(rng, 4, 9, 128, 128, density=0.2, w_density=0.5)
    plan = build_weight_plan(torch.from_numpy(w).to(torch.bfloat16))
    a = words_to_torch(packed)
    bm = ftp_spmm.pick_bm(9, 4)
    args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
            ops._activity(a, bm, plan), 128, 4)
    want = ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=False)
    for inst in ("tc", "simt"):
        got = ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=False, instance=inst)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
