"""Tests of the port that need the card: every CUDA kernel against its
plain torch version on the same CUDA inputs (kernels 1 and 2: the dense
`ftp_dense.cu`; 3 and 4: the BSR `ftp_bsr.cu`, full and adaptive).  Marked
``gpu``; each skips without a CUDA device (a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: full sums within 1e-5 (the kernel and the plain version add the
same exact products of a {0,1} spike and a weight, in two f32 orders);
spike words equal except where the LIF input is within 1e-5 of v_th.
Between kernels that add the same products in the same order (kernel 4 and
kernel 3 at min_spikes=1, the dense kernel's SIMT instance and kernel 3 on
block-pruned f32 weights, one row alone and in a batch, two runs): equal,
bit for bit.  The tensor-core instances (bf16 weights or payloads) add in
another order than the SIMT ones, so across instances (the dense `tc`
instance against kernel 3, either BSR instance against the other) the
outputs are held to the same gate as against the plain version.

Run the dense kernels' tests alone with ``-k dense``, the BSR tensor-core
instance's with ``-k bsr_tc``, the flash kernels' (5-7, both instances)
with ``-k flash``, the MoE archs' (no kernel of their own: the routing
and a serve through mixtral's ring cache, card against CPU) with
``-k moe``, the op counter's (card counts == CPU counts) with ``-k counted``,
the serve mesh's (logical devices on the one card: slab launches with
their parent's shape equal to the unsharded call, vocab slabs equal to the
unembedding's whole column blocks, a meshed serve equal to the
single-device one, bit for bit) with ``-k mesh``, approximate-TP serving's
(drift within 0.25 of one device; 2 x 2 == 1 x 2 and pipelined == sync bit
for bit) with ``-k approximate_tp``, the train mesh's (the meshed step on
logical devices of the card against the one-device step, a repeat bit for
bit, whole-batch MoE routing, a restore with shardings) with
``-k train_mesh``.
"""
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro_torch.bridge import words_to_torch
from repro_torch.core.packing import (
    mask_low_activity_timesteps,
    timestep_activity_map,
)
from repro_torch.core.snn_layers import prune_by_magnitude
from repro_torch.kernels import ftp_spmm, ops, ref
from repro_torch.kernels.join_plan import build_weight_plan
from repro_torch.serve.policy import (
    PACKED_DENSE,
    PACKED_DUAL,
    PACKED_DUAL_ADAPTIVE,
    ExecutionPolicy,
    adaptive_t,
    approximate,
)

TOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _lif_margin(o, v_th=1.0, tau=0.5):
    u, margin = torch.zeros_like(o[0]), torch.full_like(o[0], float("inf"))
    for t in range(o.shape[0]):
        x = o[t] + u
        margin = torch.minimum(margin, (x - v_th).abs())
        u = tau * x * (1.0 - (x > v_th).float())
    return margin


def _hold(c, u, o, fuse):
    """Kernel outputs (c, u) against the plain full sums ``o``."""
    if fuse:
        cw, uw = ref.lif_ref(o)
        differ = c.reshape(cw.shape) != cw
        assert not bool((differ & (_lif_margin(o) >= TOL)).any())
        torch.testing.assert_close(u.reshape(uw.shape)[~differ], uw[~differ],
                                   rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(c.reshape(o.shape), o, rtol=TOL, atol=TOL)


def _bsr_instance(plan):
    p = plan.payload
    return "ftp_bsr_" + ftp_spmm.bsr_instance(p.dtype, p.shape[1], p.shape[2],
                                               p.data_ptr() % 16 == 0)


def _check(a, plan, n_out, T, fuse, policy=PACKED_DUAL, instance=None):
    """BSR kernel through `ops.dispatch` vs the plain version on the same
    tensors; one launch of the policy's kernel counted, and one of the
    instance the payload routes to (``instance``, when given, must be that
    one)."""
    name = "ftp_bsr_adaptive" if policy.temporal.enabled else "ftp_bsr"
    inst = _bsr_instance(plan)
    if instance is not None:
        assert inst == f"ftp_bsr_{instance}", inst
    before = ftp_spmm.launch_counts()
    c, u = ops.dispatch(a, plan, policy, T, n_out=n_out, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, **{name: before[name] + 1, inst: before[inst] + 1})
    rows = a.reshape(-1, a.shape[-1])
    bm = ftp_spmm.pick_bm(rows.shape[0], T)
    tmap = None
    if policy.temporal.enabled:
        tmap = (timestep_activity_map(rows, T, policy.temporal.min_spikes)
                .to(torch.int32))
    o, _ = ftp_spmm.ftp_spmm_bsr_plain(
        rows, plan.payload, plan.kidx, plan.vidx, plan.cnt,
        ops._activity(rows, bm, plan), n_out, T, bm=bm, fuse_lif=False,
        tmap=tmap)
    _hold(c, u, o, fuse)
    if not fuse:
        assert not bool(u.any())
    return c, u


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 33, 300])
def test_kernel_matches_plain_bf16_block_pruned(M, T, fuse):
    """Ragged row counts at both row tiles, every accumulator bucket of T
    up to 32, the serving layout: bf16 payload, 128x128 blocks pruned to
    density 0.3."""
    dev = _cuda()
    rng = np.random.default_rng(M * 10 + T)
    packed, _ = _mk(rng, T, M, 512, 384, density=0.2)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    _check(words_to_torch(packed, dev), plan, 384, T, fuse)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_kernel_matches_plain_f32_unaligned_and_batched(fuse):
    """f32 payload, K and N not multiples of the block (plan padding, a
    column tail past n_out), a (B, M, K) batch folded into rows."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    packed, w = _mk(rng, 4, 24, 200, 160, density=0.3, w_density=0.3)
    plan = build_weight_plan(torch.from_numpy(w).to(dev), bk=64, bn=64)
    a = words_to_torch(packed, dev).reshape(3, 8, 200)
    _check(a, plan, 160, 4, fuse)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_kernel_silent_rows_and_empty_column_block(fuse):
    dev = _cuda()
    rng = np.random.default_rng(8)
    packed, w = _mk(rng, 4, 40, 256, 256, density=0.1, w_density=0.4)
    packed[:16] = 0
    w[:, 64:128] = 0
    plan = build_weight_plan(torch.from_numpy(w).to(dev), bk=64, bn=64)
    assert int(plan.cnt[1]) == 0
    _check(words_to_torch(packed, dev), plan, 256, 4, fuse)
    _check(torch.zeros((4, 256), dtype=torch.int32, device=dev), plan, 256, 4,
           fuse)


@pytest.mark.gpu
def test_kernel_rows_are_batch_invariant():
    """A row's output does not depend on the other rows or the row tile:
    row i of a 300-row call equals the same row computed alone, bit for
    bit (fixed accumulation order: ascending join slot, then k)."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    packed, w = _mk(rng, 4, 300, 256, 256, density=0.2, w_density=0.3)
    plan = build_weight_plan(torch.from_numpy(w).to(dev, torch.bfloat16))
    a = words_to_torch(packed, dev)
    full, _ = ops.dispatch(a, plan, PACKED_DUAL, 4, n_out=256, fuse_lif=False)
    for i in (0, 17, 299):
        one, _ = ops.dispatch(a[i:i + 1], plan, PACKED_DUAL, 4, n_out=256,
                              fuse_lif=False)
        assert torch.equal(one[:, 0], full[:, i])


# ---------------------------------------------------------------------------
# kernel 4: the BSR kernel gated by a timestep-activity map
# ---------------------------------------------------------------------------

def _front_silent(rng, T, M, K, density=0.2):
    """Packed words whose first ~3/4 of the planes are silent (direct
    encoding charges membranes for a few steps first)."""
    packed, _ = _mk(rng, T, M, K, 8, density=density)
    keep = np.uint32(0)
    for t in range(T):
        if t >= (3 * T) // 4 or t == T - 1:
            keep |= np.uint32(1 << t)
    return packed & keep


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 33, 300])
def test_adaptive_kernel_equals_full_at_min_spikes_1(M, T, fuse):
    """Kernel 4 matches its plain version, and equals kernel 3 bit for bit:
    a gated plane has no bit set anywhere, so the adds and their order are
    kernel 3's.  The bf16 128 x 128 plan runs the tensor-core instance,
    where at T = 4, M = 300 (one plane per m16 row group) and at T >= 16
    (four planes per group at M <= 33) whole row groups are gated and issue
    no mma."""
    dev = _cuda()
    rng = np.random.default_rng(1000 + M * 10 + T)
    packed = _front_silent(rng, T, M, 512)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    a = words_to_torch(packed, dev)
    c_a, u_a = _check(a, plan, 384, T, fuse, PACKED_DUAL_ADAPTIVE, "tc")
    c_f, u_f = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=384, fuse_lif=fuse)
    assert torch.equal(c_a, c_f) and torch.equal(u_a, u_f)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_adaptive_kernel_lossy_equals_full_on_masked_input(fuse):
    """min_spikes=2 on the card: kernel 4 equals kernel 3 applied to the
    masked input, bit for bit; a (B, M, K) batch is scored as one."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    T, M, K, N = 16, 48, 300, 160
    packed, w = _mk(rng, T, M, K, N, density=0.15, w_density=0.2)
    packed &= ~np.uint32((1 << 1) | (1 << 3) | (1 << 9))
    packed[5, 7] |= np.uint32(1 << 1)
    packed[9, 2] |= np.uint32(1 << 9)
    plan = build_weight_plan(torch.from_numpy(w).to(dev), bk=64, bn=64)
    a = words_to_torch(packed, dev).reshape(2, 24, K)
    lossy = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                            temporal=adaptive_t(2), exactness=approximate(8.0))
    masked = mask_low_activity_timesteps(a, T, 2)
    assert not torch.equal(masked, a)
    c_l, u_l = _check(a, plan, N, T, fuse, lossy)
    c_m, u_m = ops.dispatch(masked, plan, PACKED_DUAL, T, n_out=N, fuse_lif=fuse)
    assert torch.equal(c_l, c_m) and torch.equal(u_l, u_m)


# ---------------------------------------------------------------------------
# kernels 3 and 4: the tensor-core instance (bf16 payloads)
# ---------------------------------------------------------------------------

def _bsr_tc_case(rng, T, M, N=330):
    """bf16 words and weights: K = 500 (a K tail inside the last 128-deep
    block), N columns (330: n_out short of a 128-column plan's 384),
    columns 128..255 pruned whole (cnt == 0), k block 0 of every column
    from 256 on pruned, every 7th row silent."""
    packed, w = _mk(rng, T, M, 500, N, density=0.2, w_density=0.5)
    packed[1::7] = 0
    w[:, 128:256] = 0
    w[0:128, 256:] = 0
    return packed, torch.from_numpy(w / 8).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T", [1, 3, 4, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 33, 63, 300, 512, 784])
def test_bsr_tc_matches_plain(M, T, fuse, bn):
    """Kernel 3's tensor-core instance at ragged shapes and at each
    row-block choice (one m64 tile while M * T' <= 64; 64-row blocks while
    256-row ones would not fill a wave of SMs: M 33-300 here; else 256 MMA
    rows over one to 16 act row tiles; ragged last blocks): T from 1
    (three dead planes of the 4-plane minimum) to 32, both act row tiles,
    both column tiles (bn 64: m64n64k16, bn 128: m64n128k16), a K tail, a
    column tail (N = 2058, 10 columns into the last 128), empty column
    blocks (cnt == 0) and silent rows; kernel 4 on the same inputs too."""
    dev = _cuda()
    rng = np.random.default_rng(9000 + M * 100 + T + (bn == 64) * 100000)
    packed, w = _bsr_tc_case(rng, T, M, 2058)
    plan = build_weight_plan(w.to(dev), bk=128, bn=bn)
    empty = (1,) if bn == 128 else (2, 3)  # columns 128..255 pruned whole
    assert all(int(plan.cnt[j]) == 0 for j in empty)
    shape = ftp_spmm.bsr_tc_shape(plan.nnb, plan.bn, plan.jmax, T, M)
    assert shape["bn"] == bn and shape["mma"] == f"m64n{bn}k16"
    if M in (512, 784) or (M >= 300 and T >= 16):
        assert shape["rows"] == 256, shape
    a = words_to_torch(packed, dev)
    _check(a, plan, 2058, T, fuse, instance="tc")
    _check(a, plan, 2058, T, fuse, PACKED_DUAL_ADAPTIVE, instance="tc")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 16])
def test_bsr_tc_splits_8_deterministic_and_batch_invariant(T):
    """A plan with 8 column blocks and join lists of 32 slots or more
    reaches 8 ranks: held against the plain version; two runs equal bit for
    bit; a row computed alone (M = 1, bm = 4) or among 4 equals the same
    row of a 300-row call (bm = 16 or 8), bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(80 + T)
    packed, _ = _mk(rng, T, 300, 8192, 8, density=0.2)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(8192, 1024)).astype(
        np.float32) / 64), 0.6, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    assert plan.jmax >= 32
    assert ftp_spmm.bsr_tc_shape(plan.nnb, plan.bn, plan.jmax, T,
                                 4)["splits"] == 8
    a = words_to_torch(packed, dev)
    _check(a, plan, 1024, T, False, instance="tc")
    for fuse in (True, False):
        runs = [ops.dispatch(a, plan, PACKED_DUAL, T, n_out=1024,
                             fuse_lif=fuse) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        full = runs[0]
        for lo, hi in ((0, 1), (17, 18), (296, 300)):
            part = ops.dispatch(a[lo:hi].contiguous(), plan, PACKED_DUAL, T,
                                n_out=1024, fuse_lif=fuse)
            if fuse:
                assert torch.equal(part[0], full[0][lo:hi])
            else:
                assert torch.equal(part[0], full[0][:, lo:hi])
            assert torch.equal(part[1], full[1][lo:hi])


@pytest.mark.gpu
@pytest.mark.parametrize("T,M", [(4, 300), (16, 200)])
def test_bsr_tc_row_alone_equals_row_in_a_256_row_block(T, M):
    """A row alone (a 64-row block) equals the same row of a 256-row block
    whose other act row tiles are active, bit for bit, and a row of a
    silent act row tile (between two active ones in that block) alone
    equals it in the block; a 4-row window across the silent tile's edges
    too.  At T 4 the block holds 4 act row tiles of 16 rows, at T 16 (M <
    256) 4 of 4."""
    dev = _cuda()
    rng = np.random.default_rng(600 + T)
    packed, _ = _mk(rng, T, M, 1024, 8, density=0.2)
    act_bm = ftp_spmm.pick_bm(M, T)
    packed[act_bm:2 * act_bm] = 0  # act row tile 1 of block 0 silent
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(1024, 4096)).astype(
        np.float32) / 16), 0.5, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    a = words_to_torch(packed, dev)
    whole = ftp_spmm.bsr_tc_shape(plan.nnb, plan.bn, plan.jmax, T, M)
    assert whole["rows"] == 256 and whole["bm"] >= 3 * act_bm
    for n in (1, 4):
        assert ftp_spmm.bsr_tc_shape(plan.nnb, plan.bn, plan.jmax, T,
                                     n)["rows"] == 64
    for fuse in (True, False):
        full = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=4096, fuse_lif=fuse)
        for lo, hi in ((0, 1), (act_bm + 1, act_bm + 2), (2 * act_bm + 3,
                       2 * act_bm + 4), (M - 1, M), (2 * act_bm - 2,
                                                     2 * act_bm + 2)):
            part = ops.dispatch(a[lo:hi].contiguous(), plan, PACKED_DUAL, T,
                                n_out=4096, fuse_lif=fuse)
            got = full[0][lo:hi] if fuse else full[0][:, lo:hi]
            assert torch.equal(part[0], got), (fuse, lo, hi)
            assert torch.equal(part[1], full[1][lo:hi]), (fuse, lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("T,M", [(4, 300), (8, 2), (16, 40), (32, 9)])
def test_bsr_tc_gated_plane_inside_an_m64_tile(T, M):
    """An m64 tile holds all T' planes of its spike rows, so a plane that
    tmap gates is a run of zero rows inside a tile that still issues its
    MMA: kernel 4 equals kernel 3 bit for bit (min_spikes 1) and both hold
    against the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(700 + T + M)
    packed, _ = _mk(rng, T, M, 512, 8, density=0.3)
    packed &= ~np.uint32((1 << 1) | (1 << (T - 1)) if T > 2 else 1 << 1)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    a = words_to_torch(packed, dev)
    tmap = timestep_activity_map(a, T)
    assert int(tmap[1]) == 0 and int(tmap.sum()) >= 1
    for fuse in (True, False):
        c4, u4 = _check(a, plan, 384, T, fuse, PACKED_DUAL_ADAPTIVE, "tc")
        c3, u3 = _check(a, plan, 384, T, fuse, PACKED_DUAL, "tc")
        assert torch.equal(c4, c3) and torch.equal(u4, u3)


@pytest.mark.gpu
def test_bsr_routing_by_dtype_and_blocks():
    """bf16 128 x 128 payloads take the tensor-core instance; f32 payloads,
    bn % 64 != 0 and the small blocks of a tiny layer take SIMT (each held
    against the plain version); asking for the tensor-core instance where
    it does not fit raises; the SIMT instance on a bf16 payload, asked for
    by name, holds too."""
    dev = _cuda()
    rng = np.random.default_rng(70)
    packed, w = _mk(rng, 4, 33, 256, 192, density=0.2, w_density=0.5)
    a = words_to_torch(packed, dev)
    wt = torch.from_numpy(w / 8).to(dev)
    cases = [(build_weight_plan(wt.to(torch.bfloat16), bk=128, bn=128), "tc"),
             (build_weight_plan(wt, bk=128, bn=128), "simt"),
             (build_weight_plan(wt.to(torch.bfloat16), bk=64, bn=96), "simt")]
    for plan, inst in cases:
        for fuse in (True, False):
            _check(a, plan, 192, 4, fuse, instance=inst)
    tiny_packed, tiny_w = _mk(rng, 4, 5, 8, 64, density=0.3, w_density=0.5)
    tiny = build_weight_plan(torch.from_numpy(tiny_w).to(dev, torch.bfloat16))
    assert tiny.bk == 8
    _check(words_to_torch(tiny_packed, dev), tiny, 64, 4, True, instance="simt")
    plan = cases[0][0]
    bm = ftp_spmm.pick_bm(33, 4)
    args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
            ops._activity(a, bm, plan), 192, 4)
    for bad in (cases[1][0], cases[2][0]):
        with pytest.raises(ValueError, match="tc instance"):
            ftp_spmm.ftp_spmm_bsr(a, bad.payload, bad.kidx, bad.vidx, bad.cnt,
                                  ops._activity(a, bm, bad), 192, 4, bm=bm,
                                  instance="tc")
    before = ftp_spmm.launch_counts()["ftp_bsr_simt"]
    got, _ = ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=False,
                                   instance="simt")
    assert ftp_spmm.launch_counts()["ftp_bsr_simt"] == before + 1
    o, _ = ftp_spmm.ftp_spmm_bsr_plain(*args, bm=bm, fuse_lif=False)
    _hold(got, None, o, False)


def _table_ii_words(rng, T, M, K, d_a, ns):
    """Packed words at a Table II layer's sparsity: non-silent with
    probability ``ns``, then firing at each timestep with d_a / ns, at
    least once."""
    live = rng.random((M, K)) < ns
    fire = rng.random((T, M, K)) < min(1.0, d_a / ns)
    fire[rng.integers(0, T, size=(M, K)), np.arange(M)[:, None],
         np.arange(K)[None, :]] = True
    fire &= live[None]
    return sum(fire[t].astype(np.uint32) << t for t in range(T)).astype(np.uint32)


# (T, M, N, K, d_a, ns, d_b): T-HFF (Table II); AlexNet's conv1 (K = 27,
# bk 27) and fc2 (N = 10: the column block widens to 32) at AlexNet's
# Table II averages
TABLE_II_SHAPES = {
    "T-HFF": (4, 784, 3072, 3072, 0.15, 0.18, 0.032),
    "alexnet-conv1": (4, 1024, 64, 27, 0.188, 0.287, 0.018),
    "alexnet-fc2": (4, 1, 10, 1024, 0.188, 0.287, 0.018),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(TABLE_II_SHAPES))
def test_per_call_route_at_table_ii_shapes(shape, dtype, fuse):
    """Raw unstructured-pruned weights under PACKED_DUAL: a plan built per
    call, one launch of kernel 3 (bf16 T-HFF on `tc`, the small blocks on
    SIMT), held against the dense plain oracle."""
    dev = _cuda()
    T, M, N, K, d_a, ns, d_b = TABLE_II_SHAPES[shape]
    rng = np.random.default_rng(K + N)
    a = words_to_torch(_table_ii_words(rng, T, M, K, d_a, ns), dev)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(K, N)).astype(
        np.float32)), d_b).to(dev, dtype)
    want_inst = "tc" if (shape == "T-HFF" and dtype == torch.bfloat16) else "simt"
    before = ftp_spmm.launch_counts()
    c, u = ops.dispatch(a, w, PACKED_DUAL, T, fuse_lif=fuse)
    torch.cuda.synchronize()
    inst = f"ftp_bsr_{want_inst}"
    assert ftp_spmm.launch_counts() == dict(
        before, ftp_bsr=before["ftp_bsr"] + 1, **{inst: before[inst] + 1})
    assert c.shape == ((M, N) if fuse else (T, M, N))
    _hold(c, u, ref.ftp_spmm_ref(a, w, T), fuse)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_load_time_plan_at_n_10_widens_and_equals_per_call(fuse):
    """A load-time plan of an N = 10 weight built on the card has the
    per-call route's 32-wide column block: it launches the SIMT instance
    and gives the per-call route's outputs bit for bit."""
    dev = _cuda()
    T, M, N, K, d_a, ns, d_b = TABLE_II_SHAPES["alexnet-fc2"]
    rng = np.random.default_rng(K + N)
    a = words_to_torch(_table_ii_words(rng, T, M, K, d_a, ns), dev)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(K, N)).astype(
        np.float32)), d_b).to(dev, torch.bfloat16)
    plan = build_weight_plan(w)
    assert plan.bn == 32 and build_weight_plan(w.cpu()).bn == 10
    before = ftp_spmm.launch_counts()
    c, u = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=N, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, ftp_bsr=before["ftp_bsr"] + 1,
        ftp_bsr_simt=before["ftp_bsr_simt"] + 1)
    c_call, u_call = ops.dispatch(a, w, PACKED_DUAL, T, fuse_lif=fuse)
    assert torch.equal(c, c_call) and torch.equal(u, u_call)
    _hold(c, u, ref.ftp_spmm_ref(a, w, T), fuse)


# ---------------------------------------------------------------------------
# kernels 1 and 2: packed spikes x dense weights
# ---------------------------------------------------------------------------

def _instance(w):
    return "ftp_dense_" + ftp_spmm.dense_instance(w.dtype, w.shape[1],
                                                   w.data_ptr() % 16 == 0)


def _check_dense(a, w, T, fuse, instance=None):
    """Dense kernel through `ops.dispatch` vs its plain version; one launch
    of kernel 2 (fused) or 1 counted, and one of the instance the weights
    route to (``instance``, when given, must be that one)."""
    name = "ftp_spmm_fused_lif" if fuse else "ftp_spmm"
    inst = _instance(w)
    if instance is not None:
        assert inst == f"ftp_dense_{instance}", inst
    before = ftp_spmm.launch_counts()
    got = ops.dispatch(a, w, PACKED_DENSE, T, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, **{name: before[name] + 1, inst: before[inst] + 1})
    rows = a.reshape(-1, a.shape[-1])
    o = ftp_spmm.ftp_spmm_plain(rows, w, T)
    if fuse:
        c, u = got
        _hold(c, u, o, True)
        assert c.shape == u.shape == a.shape[:-1] + (w.shape[1],)
    else:
        _hold(got, None, o, False)
        assert got.shape == (T,) + a.shape[:-1] + (w.shape[1],)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", [(200, 130), (512, 384)])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 33, 300])
def test_dense_kernel_matches_plain(M, T, K, N, dtype, fuse):
    """Kernels 1 and 2 at ragged rows, both row tiles, every accumulator
    bucket, bf16 and f32 weights, an unaligned K and N (the SIMT instance's
    2- and 4-byte load path and a masked column tail) and an aligned pair
    (16-byte loads; with bf16 weights the tensor-core instance)."""
    dev = _cuda()
    rng = np.random.default_rng(M * 100 + T + K)
    packed, w = _mk(rng, T, M, K, N, density=0.2, w_density=0.5)
    _check_dense(words_to_torch(packed, dev),
                 torch.from_numpy(w / 8).to(dev, dtype), T, fuse)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_dense_kernel_batched_and_batch_invariant(fuse):
    """A (B, M, K) batch folds into rows; a row's outputs do not depend on
    the other rows or the row tile."""
    dev = _cuda()
    rng = np.random.default_rng(21)
    packed, w = _mk(rng, 4, 300, 256, 200, density=0.2, w_density=0.4)
    a = words_to_torch(packed, dev)
    wt = torch.from_numpy(w).to(dev, torch.bfloat16)
    _check_dense(a.reshape(3, 100, 256), wt, 4, fuse)
    full = ops.dispatch(a, wt, PACKED_DENSE, 4, fuse_lif=fuse)
    for i in (0, 17, 299):
        one = ops.dispatch(a[i:i + 1], wt, PACKED_DENSE, 4, fuse_lif=fuse)
        if fuse:
            assert torch.equal(one[0][0], full[0][i])
            assert torch.equal(one[1][0], full[1][i])
        else:
            assert torch.equal(one[:, 0], full[:, i])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [4, 16])
@pytest.mark.parametrize("M", [4, 300])
def test_dense_kernel_equals_bsr_on_block_pruned_weights(M, T, dtype):
    """f32 weights take the SIMT instance, which adds in ascending k as
    kernel 3 does (a pruned weight only adds +0): full sums, spike words
    and U equal kernel 3's, bit for bit.  bf16 weights take the
    tensor-core instance, which adds the same exact products in another
    order: held against kernel 3 as against its plain version (full sums
    within TOL, a spike word differs only within TOL of v_th)."""
    dev = _cuda()
    rng = np.random.default_rng(31 + M + T)
    packed, _ = _mk(rng, T, M, 512, 8, density=0.2)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128)).to(dev, dtype)
    plan = build_weight_plan(w)
    a = words_to_torch(packed, dev)
    o_dense = ops.dispatch(a, w, PACKED_DENSE, T)
    o_bsr, _ = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=384)
    c_d, u_d = ops.dispatch(a, w, PACKED_DENSE, T, fuse_lif=True)
    c_b, u_b = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=384, fuse_lif=True)
    if dtype == torch.float32:
        assert _instance(w) == "ftp_dense_simt"
        assert torch.equal(o_dense, o_bsr)
        assert torch.equal(c_d, c_b) and torch.equal(u_d, u_b)
    else:
        assert _instance(w) == "ftp_dense_tc"
        _hold(o_dense, None, o_bsr, False)
        _hold(c_d, u_d, o_bsr, True)


# ---------------------------------------------------------------------------
# kernels 1 and 2: the tensor-core instance (bf16 weights)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("K,N", [(40, 72), (203, 136), (1000, 264),
                                 (320, 520)])
@pytest.mark.parametrize("T", [1, 3, 4, 16, 32])
@pytest.mark.parametrize("M", [1, 4, 33, 100, 300])
def test_dense_tc_matches_plain(M, T, K, N, fuse):
    """The tensor-core instance at ragged shapes: K below one 64-deep step
    (one split), K = 203 over 4 splits (a K tail inside the last split, and
    word rows that are not 16-byte multiples), K = 1000 over 8 splits of
    128 (a tail inside the last), K = 320 over 4 splits of 128 (the last
    one empty); N below, across and off the 128-column tile (72, 136, 264,
    520); T from 1 (3 dead planes of the 4-row minimum) to 32; M on one
    m64 tile (1, 4 at T <= 16), on two warpgroups' 256 rows in one row
    tile, two and many (33, 100, 300 at T <= 4; more at larger T)."""
    dev = _cuda()
    rng = np.random.default_rng(7000 + M * 100 + T + K)
    packed, w = _mk(rng, T, M, K, N, density=0.2, w_density=0.5)
    wt = torch.from_numpy(w / 8).to(dev, torch.bfloat16)
    _check_dense(words_to_torch(packed, dev), wt, T, fuse, instance="tc")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 16, 32])
def test_dense_tc_deterministic_and_batch_invariant(T):
    """At 8 K splits (K = 2048, N = 512): two runs equal bit for bit, and a
    row computed alone (M = 1: one m64 tile), in a window of 4 (one tile at
    T <= 16, two warpgroups of two at 32) and in a 300-row call (two
    warpgroups of two, many row tiles) is equal bit for bit, for both
    kernels."""
    dev = _cuda()
    rng = np.random.default_rng(50 + T)
    packed, w = _mk(rng, T, 300, 2048, 512, density=0.2, w_density=0.5)
    a = words_to_torch(packed, dev)
    wt = torch.from_numpy(w / 32).to(dev, torch.bfloat16)
    assert ftp_spmm.dense_tc_shape(300, 2048, 512, T)["splits"] == 8
    assert ftp_spmm.dense_tc_shape(1, 2048, 512, T)["rows"] == 64
    assert ftp_spmm.dense_tc_shape(300, 2048, 512, T)["rows"] == 256
    for fuse in (True, False):
        runs = [ops.dispatch(a, wt, PACKED_DENSE, T, fuse_lif=fuse)
                for _ in range(2)]
        full = runs[0]
        if fuse:
            assert torch.equal(runs[0][0], runs[1][0])
            assert torch.equal(runs[0][1], runs[1][1])
        else:
            assert torch.equal(runs[0], runs[1])
        for row, window in ((0, 0), (17, 16), (299, 296)):
            for lo, hi in ((row, row + 1), (window, window + 4)):
                part = ops.dispatch(a[lo:hi].contiguous(), wt, PACKED_DENSE, T,
                                    fuse_lif=fuse)
                if fuse:
                    assert torch.equal(part[0], full[0][lo:hi])
                    assert torch.equal(part[1], full[1][lo:hi])
                else:
                    assert torch.equal(part, full[:, lo:hi])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 300])
def test_dense_tc_column_slab_with_parent_n_equals_whole(M):
    """Kernel 1 on column slabs of a (2048, 2048) weight, each launched with
    ``parent_n`` = 2048 (the whole weight's 4 splits of 512, where a slab of
    its own shape would take 8): equal to the same columns of the whole
    call bit for bit -- halves, a slab off the 128-column tile (256 .. 392)
    and a narrow tail slab."""
    dev = _cuda()
    rng = np.random.default_rng(80 + M)
    packed, w = _mk(rng, 4, M, 2048, 2048, density=0.2, w_density=0.5)
    a = words_to_torch(packed, dev)
    wt = torch.from_numpy(w / 32).to(dev, torch.bfloat16)
    whole = ftp_spmm.ftp_spmm(a, wt, 4)
    assert ftp_spmm.dense_tc_shape(M, 2048, 2048, 4)["splits"] == 4
    for lo, hi in ((0, 1024), (1024, 2048), (256, 392), (2040, 2048)):
        slab = wt[:, lo:hi].contiguous()
        assert _instance(slab) == "ftp_dense_tc"
        assert ftp_spmm.dense_tc_shape(M, 2048, hi - lo, 4)["splits"] == 8
        got = ftp_spmm.ftp_spmm(a, slab, 4, parent_n=2048)
        assert torch.equal(got, whole[:, :, lo:hi]), (lo, hi)


@pytest.mark.gpu
def test_dense_routing_by_dtype_and_alignment():
    """f32 weights, an N whose rows are not 16-byte multiples and an
    unaligned base take the SIMT instance (still held against the plain
    version); bf16 aligned weights the tensor-core one; asking for the
    tensor-core instance where it does not fit raises."""
    dev = _cuda()
    rng = np.random.default_rng(60)
    packed, w = _mk(rng, 4, 33, 256, 136, density=0.2, w_density=0.5)
    a = words_to_torch(packed, dev)
    w32 = torch.from_numpy(w / 8).to(dev)
    wbf = w32.to(torch.bfloat16)
    odd = wbf[:, :130].contiguous()
    shifted = torch.empty(256 * 136 + 1, dtype=torch.bfloat16, device=dev)
    unaligned = shifted[1:].view(256, 136)
    unaligned.copy_(wbf)
    assert unaligned.data_ptr() % 16 != 0
    for fuse in (True, False):
        _check_dense(a, w32, 4, fuse, instance="simt")
        _check_dense(a, odd, 4, fuse, instance="simt")
        _check_dense(a, unaligned, 4, fuse, instance="simt")
        _check_dense(a, wbf, 4, fuse, instance="tc")
    for w_bad in (w32, odd, unaligned):
        with pytest.raises(ValueError, match="tc instance"):
            ftp_spmm.ftp_spmm(a, w_bad, 4, instance="tc")
    # the SIMT instance on bf16 weights, asked for by name, for measurement
    got = ftp_spmm.ftp_spmm(a, wbf, 4, instance="simt")
    _hold(got, None, ftp_spmm.ftp_spmm_plain(a, wbf, 4), False)


@pytest.mark.gpu
def test_spiking_layers_on_cuda_words_launch_the_dense_kernels():
    """Infer mode without plans follows the words' device: on the card
    `spiking_linear_infer` launches kernel 2 once, `spiking_ffn_apply_packed`
    kernels 2 and 1 once each; their words and outputs hold against the
    plain versions on the same CUDA inputs."""
    from repro_torch.core.lif import rate_decode
    from repro_torch.core.snn_layers import (
        SpikingConfig,
        spiking_ffn_apply_packed,
        spiking_linear_infer,
    )

    dev = _cuda()
    rng = np.random.default_rng(41)
    packed, _ = _mk(rng, 4, 33, 256, 8, density=0.2)
    a = words_to_torch(packed, dev)
    w_in = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32)
                            / 8).to(dev)
    w_out = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)
                             / 22).to(dev)
    cfg = SpikingConfig(T=4)

    def words_hold(c, o):
        cw, _ = ref.lif_ref(o)
        assert not bool(((c != cw) & (_lif_margin(o) >= TOL)).any())

    before = ftp_spmm.launch_counts()
    c = spiking_linear_infer(a, w_in, cfg)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, ftp_spmm_fused_lif=before["ftp_spmm_fused_lif"] + 1,
        ftp_dense_simt=before["ftp_dense_simt"] + 1)  # f32 weights
    words_hold(c, ref.ftp_spmm_ref(a, w_in, 4))

    before = ftp_spmm.launch_counts()
    y, h = spiking_ffn_apply_packed({"w_in": w_in, "w_out": w_out},
                                    a.reshape(3, 11, 256), cfg)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, ftp_spmm_fused_lif=before["ftp_spmm_fused_lif"] + 1,
        ftp_spmm=before["ftp_spmm"] + 1,
        ftp_dense_simt=before["ftp_dense_simt"] + 2)
    h = h.reshape(33, 512)
    words_hold(h, ref.ftp_spmm_ref(a, w_in, 4))
    torch.testing.assert_close(
        y.reshape(33, 256), rate_decode(ref.ftp_spmm_ref(h, w_out, 4)),
        rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# kernels 5-7: flash attention forward, backward and the autograd Function
# ---------------------------------------------------------------------------
# Tolerances against the plain versions on the same CUDA inputs: f32 the
# reference tests' own (outputs and lse 3e-4, large logits 1e-3, gradients
# 3e-3: the kernels sum tile by tile with an online rescale, the plain
# version the whole row at once); bf16 outputs and gradients one bf16 step
# (1e-2 relative and absolute: both round an f32 value that differs in its
# last bits), lse (f32 from exact bf16 products) 3e-4.


def _flash_inputs(seed, BH, S, dh, dtype, skv=None, scale_q=1.0, dev="cuda"):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    skv = skv or S
    q = mk((BH, S, dh)) * scale_q
    return [t.to(dtype).to(dev) for t in (q, mk((BH, skv, dh)), mk((BH, skv, dh)),
                                          mk((BH, S, dh)))]


def _flash_tol(dtype, large=False):
    if dtype == torch.float32:
        return (1e-3, 1e-3) if large else (3e-4, 3e-4)
    return 1e-2, 1e-2


def _flash_hold(q, k, v, do, causal, window, large=False, instance=None):
    """Kernels 5 and 6 through the autograd Function vs the plain versions:
    one launch of each kernel counted, on the routed instance (bf16: `tc`,
    f32: SIMT) or on ``instance``."""
    from repro_torch.kernels import flash_mha as fm

    inst = instance or fm.flash_instance(q.dtype, q.shape[-1])
    before = fm.launch_counts()
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = fm.flash_mha(qs, ks, vs, causal, window, instance=instance)
    o.backward(do)
    torch.cuda.synchronize()
    moved = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_mha",
             f"flash_fwd_{inst}", f"flash_bwd_dq_{inst}", f"flash_bwd_dkv_{inst}")
    assert fm.launch_counts() == {n: c + (n in moved) for n, c in before.items()}
    o_p, lse_p = ref.flash_mha_fwd_plain(q, k, v, causal, window)
    _, lse = fm.flash_mha_fwd(q, k, v, causal=causal, window=window,
                              instance=instance)
    rtol, atol = _flash_tol(q.dtype, large)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), o_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, lse_p, rtol=1e-3 if large else 3e-4,
                               atol=1e-3 if large else 3e-4)
    grads = ref.flash_mha_bwd_plain(q, k, v, o_p, lse_p, do, causal, window)
    g_tol = 3e-3 if q.dtype == torch.float32 else 1e-2
    for got, want in zip((qs.grad, ks.grad, vs.grad), grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=g_tol,
                                   atol=g_tol)
    return o, lse, (qs.grad, ks.grad, vs.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,instance", [(torch.float32, "simt"),
                                            (torch.bfloat16, "tc"),
                                            (torch.bfloat16, "simt")])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 112, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_kernels_match_plain(causal, window, dh, dtype, instance):
    """Both instances at every template dh and at padded ones (16 -> 32,
    48 -> 64, 80 and 112 -> 128)."""
    _cuda()
    _flash_hold(*_flash_inputs(dh + window, 3, 256, dh, dtype), causal, window,
                instance=instance)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 80, 128, 160, 192, 256])
@pytest.mark.parametrize("S,skv,causal,window", [
    (256, 256, True, 0), (200, 200, True, 50), (128, 512, False, 0),
    (256, 64, True, 32)])
def test_flash_tc_matches_simt_on_bf16(S, skv, causal, window, dh):
    """The two instances on the same bf16 inputs: o, dq, dk, dv within one
    bf16 step (1e-2; `tc` rounds the backward's p and ds to bf16 for its
    products, SIMT keeps them f32), lse within 3e-4.  Both backward instances take `tc`'s
    o and lse (the same inputs)."""
    from repro_torch.kernels import flash_mha as fm

    _cuda()
    q, k, v, do = _flash_inputs(S + skv + dh, 2, S, dh, torch.bfloat16, skv=skv)
    kw = dict(causal=causal, window=window)
    o, lse = fm.flash_mha_fwd(q, k, v, instance="tc", **kw)
    out = {}
    for inst in ("tc", "simt"):
        out[inst] = (*fm.flash_mha_fwd(q, k, v, instance=inst, **kw),
                     *fm.flash_mha_bwd(q, k, v, o, lse, do, instance=inst, **kw))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(out["tc"], out["simt"])):
        tol = 3e-4 if i == 1 else 1e-2
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,skv,causal,window", [
    (128, 512, False, 0),   # cross attention, kv longer
    (512, 128, False, 0),   # kv shorter
    (200, 200, True, 50),   # ragged tiles, window inside a tile
    (256, 64, True, 32),    # rows >= 95 see no key (the reference's junk average)
])
def test_flash_kernels_cross_ragged_and_degenerate(S, skv, causal, window, dtype):
    """bf16 runs the tensor-core instance, f32 SIMT (counted)."""
    _cuda()
    _flash_hold(*_flash_inputs(S + skv, 2, S, 64, dtype, skv=skv), causal,
                window)


@pytest.mark.gpu
def test_flash_kernels_large_logits_and_first_row():
    _cuda()
    q, k, v, do = _flash_inputs(11, 1, 256, 64, torch.float32, scale_q=30.0)
    _flash_hold(q, k, v, do, True, 0, large=True)
    q, k, v, do = _flash_inputs(13, 1, 128, 32, torch.float32)
    o, _, _ = _flash_hold(q, k, v, do, True, 0)
    torch.testing.assert_close(o[:, 0], v[:, 0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("instance", ["tc", "simt"])
def test_flash_kernels_deterministic_and_rows_batch_invariant(instance, dh):
    """No atomics: two runs equal bit for bit, and a slice of the BH rows
    launched alone equals those rows of the full launch (bf16 inputs, on
    each instance; dh 256 on the wide `tc` kernels)."""
    from repro_torch.kernels import flash_mha as fm

    _cuda()
    q, k, v, do = _flash_inputs(17, 6, 384, dh, torch.bfloat16)
    kw = dict(window=128, bq=128, bk=128, instance=instance)

    def both(q, k, v, do):
        o, lse = fm.flash_mha_fwd(q, k, v, **kw)
        return (o, lse, *fm.flash_mha_bwd(q, k, v, o, lse, do, **kw))

    fm.reset_launch_counts()
    runs = [both(q, k, v, do) for _ in range(2)]
    assert fm.launch_counts()[f"flash_fwd_{instance}"] == 2
    assert fm.launch_counts()[f"flash_bwd_dkv_{instance}"] == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    part = both(*(t[2:4].contiguous() for t in (q, k, v, do)))
    for a, b in zip(part, runs[0]):
        assert torch.equal(a, b[2:4])


@pytest.mark.gpu
def test_flash_tc_copies_an_unaligned_base():
    """bf16 views whose base is 2 bytes off a 16-byte boundary (the `tc`
    instance copies rows 16 bytes at a time) give the aligned inputs'
    outputs, bit for bit."""
    from repro_torch.kernels import flash_mha as fm

    _cuda()
    q, k, v, do = _flash_inputs(19, 2, 128, 64, torch.bfloat16)

    def shifted(t):
        view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        view = view.view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    qs, ks, vs, dos = map(shifted, (q, k, v, do))
    o, lse = fm.flash_mha_fwd(q, k, v)
    o2, lse2 = fm.flash_mha_fwd(qs, ks, vs)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(fm.flash_mha_bwd(q, k, v, o, lse, do),
                    fm.flash_mha_bwd(qs, ks, vs, o, lse, dos)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,instance", [(torch.float32, "simt"),
                                            (torch.bfloat16, "tc"),
                                            (torch.bfloat16, "simt")])
@pytest.mark.parametrize("dh", [160, 192, 256])
@pytest.mark.parametrize("S,skv,causal,window", [
    (256, 256, True, 0), (200, 200, True, 50), (128, 512, False, 0),
    (256, 64, True, 32)])
def test_flash_wide_instance_matches_plain(S, skv, causal, window, dh, dtype,
                                           instance):
    """dh 192 and 256, and 160 padded to 192: bf16 on the wide `tc` kernels
    (two warpgroups a tile) and on SIMT (32-row tiles), f32 on SIMT, against
    the plain versions, each counted on the instance it asked for; two runs
    equal bit for bit."""
    from repro_torch.kernels import flash_mha as fm

    _cuda()
    q, k, v, do = _flash_inputs(S + skv + dh, 2, S, dh, dtype, skv=skv)
    assert fm.flash_instance(dtype, dh) == (
        "tc" if dtype == torch.bfloat16 else "simt")
    o, lse, grads = _flash_hold(q, k, v, do, causal, window, instance=instance)
    o2, lse2, grads2 = _flash_hold(q, k, v, do, causal, window,
                                   instance=instance)
    for a, b in zip((o, lse, *grads), (o2, lse2, *grads2)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_do_not_take():
    """dh 257 (above the largest template, 256) and f16 are refused, and so
    is the tensor-core instance on f32 inputs; bf16 at dh 192 runs it."""
    from repro_torch.kernels import flash_mha as fm

    _cuda()
    q, k, v, _ = _flash_inputs(1, 1, 128, 257, torch.float32)
    with pytest.raises(ValueError, match="dh=257"):
        fm.flash_mha_fwd(q, k, v)
    q, k, v, _ = _flash_inputs(1, 1, 128, 192, torch.bfloat16)
    o, _ = fm.flash_mha_fwd(q, k, v, instance="tc")
    assert o.shape == q.shape and torch.isfinite(o.float()).all()
    q, k, v, _ = _flash_inputs(1, 1, 128, 64, torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fm.flash_mha_fwd(q, k, v)
    q, k, v, _ = _flash_inputs(1, 1, 128, 64, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fm.flash_mha_fwd(q, k, v, instance="tc")


# ---------------------------------------------------------------------------
# the training step on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("spiking", [False, True])
def test_train_step_on_card_matches_cpu(spiking):
    """Three smoke-size train steps (constant lr 3e-3) from the same state on
    the card and on the CPU: per-step loss within 2e-3 relative, grad norm
    within 5e-2, final params within 0.15 of the norm of their change (the
    bounds tests/test_torch_train.py holds the port to against the jitted
    JAX reference: other GEMM orders round bf16 values the other way, and
    Adam turns tiny gradient differences into full-size steps); pruned FFN
    weights exactly 0 on both."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant, get_optimizer
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    dev = _cuda()
    extra = dict(spiking_ffn=True, spiking_weight_density=0.3) if spiking else {}
    cfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                              d_model=64, d_ff=128, **extra)
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4)
    step = make_train_step(model, optimizer=get_optimizer("adamw", constant(3e-3)))
    cpu = init_train_state(model, 0, optimizer=get_optimizer("adamw", constant(3e-3)),
                           device="cpu")
    start = [t.clone() for t in tree_leaves(cpu["params"])]
    card = tree_map(lambda t: t.to(dev), cpu)
    for s in range(3):
        cpu, mc = step(cpu, batch_to_torch(data.batch(s), "cpu"))
        card, mg = step(card, batch_to_torch(data.batch(s), dev))
        torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=2e-3, atol=0)
        torch.testing.assert_close(mg["grad_norm"].cpu(), mc["grad_norm"],
                                   rtol=5e-2, atol=0)
    got = [t.cpu().double() for t in tree_leaves(card["params"])]
    want = [t.double() for t in tree_leaves(cpu["params"])]
    diff = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want)) ** 0.5
    moved = sum(float(((w - s0.double()) ** 2).sum())
                for w, s0 in zip(want, start)) ** 0.5
    assert diff <= 0.15 * moved, (diff, moved)
    for (path, w), s0 in zip(tree_paths(card["params"]), start):
        if spiking and path.endswith(("mlp/wu", "mlp/wd")):
            assert not bool(w.cpu()[s0 == 0].any()), path


# ---------------------------------------------------------------------------
# serve features on the card: pipelined executor, paged cache, prefix reuse
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_model():
    """The smoke llama3.2-1b with dual-sparse spiking FFNs, params drawn on
    the card (the engine's kernels: 3, through its plans)."""
    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model

    dev = _cuda()
    cfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                       weight_density=0.3)
    model = build_model(cfg)
    return cfg, model, model.init(0, device=dev)


def _serve_prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _engine(serve_model, **kw):
    from repro_torch.serve import Engine

    cfg, model, params = serve_model
    pol = ExecutionPolicy.for_arch(cfg, execution=kw.pop("execution", "sync"),
                                   paging=kw.pop("paging", None))
    return Engine(model, params, policy=pol, **kw)


def _same_logits(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert len(ta) == len(tb)
        assert all(np.array_equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serve_pipelined_equals_sync_bitwise(serve_model, depth):
    """Pipelining reorders host work only: the same tokens and captured
    logits as the sync executor, bit for bit, through kernel 3."""
    prompts = _serve_prompts(serve_model[0].vocab, [8, 8, 8], seed=depth)
    kw = dict(max_len=16, max_slots=3, capture_logits=True)
    sync = _engine(serve_model, **kw)
    want = sync.generate_batch(prompts, 6)
    pipe = _engine(serve_model, execution="pipelined", pipeline_depth=depth,
                   **kw)
    before = ftp_spmm.launch_counts()["ftp_bsr"]
    got = pipe.generate_batch(prompts, 6)
    assert ftp_spmm.launch_counts()["ftp_bsr"] > before
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    _same_logits(sync.drain_logit_traces(), pipe.drain_logit_traces())


def _staggered_serve(engine, prompts, gens, arrivals):
    tickets, i, step = [], 0, 0
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            tickets.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    return [np.asarray(engine.results[t.rid].generated) for t in tickets]


@pytest.mark.gpu
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_serve_paged_equals_dense_bitwise(serve_model, execution):
    """Merges and retires under paging move no page, and the gathered views
    give the dense layout's tokens and logits bit for bit."""
    from repro_torch.serve import paged

    prompts = _serve_prompts(serve_model[0].vocab, [8, 8, 9, 10])
    gens, arrivals = [6, 4, 5, 4], [0, 0, 1, 2]
    kw = dict(max_len=32, max_slots=8, capture_logits=True,
              execution=execution)
    dense = _engine(serve_model, **kw)
    want = _staggered_serve(dense, prompts, gens, arrivals)
    pe = _engine(serve_model, paging=paged(8), prefix_cache=False, **kw)
    got = _staggered_serve(pe, prompts, gens, arrivals)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    _same_logits(dense.drain_logit_traces(), pe.drain_logit_traces())
    assert pe.metrics.n_merges > 0 and pe.metrics.n_page_moves == 0
    s = pe.store.summary()
    assert s["seq_pages_free"] == s["seq_pages_total"]


@pytest.mark.gpu
def test_serve_prefix_hits_token_identical(serve_model):
    """Repeated prompts are admitted from the radix index (no prefill) and
    give the cold serve's tokens."""
    from repro_torch.serve import paged

    prompts = _serve_prompts(serve_model[0].vocab, [8, 12])
    pe = _engine(serve_model, paging=paged(8), max_len=32, max_slots=8)
    cold = pe.generate_batch(prompts, 5)
    prefills = pe.metrics.n_prefill_batches
    tickets = [pe.submit(p, 5) for p in prompts]
    assert all(t.prefix_hit for t in tickets)
    out = pe.run()
    assert pe.metrics.n_prefill_batches == prefills
    assert pe.metrics.n_prefix_hits == 2 and pe.metrics.n_page_moves > 0
    for t, c in zip(tickets, cold):
        np.testing.assert_array_equal(out[t.rid], c)


@pytest.mark.gpu
@pytest.mark.parametrize("paging", [None, 8])
def test_serve_pipelined_decode_makes_no_host_sync(serve_model, paging):
    """The decode and encode stages of a pipelined step (the decode
    dispatch, its token and logit copies, the spike encode) run under
    set_sync_debug_mode('error'): any host wait there raises."""
    from repro_torch.serve import executor as ex_mod
    from repro_torch.serve import paged

    engine = _engine(serve_model, execution="pipelined", max_len=24,
                     max_slots=4, capture_logits=True,
                     paging=paged(paging) if paging else None)
    engine.generate_batch(_serve_prompts(serve_model[0].vocab, [8], seed=9), 3)
    ex, seen = engine.executor, []

    def strict(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                seen.append(fn.__name__)
        return run

    launch = ex_mod.PendingStep.__dict__["launch"]
    ex._dispatch_decode, ex.encode = strict(ex._dispatch_decode), strict(ex.encode)
    ex_mod.PendingStep.launch = staticmethod(strict(ex_mod.PendingStep.launch))
    try:
        engine.metrics.reset()
        engine.generate_batch(_serve_prompts(serve_model[0].vocab, [8] * 3), 8)
        torch.cuda.synchronize()
    finally:
        del ex._dispatch_decode, ex.encode
        ex_mod.PendingStep.launch = launch
    n = engine.metrics.n_decode_batches
    assert n == 7 and len(seen) == 3 * n
    # controls: the mode (a prototype) sees the waits the executor avoids
    for wait in (lambda: torch.tensor([1, 2], device="cuda"),
                 lambda: torch.ones(2, device="cuda").cpu()):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError, match="synchroniz"):
                wait()
        finally:
            torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# decode windows on the card: speculative decoding and event streams
# ---------------------------------------------------------------------------

# Logits of a row computed inside a wider window against the same row alone:
# the FTP kernels give it bit for bit; cuBLAS may pick another algorithm for
# another M.  The FTP gate's scale.
WINDOW_LOGIT_TOL = 1e-2


def _window_gate(want_toks, want_logits, got_toks, got_logits):
    """Held: logits within WINDOW_LOGIT_TOL of the single-position serve's
    (up to and including each request's first differing token: the contexts
    differ after it), and a token may differ only where the single-position
    serve's top two logits lie within 2 x the measured drift (each of the
    two can move by the drift).  A drift of 0 makes this bit for bit.
    Returns (drift, flips)."""
    drift, flips = 0.0, 0
    for wt, gt, wl, gl in zip(want_toks, got_toks, want_logits, got_logits):
        wt, gt = np.asarray(wt), np.asarray(gt)
        assert wt.shape == gt.shape and len(wl) == len(gl) == len(wt)
        diff = np.nonzero(wt != gt)[0]
        last = int(diff[0]) if diff.size else len(wt) - 1
        for j in range(last + 1):
            drift = max(drift, float(np.abs(np.asarray(gl[j])
                                            - np.asarray(wl[j])).max()))
        if diff.size:
            top2 = np.sort(np.asarray(wl[last]))[-2:]
            flips += 1
            assert top2[1] - top2[0] <= 2 * drift, (last, top2, drift)
    assert drift <= WINDOW_LOGIT_TOL, drift
    return drift, flips


def _spec_engine(serve_model, **kw):
    from repro_torch.serve import Engine, draft

    cfg, model, params = serve_model
    fd = ExecutionPolicy.for_arch(cfg, spike_format="float",
                                  weight_sparsity="dense")
    pol = ExecutionPolicy.for_arch(cfg, speculation=draft(fd, k=4), **kw)
    return Engine(model, params, policy=pol, capture_logits=True, max_len=32,
                  max_slots=4)


@pytest.mark.gpu
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_serve_speculative_on_card(serve_model, execution):
    """A float-draft k = 4 speculative serve through kernel 3 on the card:
    every proposal adjudicated once, and the tokens and logits of the
    non-speculative serve within the window gate."""
    prompts = _serve_prompts(serve_model[0].vocab, [8, 8, 8, 8], seed=21)
    base = _engine(serve_model, max_len=32, max_slots=4, capture_logits=True)
    want = base.generate_batch(prompts, 12)
    spec = _spec_engine(serve_model, execution=execution)
    before = ftp_spmm.launch_counts()["ftp_bsr"]
    got = spec.generate_batch(prompts, 12)
    assert ftp_spmm.launch_counts()["ftp_bsr"] > before
    _window_gate(want, base.drain_logit_traces(), got,
                 spec.drain_logit_traces())
    s = spec.summary()
    assert s["speculative_rounds"] > 0
    assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]


@pytest.mark.gpu
def test_serve_speculative_round_makes_no_host_sync(serve_model):
    """The propose, the verify decode and the rewinds of a round run under
    set_sync_debug_mode('error'); the round's one host read is its
    sample_sync copy.  A read inside the propose raises (the control)."""
    spec = _spec_engine(serve_model)
    spec.capture_logits = False
    prompts = _serve_prompts(serve_model[0].vocab, [8] * 4, seed=22)
    spec.generate_batch(prompts[:1], 6)
    seen = []

    def strict(fn, read=False):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
                if read:
                    out[0].cpu()
                return out
            finally:
                torch.cuda.set_sync_debug_mode("default")
                seen.append(fn.__name__)
        return run

    names = ("dispatch_propose", "dispatch_decode", "rewind_cache")
    for name in names:
        setattr(spec, name, strict(getattr(spec, name)))
    try:
        spec.generate_batch(prompts, 12)
        torch.cuda.synchronize()
        assert {n for n in names} <= set(seen)
        spec.dispatch_propose = strict(type(spec).dispatch_propose.__get__(spec),
                                       read=True)
        with pytest.raises(RuntimeError, match="synchroniz"):
            spec.generate_batch(prompts[:1], 6)
    finally:
        for name in names:
            delattr(spec, name)


@pytest.mark.gpu
@pytest.mark.parametrize("paging", [None, 8])
def test_serve_stream_on_card(serve_model, paging):
    """A stream ingested frame by frame on the card against the same frame
    tokens submitted as one prompt, within the window gate (the prompt's
    prefill against one position at a time)."""
    from repro_torch.data.events import moving_blob_events, split_into_windows
    from repro_torch.serve import EventStream, StreamSession, paged

    cfg = serve_model[0]
    kw = dict(max_len=32, max_slots=4, capture_logits=True,
              paging=paged(paging) if paging else None)
    engine = _engine(serve_model, **kw)
    events = moving_blob_events(16, height=8, width=8, seed=3, silent=(5,))
    stream = EventStream(1000)
    session = StreamSession(stream, height=8, width=8, T=cfg.spiking_T,
                            vocab=cfg.vocab)
    ticket = engine.submit_stream(session, 8)
    for chunk in split_into_windows(events, 16, 1000):
        stream.push(chunk)
        engine.step()
    stream.close()
    got = engine.run()[ticket.rid]
    mono = _engine(serve_model, **kw)
    want = mono.generate_batch([session.prompt_tokens()], 8)[0]
    _window_gate([want], mono.drain_logit_traces(), [got],
                 engine.drain_logit_traces())
    assert engine.metrics.n_stream_windows == 16


@pytest.mark.gpu
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging", [None, 8])
def test_serve_drain_resume_on_card(serve_model, execution, paging, tmp_path):
    """Drain after 2 steps within a 2-step grace, save, load, resume: every
    request's tokens equal the undisturbed serve's on the card, the ledger
    held every in-flight request."""
    from repro_torch.ft import PreemptionHandler
    from repro_torch.serve import Engine, Handoff, paged

    cfg, model, params = serve_model
    pol = ExecutionPolicy.for_arch(cfg, execution=execution,
                                   paging=paged(paging) if paging else None)
    prompts = _serve_prompts(cfg.vocab, [8] * 5, seed=31)
    want = Engine(model, params, max_len=16, max_slots=2, policy=pol
                  ).generate_batch(prompts, 8)
    h = PreemptionHandler(signals=())
    victim = Engine(model, params, max_len=16, max_slots=2, policy=pol,
                    preemption=h)
    tickets = [victim.submit(p, 8) for p in prompts]
    victim.step()
    victim.step()
    h.trigger()
    handoff = victim.drain(step_budget=2)
    assert handoff.counts()["tokens_in_flight"] > 0
    handoff.save(str(tmp_path))
    succ = Engine.resume(model, params, Handoff.load(str(tmp_path)), policy=pol)
    inflight = {r.rid for r in handoff.requests if r.state == "inflight"}
    assert set(succ._resume_expect) == inflight
    out = succ.run()
    assert succ._resume_expect == {}
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(out[t.rid], w)


@pytest.mark.gpu
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_serve_drain_discards_half_verified_speculative_progress(serve_model,
                                                                  execution):
    """A speculative serve on the card drained mid-flight hands off only
    verified tokens (a prefix of the non-speculative serve's), and the
    successor ends every request equal to it."""
    from repro_torch.serve import Engine

    cfg = serve_model[0]
    prompts = _serve_prompts(cfg.vocab, [8, 12, 8, 8], seed=23)
    base = _engine(serve_model, max_len=32, max_slots=4)
    want = base.generate_batch(prompts, 12)
    spec = _spec_engine(serve_model, execution=execution)
    spec.capture_logits = False
    reqs = [spec.submit(p, 12) for p in prompts]
    spec.step()
    spec.step()
    handoff = spec.drain(step_budget=0)
    inflight = [hr for hr in handoff.requests if hr.state == "inflight"]
    assert inflight
    by_rid = {r.rid: i for i, r in enumerate(reqs)}
    for hr in inflight:
        w = want[by_rid[hr.rid]]
        np.testing.assert_array_equal(hr.generated, w[: len(hr.generated)])
    succ = Engine.resume(serve_model[1], serve_model[2], handoff,
                         policy=spec.policy)
    out = succ.run()
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], want[by_rid[r.rid]])


@pytest.mark.gpu
def test_serve_drain_hands_off_mid_ingest_stream(serve_model):
    """Draining with a stream still ingesting on the card ends, and hands
    the frames completed so far off as the successor's prompt."""
    from repro_torch.data.events import moving_blob_events, split_into_windows
    from repro_torch.serve import EventStream, StreamSession

    cfg = serve_model[0]
    engine = _engine(serve_model, max_len=24)
    events = moving_blob_events(2, height=8, width=8, window_us=1000,
                                events_per_window=16, seed=11)
    chunks = split_into_windows(events, 2, 1000)
    stream = EventStream(1000)
    session = StreamSession(stream, height=8, width=8, T=cfg.spiking_T,
                            vocab=cfg.vocab)
    ticket = engine.submit_stream(session, 6)
    stream.push(chunks[0])
    stream.push(chunks[1])
    engine.step()
    assert engine.cohorts and engine.cohorts[0].stream is session
    handoff = engine.drain()
    [hr] = [r for r in handoff.requests if r.rid == ticket.rid]
    assert hr.state == "inflight" and hr.generated.size == 0
    np.testing.assert_array_equal(
        hr.prompt, session.prompt_tokens()[: hr.prompt.shape[0]])
    assert engine.metrics.n_drained == 1 and not engine.cohorts


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mean_square", "matmul"])
def test_row_blocks_row_invariant_on_card(op):
    """`layers.row_blocks` at the serving forward's widths on the card: a
    row's rmsnorm mean or f32 unembed logits do not depend on how many rows
    share the call (the plain ops do not hold this on the card)."""
    from repro_torch.models.layers import ROW_BLOCK, _mean_square, row_blocks

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2 * ROW_BLOCK + 3, 2048, generator=g, device=dev)
    args = ((torch.randn(2048, 8192, generator=g, device=dev),)
            if op == "matmul" else ())
    fn = torch.matmul if op == "matmul" else _mean_square
    full = row_blocks(fn, x, *args)
    for n in (1, 4, 20, ROW_BLOCK, ROW_BLOCK + 1):
        assert torch.equal(row_blocks(fn, x[:n], *args), full[:n]), n


# ---------------------------------------------------------------------------
# the recurrent families (rwkv6, zamba2) at smoke size on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["rwkv6_1_6b", "zamba2_7b"])
def recurrent_model(request):
    """A recurrent arch's smoke variant, params drawn on the CPU (the same
    params serve on the card and on the CPU)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.registry import build_model

    _cuda()
    cfg = smoke_variant(get_config(request.param))
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu")


def _recurrent_serve(recurrent_model, prompts, gens, device="cuda", **kw):
    """(tokens in submit order, logit traces in submit order) of one serve
    of ``prompts`` with budgets ``gens``."""
    from repro_torch.serve import Engine

    cfg, model, params = recurrent_model
    pol = ExecutionPolicy.for_arch(cfg, execution=kw.pop("execution", "sync"),
                                   paging=kw.pop("paging", None))
    eng = Engine(model, params, policy=pol, capture_logits=True, device=device,
                 **kw)
    tickets = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    return ([out[t.rid] for t in tickets],
            [np.stack(eng.logit_traces[t.rid]) for t in tickets])


@pytest.mark.gpu
def test_recurrent_serve_on_card_matches_cpu(recurrent_model):
    """The same requests served on the card and on the CPU (zamba2's
    prompt of 16 takes the SSD chunked form at ssm_chunk 8, its 13 the
    per-step scan): the same tokens, logits within 0.25."""
    prompts = _serve_prompts(recurrent_model[0].vocab, [16, 16, 13], seed=4)
    gens = [6, 6, 6]
    card = _recurrent_serve(recurrent_model, prompts, gens, max_len=24,
                            max_slots=3)
    cpu = _recurrent_serve(recurrent_model, prompts, gens, device="cpu",
                           max_len=24, max_slots=3)
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(card[1], cpu[1]):
        assert np.abs(a - b).max() <= 0.25


@pytest.mark.gpu
def test_recurrent_lone_request_equals_cohort_on_card(recurrent_model):
    """Row invariance on the card: a request served alone emits the tokens
    and logits it emits in a cohort of four, bit for bit."""
    prompts = _serve_prompts(recurrent_model[0].vocab, [8] * 4, seed=5)
    kw = dict(max_len=16, max_slots=4)
    cohort = _recurrent_serve(recurrent_model, prompts, [6] * 4, **kw)
    lone = _recurrent_serve(recurrent_model, prompts[2:3], [6], **kw)
    np.testing.assert_array_equal(lone[0][0], cohort[0][2])
    assert np.array_equal(lone[1][0], cohort[1][2])


@pytest.mark.gpu
@pytest.mark.parametrize("execution,paging", [("pipelined", False),
                                              ("sync", True),
                                              ("pipelined", True)])
def test_recurrent_serve_features_equal_sync_dense_on_card(recurrent_model,
                                                           execution, paging):
    """Staggered continuous batching (a merge, retires) under pipelined
    execution and paged state: the sync dense serve's tokens and logits bit
    for bit."""
    from repro_torch.serve import Engine, paged

    cfg, model, params = recurrent_model
    prompts = _serve_prompts(cfg.vocab, [8, 9, 12, 8], seed=6)
    gens, arrivals = [4, 5, 4, 6], [0, 1, 1, 2]

    def serve(execution, paging):
        pol = ExecutionPolicy.for_arch(cfg, execution=execution,
                                       paging=paged(8) if paging else None)
        eng = Engine(model, params, policy=pol, max_len=32, max_slots=4,
                     capture_logits=True, device="cuda")
        got = _staggered_serve(eng, prompts, gens, arrivals)
        return got, eng.drain_logit_traces(), eng.metrics.n_merges

    want, want_logits, _ = serve("sync", False)
    got, logits, merges = serve(execution, paging)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    _same_logits(want_logits, logits)
    assert merges >= 1


# ---------------------------------------------------------------------------
# the MoE families (phi3.5-moe, mixtral with its ring cache) at smoke size
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["phi3_5_moe", "mixtral_8x22b"])
def moe_model(request):
    """An MoE arch's smoke variant, params drawn on the CPU (the same params
    run on the card and on the CPU)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.registry import build_model

    _cuda()
    cfg = smoke_variant(get_config(request.param))
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu")


@pytest.mark.gpu
def test_moe_apply_on_card_matches_cpu(moe_model):
    """One layer's `moe_apply` on the same bf16 inputs, prefill-shaped (2 x
    16) and decode-shaped (4 x 1, capacity 2 of 4 experts): the same expert
    ids and kept mask (the f32 router of the two devices sums in other
    orders: only a top-k gap below 1e-4 may route otherwise, and none is
    met here), outputs within 2^-7 (a bf16 ulp at 1: the two devices' bf16
    ``bmm`` sum in other orders and may round apart), the load-balancing term
    within 1e-5."""
    from repro_torch.models import layers

    cfg, _, params = moe_model
    p = params["layers"][0]["moe"]
    pc = {k: v.cuda() for k, v in p.items()}
    gen = torch.Generator().manual_seed(3)
    for B, S in ((2, 16), (4, 1)):
        x = torch.randn(B, S, cfg.d_model, generator=gen).bfloat16()
        want, want_aux = layers.moe_apply(p, x, cfg)
        got, aux = layers.moe_apply(pc, x.cuda(), cfg)
        r_cpu = layers.moe_route(p["router"], x.reshape(B * S, -1), cfg)
        r_gpu = layers.moe_route(pc["router"], x.cuda().reshape(B * S, -1), cfg)
        for a, b in zip(r_gpu[2:5], r_cpu[2:5]):
            assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(got.cpu(), want, rtol=2**-7, atol=2**-7)
        assert abs(float(aux) - float(want_aux)) <= 1e-5


def _moe_serve(moe_model, prompts, gens, arrivals, device="cuda", **kw):
    """(tokens, logit traces) of one staggered serve, in submit order."""
    from repro_torch.serve import Engine, paged

    cfg, model, params = moe_model
    pol = ExecutionPolicy.for_arch(
        cfg, execution=kw.pop("execution", "sync"),
        paging=paged(8) if kw.pop("paging", False) else None)
    eng = Engine(model, params, policy=pol, capture_logits=True, device=device,
                 **kw)
    got = _staggered_serve(eng, prompts, gens, arrivals)
    assert eng.metrics.n_merges == 0
    return got, eng.drain_logit_traces()


# prompts of distinct lengths (no shared prefill: capacity routing couples a
# batch's rows); mixtral's window is 16 at smoke size, so its 32-token
# prompt runs through the temporary full-length cache and its 12-token one
# wraps the ring
MOE_PROMPTS, MOE_GENS, MOE_ARRIVALS = [32, 12, 9], [8, 8, 6], [0, 1, 1]


@pytest.mark.gpu
def test_moe_serve_on_card_matches_cpu(moe_model):
    """The same requests served on the card and on the CPU: the same tokens,
    logits within 0.25."""
    prompts = _serve_prompts(moe_model[0].vocab, MOE_PROMPTS, seed=7)
    card = _moe_serve(moe_model, prompts, MOE_GENS, MOE_ARRIVALS, max_len=40,
                      max_slots=3)
    cpu = _moe_serve(moe_model, prompts, MOE_GENS, MOE_ARRIVALS, device="cpu",
                     max_len=40, max_slots=3)
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(card[1], cpu[1]):
        assert np.abs(np.stack(a) - np.stack(b)).max() <= 0.25


@pytest.mark.gpu
@pytest.mark.parametrize("execution,paging", [("pipelined", False),
                                              ("sync", True),
                                              ("pipelined", True)])
def test_moe_serve_features_equal_sync_dense_on_card(moe_model, execution,
                                                     paging):
    """Pipelined execution and the paged cache (mixtral's ring in pages of
    8) on the card: the sync dense serve's tokens and logits bit for bit."""
    prompts = _serve_prompts(moe_model[0].vocab, MOE_PROMPTS, seed=8)
    kw = dict(max_len=40, max_slots=3)
    want, want_logits = _moe_serve(moe_model, prompts, MOE_GENS, MOE_ARRIVALS,
                                   **kw)
    got, logits = _moe_serve(moe_model, prompts, MOE_GENS, MOE_ARRIVALS,
                             execution=execution, paging=paging, **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    _same_logits(want_logits, logits)


# ---------------------------------------------------------------------------
# the op counter (roofline.op_stats): the card counts what the CPU counts
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_counted_stats_on_card_equal_cpu(kind):
    """A smoke llama cell (`launch.specs.build_cell`) counted on the card and
    on the CPU: the same flops, flops by dtype, bytes and op count (the
    counts read shapes only; the kernels are not on this path)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.specs import build_cell
    from repro_torch.roofline import count

    dev = _cuda()
    cfg = smoke_variant(get_config("llama3_2_1b"))
    cell = ShapeCell(kind, 64, 4, kind)
    got = {}
    for d in (dev, "cpu"):
        c = build_cell("llama3_2_1b", kind, cfg=cfg, cell=cell, device=d)
        st = count(c.fn, *c.args)
        got[str(d)] = (st.flops, st.flops_by_dtype, st.bytes_accessed, st.n_ops)
    assert got["cuda"] == got["cpu"] and got["cpu"][0] > 0


@pytest.mark.gpu
def test_counted_kernel_3_on_card_equals_cpu():
    """Kernel 3 counted at its entry by its work formula on the same inputs
    on the card (it launches) and on the CPU (its plain version runs): equal
    stats, one call each, and the card's call is one launch."""
    from repro_torch.roofline import count

    dev = _cuda()
    a, w = _mk(np.random.default_rng(0), 4, 16, 256, 256, density=0.3, w_density=0.3)
    a, w = words_to_torch(a), torch.as_tensor(w).to(torch.bfloat16)
    got = {}
    for d in (dev, torch.device("cpu")):
        plan, words = build_weight_plan(w.to(d)), a.to(d)
        ftp_spmm.reset_launch_counts()
        st = count(lambda: ops.dispatch(words, plan, PACKED_DUAL, 4, n_out=256,
                                        fuse_lif=True))
        got[d.type] = (st.kernels, st.flops, st.bytes_accessed, st.n_ops)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert ftp_spmm.launch_counts()["ftp_bsr"] == 1
    assert got["cuda"] == got["cpu"]
    assert got["cpu"][0]["ftp_bsr"]["calls"] == 1


# ---------------------------------------------------------------------------
# the serve mesh: logical devices on the card (launch.mesh)
# ---------------------------------------------------------------------------

def _card_mesh(spec, n=4):
    from repro_torch.launch.mesh import LogicalDevice
    from repro_torch.serve.sharding import make_serve_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    return make_serve_mesh(spec, devices=[LogicalDevice(i, dev)
                                          for i in range(n)])


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("fuse", [True, False])
def test_mesh_bsr_slabs_equal_unsharded_on_card(shards, fuse):
    """llama3.2-1b's W_in geometry (2048 x 8192 bf16, 128 x 128 blocks,
    density 0.3): the column slabs, each launched with the whole plan's
    tensor-core shape, equal the unsharded launch bit for bit, every slab
    launch on the tc instance, data x model launches a call."""
    from repro_torch.core.snn_layers import prune_by_magnitude
    from repro_torch.kernels.join_plan import (
        build_sharded_weight_plan,
        shard_plan,
    )
    from repro_torch.serve.policy import Placement

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(shards)
    w = torch.randn(2048, 8192, generator=g, device=dev) / 45.0
    w = prune_by_magnitude(w, 0.3, block=(128, 128)).to(torch.bfloat16)
    a = torch.randint(0, 16, (16, 2048), generator=g, device=dev,
                      dtype=torch.int32)
    whole = build_weight_plan(w)
    sp = shard_plan(build_sharded_weight_plan(w, shards), shards)
    want = ops.dispatch(a, whole, PACKED_DUAL, 4, n_out=8192, fuse_lif=fuse)
    mesh = _card_mesh(f"data=2,model={shards}", 2 * shards)
    pol = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                          placement=Placement(mesh=mesh))
    ftp_spmm.reset_launch_counts()
    got = ops.dispatch(a, sp, pol, 4, n_out=8192, fuse_lif=fuse)
    n = ftp_spmm.launch_counts()
    assert n["ftp_bsr"] == n["ftp_bsr_tc"] == 2 * shards
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_vocab_slabs_equal_blocks_on_card(shards):
    """llama3.2-1b's f32 unembedding (2048 x 128256) over its fixed column
    blocks: dealt over ``shards`` model shards (and 2 data groups) the
    logits equal the unsharded blocks' bit for bit, since every shard makes
    the same per-block products."""
    from repro_torch.models import layers

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(shards)
    blocks = layers.vocab_blocks(
        torch.randn(2048, 128256, generator=g, device=dev) / 45.0)
    x = torch.randn(6, 2048, generator=g, device=dev)
    want = layers.vocab_logits(x, blocks)
    slabs = layers.VocabSlabs(blocks, shards)
    with ops.serve_mesh_scope(_card_mesh(f"data=2,model={shards}",
                                         2 * shards)):
        got = layers.vocab_logits(x, slabs)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_mesh_dense_slabs_equal_unsharded_on_card():
    """Kernel 1 on llama3.2-1b's W_out geometry (8192 x 2048 bf16) as
    model=2 column slabs, each launched with the whole weight's shape:
    equal to the unsharded launch bit for bit."""
    from repro_torch.serve.policy import Placement

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    w = (torch.randn(8192, 2048, generator=g, device=dev) / 90.0).to(
        torch.bfloat16)
    a = torch.randint(0, 16, (16, 8192), generator=g, device=dev,
                      dtype=torch.int32)
    want = ops.dispatch(a, w, PACKED_DENSE, 4)
    pol = ExecutionPolicy(spike_format="packed",
                          placement=Placement(mesh=_card_mesh("data=2,model=2")))
    ftp_spmm.reset_launch_counts()
    got = ops.dispatch(a, w, pol, 4)
    n = ftp_spmm.launch_counts()
    assert n["ftp_spmm"] == n["ftp_dense_tc"] == 4
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["data=2,model=2", "data=4,model=1"])
@pytest.mark.parametrize("paging", [False, True], ids=["dense", "paged"])
def test_mesh_serve_equals_single_device_on_card(serve_model, spec, paging):
    """The smoke main path on four logical devices of the card: tokens and
    captured logits equal the single-device serve bit for bit (pipelined
    over paged pages too), with data x model kernel-3 launches an FFN
    GEMM."""
    from repro_torch.serve import Engine, Placement, paged

    cfg, model, params = serve_model
    prompts = _serve_prompts(cfg.vocab, [8] * 4, seed=5)
    kw = dict(max_len=16, max_slots=4, capture_logits=True)
    single = _engine(serve_model, **kw)
    want = single.generate_batch(prompts, 6)
    pol = ExecutionPolicy.for_arch(
        cfg, placement=Placement(mesh=_card_mesh(spec)),
        execution="pipelined" if paging else "sync",
        paging=paged(8) if paging else None)
    eng = Engine(model, params, policy=pol,
                 prefix_cache=False if paging else None, **kw)
    ftp_spmm.reset_launch_counts()
    got = eng.generate_batch(prompts, 6)
    n = ftp_spmm.launch_counts()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    _same_logits(single.drain_logit_traces(), eng.drain_logit_traces())
    # one prefill + five decodes, two GEMMs a layer, 4 slab calls each
    assert n["ftp_bsr"] == 6 * 2 * cfg.n_layers * 4
    assert eng.summary()["mesh_physical_devices"] == 1


# ---------------------------------------------------------------------------
# approximate-TP serving: psum tensor parallelism on the mesh's model axis
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_approximate_tp_float_serve_on_card():
    """The smoke float llama under approximate(0.25) on logical devices of
    the card: drift <= 0.25 from the bitwise single-device serve at 1 x 2
    and 2 x 2, and 2 x 2 == 1 x 2 and pipelined == sync bit for bit
    (tokens and captured logits)."""
    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, Placement, drift_report

    dev = _cuda()
    cfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                       weight_density=1.0)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    prompts = _serve_prompts(cfg.vocab, [8] * 4, seed=5)
    kw = dict(max_len=16, max_slots=4, capture_logits=True)

    def serve(spec=None, **over):
        pol = ExecutionPolicy.for_arch(cfg, **over) if spec is None else \
            ExecutionPolicy.for_arch(
                cfg, placement=Placement(mesh=_card_mesh(spec)),
                exactness=approximate(0.25), **over)
        eng = Engine(model, params, policy=pol, **kw)
        return eng, eng.generate_batch(prompts, 6)

    single, want = serve()
    runs = {spec: serve(spec) for spec in ("data=1,model=2", "data=2,model=2")}
    runs["pipelined"] = serve("data=2,model=2", execution="pipelined")
    traces = {k: e.drain_logit_traces() for k, (e, _) in runs.items()}
    for key in ("data=2,model=2", "pipelined"):
        for a, b in zip(runs["data=1,model=2"][1], runs[key][1]):
            np.testing.assert_array_equal(b, a)
        _same_logits(traces["data=1,model=2"], traces[key])
    rep = drift_report(want, runs["data=2,model=2"][1],
                       single.drain_logit_traces(), traces["data=2,model=2"])
    assert rep["max_logit_drift"] <= 0.25


@pytest.mark.gpu
def test_approximate_tp_dual_serve_on_card(serve_model):
    """The smoke main path at 2 x 2 under approximate(0.25): attention
    psum-TP, the vocab and the FFN plans column slabs (4 launches a GEMM),
    drift <= 0.25 from the bitwise single-device serve.  Each slab launch
    runs the instance `bsr_instance` picks from its slab's payload: at
    smoke width some slabs' column blocks are too narrow for `tc`."""
    from repro_torch.kernels.ftp_spmm import bsr_instance
    from repro_torch.serve import Engine, Placement, drift_report

    cfg, model, params = serve_model
    prompts = _serve_prompts(cfg.vocab, [8] * 4, seed=5)
    kw = dict(max_len=16, max_slots=4, capture_logits=True)
    single = _engine(serve_model, **kw)
    want = single.generate_batch(prompts, 6)
    pol = ExecutionPolicy.for_arch(
        cfg, placement=Placement(mesh=_card_mesh("data=2,model=2")),
        exactness=approximate(0.25))
    eng = Engine(model, params, policy=pol, **kw)
    ftp_spmm.reset_launch_counts()
    got = eng.generate_batch(prompts, 6)
    n = ftp_spmm.launch_counts()
    # one prefill + five decodes, two GEMMs a layer, 4 slab calls each
    assert n["ftp_bsr"] == 6 * 2 * cfg.n_layers * 4
    per_step = {"tc": 0, "simt": 0}
    for lp in eng.params["layers"]:
        for key in ("plan_in", "plan_out"):
            for j in range(2):
                pay = lp["mlp"][key].slab(j).payload
                per_step[bsr_instance(pay.dtype, pay.shape[1], pay.shape[2],
                                      pay.data_ptr() % 16 == 0)] += 2
    assert n["ftp_bsr_tc"] == 6 * per_step["tc"] > 0, (n, per_step)
    assert n["ftp_bsr_simt"] == 6 * per_step["simt"], (n, per_step)
    rep = drift_report(want, got, single.drain_logit_traces(),
                       eng.drain_logit_traces())
    assert rep["max_logit_drift"] <= 0.25
    assert eng.summary()["tp_weights_dealt"] == 4 * cfg.n_layers


# ---------------------------------------------------------------------------
# the train mesh: `make_train_step(mesh=)` on logical devices of the card
# ---------------------------------------------------------------------------

def _card_train_mesh(n, mp):
    from repro_torch.ft.elastic import plan_mesh
    from repro_torch.launch.mesh import LogicalDevice

    dev = _cuda()
    return plan_mesh(n, mp, devices=[LogicalDevice(i, dev) for i in range(n)])


def _train_setup(arch, **over):
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.models.registry import build_model

    _cuda()
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8)
    return cfg, build_model(cfg), [batch_to_torch(data.batch(i), "cuda")
                                   for i in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "spiking"])
def test_train_mesh_step_on_card(kind):
    """The smoke llama at data=2 x model=2 on four logical devices of the
    card: each step within 2e-3 (loss) and 5e-2 (grad norm) of the
    one-device step from the same state (phase 8's card-vs-CPU bounds), a
    repeat bit for bit, pruned FFN weights 0."""
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.sharding import base_rules
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import train_state_axes
    from repro_torch.tree import tree_leaves, tree_paths

    over = dict(spiking_ffn=True, spiking_T=4, spiking_weight_density=0.3) \
        if kind == "spiking" else {}
    cfg, model, batches = _train_setup("llama3_2_1b", **over)
    mesh = _card_train_mesh(4, 2)
    state0 = reshard_state(init_train_state(model, 0, device="cuda"),
                           train_state_axes(model), mesh, base_rules())
    one, meshed = make_train_step(model), make_train_step(model, mesh=mesh)
    runs = []
    for _ in range(2):
        state, metrics = state0, []
        for b in batches:
            _, m1 = one(state, b)
            state, m = meshed(state, b)
            assert abs(float(m["loss"]) / float(m1["loss"]) - 1) <= 2e-3
            assert abs(float(m["grad_norm"]) / float(m1["grad_norm"]) - 1) <= 5e-2
            metrics.append(m)
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    for x, y in zip(ma, mb):
        assert torch.equal(x["loss"], y["loss"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    if kind == "spiking":
        after = dict(tree_paths(a["params"]))
        for p, w0 in tree_paths(state0["params"]):
            if p.endswith(("mlp/wu", "mlp/wd")):
                z = w0 == 0
                assert torch.equal(after[p][z], torch.zeros_like(after[p][z]))


@pytest.mark.gpu
def test_train_mesh_moe_routing_and_restore_on_card(tmp_path):
    """phi3.5-moe (smoke) at 2 x 2: the meshed routing drops one device's
    (token, k) pairs; a checkpoint restored with the 1 x 2 mesh's
    shardings steps like the resharded host state, bit for bit."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.models.layers import record_moe_routing
    from repro_torch.sharding import base_rules, tree_shardings
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import meshed_loss_and_grads, train_state_axes
    from repro_torch.tree import tree_leaves, tree_map

    cfg, model, batches = _train_setup("phi3_5_moe", capacity_factor=0.5)
    mesh = _card_train_mesh(4, 2)
    rules, axes = base_rules(cfg.fsdp), train_state_axes(model)
    state = reshard_state(init_train_state(model, 0, device="cuda"), axes,
                          mesh, rules)
    with torch.no_grad():
        with record_moe_routing() as one:
            model.loss(state["params"], batches[0])
        with record_moe_routing() as meshed:
            meshed_loss_and_grads(model, state["params"], batches[0], mesh,
                                  need_grads=False)
    assert sum(int((~k).sum()) for k in one) > 0
    assert all(torch.equal(x, y) for x, y in zip(one, meshed))
    state, _ = make_train_step(model, mesh=mesh)(state, batches[0])
    host = tree_map(lambda t: t.detach().cpu().clone(), state)
    mesh12 = _card_train_mesh(2, 2)
    step = make_train_step(model, mesh=mesh12)
    a, ma = step(reshard_state(host, axes, mesh12, rules), batches[1])
    save_checkpoint(str(tmp_path), 1, host)
    restored = restore_checkpoint(str(tmp_path), 1, host, shardings=tree_shardings(
        host, axes, mesh12, rules))
    b, mb = step(restored, batches[1])
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
