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
kernel 3 at min_spikes=1, the dense kernel and kernel 3 on block-pruned
weights, one row alone and in a batch): equal, bit for bit.
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


def _check(a, plan, n_out, T, fuse, policy=PACKED_DUAL):
    """BSR kernel through `ops.dispatch` vs the plain version on the same
    tensors; one launch of the policy's kernel counted."""
    name = "ftp_bsr_adaptive" if policy.temporal.enabled else "ftp_bsr"
    before = ftp_spmm.launch_counts()
    c, u = ops.dispatch(a, plan, policy, T, n_out=n_out, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(before, **{name: before[name] + 1})
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
    kernel 3's."""
    dev = _cuda()
    rng = np.random.default_rng(1000 + M * 10 + T)
    packed = _front_silent(rng, T, M, 512)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128))
    plan = build_weight_plan(w.to(dev, torch.bfloat16))
    a = words_to_torch(packed, dev)
    c_a, u_a = _check(a, plan, 384, T, fuse, PACKED_DUAL_ADAPTIVE)
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
# kernels 1 and 2: packed spikes x dense weights
# ---------------------------------------------------------------------------

def _check_dense(a, w, T, fuse):
    """Dense kernel through `ops.dispatch` vs its plain version; one launch
    of kernel 2 (fused) or 1 counted."""
    name = "ftp_spmm_fused_lif" if fuse else "ftp_spmm"
    before = ftp_spmm.launch_counts()
    got = ops.dispatch(a, w, PACKED_DENSE, T, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(before, **{name: before[name] + 1})
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
    bucket, bf16 and f32 weights, an unaligned K and N (the 2- and 4-byte
    load path and a masked column tail) and an aligned pair (16-byte
    loads)."""
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
@pytest.mark.parametrize("T", [4, 16])
@pytest.mark.parametrize("M", [4, 300])
def test_dense_kernel_equals_bsr_on_block_pruned_weights(M, T):
    """Both kernels add in ascending k, and a pruned weight only adds +0:
    on block-pruned weights the dense kernel's full sums, spike words and U
    equal kernel 3's, bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(31 + M + T)
    packed, _ = _mk(rng, T, M, 512, 8, density=0.2)
    w = prune_by_magnitude(torch.from_numpy(rng.normal(size=(512, 384)).astype(
        np.float32) / 16), 0.3, block=(128, 128)).to(dev, torch.bfloat16)
    plan = build_weight_plan(w)
    a = words_to_torch(packed, dev)
    o_dense = ops.dispatch(a, w, PACKED_DENSE, T)
    o_bsr, _ = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=384)
    assert torch.equal(o_dense, o_bsr)
    c_d, u_d = ops.dispatch(a, w, PACKED_DENSE, T, fuse_lif=True)
    c_b, u_b = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=384, fuse_lif=True)
    assert torch.equal(c_d, c_b) and torch.equal(u_d, u_b)


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
        before, ftp_spmm_fused_lif=before["ftp_spmm_fused_lif"] + 1)
    words_hold(c, ref.ftp_spmm_ref(a, w_in, 4))

    before = ftp_spmm.launch_counts()
    y, h = spiking_ffn_apply_packed({"w_in": w_in, "w_out": w_out},
                                    a.reshape(3, 11, 256), cfg)
    torch.cuda.synchronize()
    assert ftp_spmm.launch_counts() == dict(
        before, ftp_spmm_fused_lif=before["ftp_spmm_fused_lif"] + 1,
        ftp_spmm=before["ftp_spmm"] + 1)
    h = h.reshape(33, 512)
    words_hold(h, ref.ftp_spmm_ref(a, w_in, 4))
    torch.testing.assert_close(
        y.reshape(33, 256), rate_decode(ref.ftp_spmm_ref(h, w_out, 4)),
        rtol=TOL, atol=TOL)
