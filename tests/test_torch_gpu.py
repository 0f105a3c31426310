"""Tests of the port that need the card: every CUDA kernel against its
plain torch version on the same CUDA inputs.  Marked ``gpu``; each skips
without a CUDA device (a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: full sums within 1e-5 (the kernel and the plain version add the
same exact products of a {0,1} spike and a weight, in two f32 orders);
spike words equal except where the LIF input is within 1e-5 of v_th.
"""
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro_torch.bridge import words_to_torch
from repro_torch.core.snn_layers import prune_by_magnitude
from repro_torch.kernels import ftp_spmm, ops, ref
from repro_torch.kernels.join_plan import build_weight_plan
from repro_torch.serve.policy import PACKED_DUAL

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


def _check(a, plan, n_out, T, fuse):
    """Kernel through `ops.dispatch` vs the plain version on the same
    tensors; one launch counted."""
    before = ftp_spmm.LAUNCHES
    c, u = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=n_out, fuse_lif=fuse)
    torch.cuda.synchronize()
    assert ftp_spmm.LAUNCHES == before + 1
    rows = a.reshape(-1, a.shape[-1])
    bm = ftp_spmm.pick_bm(rows.shape[0])
    o, _ = ftp_spmm.ftp_spmm_bsr_plain(
        rows, plan.payload, plan.kidx, plan.vidx, plan.cnt,
        ops._activity(rows, bm, plan), n_out, T, bm=bm, fuse_lif=False)
    if fuse:
        cw, uw = ref.lif_ref(o)
        differ = c.reshape(cw.shape) != cw
        assert not bool((differ & (_lif_margin(o) >= TOL)).any())
        torch.testing.assert_close(u.reshape(uw.shape)[~differ], uw[~differ],
                                   rtol=TOL, atol=TOL)
    else:
        torch.testing.assert_close(c.reshape(o.shape), o, rtol=TOL, atol=TOL)
        assert not bool(u.any())


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("M", [1, 4, 33, 300])
def test_kernel_matches_plain_bf16_block_pruned(M, T, fuse):
    """Ragged row counts at both row tiles, every supported T, the serving
    layout: bf16 payload, 128x128 blocks pruned to density 0.3."""
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
