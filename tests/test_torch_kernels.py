"""The port's kernel layer against the JAX reference, on the CPU: pruning,
load-time join plans, and the dual-sparse BSR route of `ops.dispatch`.

On the CPU the BSR wrapper runs its plain torch version; the reference runs
its Pallas kernel the way its own tests do (interpret mode).  Tolerances:
pruning and plans are exact (same thresholds, same numpy join lists); full
sums within 1e-5 (f32 sums of the same products in another order — each
product of a {0,1} spike and a weight is exact); spike words may differ only
where an f32 rounding difference crosses v_th, which does not happen at
these sizes, so the flip count must be 0.  The CUDA kernel itself is held
against the plain version on the card (`tests/test_torch_gpu.py`, marked
``gpu``, and `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro.core.snn_layers import prune_by_magnitude as j_prune
from repro.kernels import ops as j_ops
from repro.kernels.join_plan import _build_weight_plan_host
from repro.serve.policy import PACKED_DUAL as J_PACKED_DUAL
from repro_torch.bridge import to_torch, words_to_numpy, words_to_torch
from repro_torch.core.snn_layers import prune_by_magnitude as t_prune
from repro_torch.kernels import ftp_spmm, ops, ref
from repro_torch.kernels.join_plan import build_weight_plan
from repro_torch.serve.policy import FLOAT_DENSE, PACKED_DUAL

# The suite runs in parallel worker processes that share the cores; these
# tests are small, so one intra-op thread keeps torch from oversubscribing
# them.
torch.set_num_threads(1)

# the weight densities tests/test_kernels.py draws from, corners included
DENSITIES = [0.005, 0.02, 0.3, 0.77, 1.0]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("block", [None, (32, 64)])
def test_prune_by_magnitude_exact(density, block):
    """Unstructured and two-stage block pruning keep the same entries."""
    w = _normal(np.random.default_rng(int(density * 1000)), 128, 192)
    want = np.asarray(j_prune(jnp.asarray(w), density, block=block))
    got = t_prune(torch.from_numpy(w), density, block=block).numpy()
    np.testing.assert_array_equal(got, want)


def _plan_pair(w, **blocks):
    return (_build_weight_plan_host(w, **blocks),
            build_weight_plan(to_torch(w), **blocks))


def _assert_plans_equal(jp, tp):
    for f in ("kidx", "vidx", "cnt", "bmap"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), getattr(jp, f))
    np.testing.assert_array_equal(tp.payload.float().numpy(),
                                  np.asarray(jp.payload, np.float32))
    assert tp.payload.dtype == to_torch(np.asarray(jp.payload)).dtype


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("K,N", [(160, 96), (256, 384), (64, 128)])
def test_build_weight_plan_exact(density, K, N):
    """payload/kidx/vidx/cnt/bmap equal the reference plan's, including
    the K/N padding of unaligned shapes."""
    rng = np.random.default_rng(K + N + int(density * 100))
    _, w = _mk(rng, 4, 8, K, N, w_density=density)
    _assert_plans_equal(*_plan_pair(w))


def test_build_weight_plan_block_pruned_bf16_and_corners():
    """Block-pruned bf16 weights (the serving layout), a column block with
    no live slot (cnt == 0) and all-zero weights (one dummy block)."""
    import ml_dtypes

    w = np.array(j_prune(jnp.asarray(_normal(np.random.default_rng(7), 256, 256)),
                         0.3, block=(64, 64)))
    w[:, 128:192] = 0
    jp, tp = _plan_pair(w.astype(ml_dtypes.bfloat16), bk=64, bn=64)
    _assert_plans_equal(jp, tp)
    assert int(tp.cnt[2]) == 0 and tp.payload.dtype == torch.bfloat16
    _assert_plans_equal(*_plan_pair(np.zeros((64, 128), np.float32)))


# ---------------------------------------------------------------------------
# BSR full sums / spike words against the reference's dispatch
# ---------------------------------------------------------------------------

def _bsr_case(name):
    """(packed words, weights, T, plan blocks) of one parity case."""
    rng = np.random.default_rng(CASES.index(name) + 100)
    if name == "element_pruned":
        packed, w = _mk(rng, 4, 40, 160, 96, density=0.2, w_density=0.3)
        return packed, w, 4, {}
    if name == "block_pruned_silent":
        packed, _ = _mk(rng, 8, 24, 256, 256, density=0.1)
        packed[8:16] = 0  # an all-silent row tile at every row tile size
        w = np.array(j_prune(jnp.asarray(_normal(rng, 256, 256)), 0.3,
                             block=(64, 64)))
        w[:, 64:128] = 0  # a column block with cnt == 0
        return packed, w, 8, {"bk": 64, "bn": 64}
    if name == "all_silent":
        _, w = _mk(rng, 4, 16, 96, 64, w_density=0.5)
        return np.zeros((16, 96), np.uint32), w, 4, {}
    raise KeyError(name)


CASES = ["element_pruned", "block_pruned_silent", "all_silent"]


@pytest.fixture(scope="module")
def reference_bsr():
    """Reference dispatch outputs, keyed (case, fuse, batched)."""
    out = {}
    for name in CASES:
        packed, w, T, blocks = _bsr_case(name)
        plan = _build_weight_plan_host(w, **blocks)
        N = w.shape[1]
        for fuse in (True, False):
            c, u = j_ops.dispatch(jnp.asarray(packed), plan, J_PACKED_DUAL, T,
                                  n_out=N, fuse_lif=fuse)
            out[name, fuse, False] = (np.asarray(c), np.asarray(u))
            batched = packed.reshape(2, -1, packed.shape[1])
            c, u = j_ops.dispatch(jnp.asarray(batched), plan, J_PACKED_DUAL, T,
                                  n_out=N, fuse_lif=fuse)
            out[name, fuse, True] = (np.asarray(c), np.asarray(u))
    return out


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_bsr_dispatch_matches_reference(reference_bsr, name, fuse, batched):
    packed, w, T, blocks = _bsr_case(name)
    plan = build_weight_plan(torch.from_numpy(w), **blocks)
    a = words_to_torch(packed)
    if batched:
        a = a.reshape(2, -1, a.shape[1])
    c, u = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=w.shape[1], fuse_lif=fuse)
    want_c, want_u = reference_bsr[name, fuse, batched]
    if fuse:
        flips = int((words_to_numpy(c) != want_c).sum())
        assert flips == 0, f"{flips} spike words differ"
    else:
        np.testing.assert_allclose(c.numpy(), want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fuse", [True, False])
def test_plain_version_matches_dense_oracle(fuse):
    """The kernel's plain version (walks the join list, skips silent
    blocks) equals the dense unpack-and-contract oracle of `ref.py`."""
    packed, w, T, blocks = _bsr_case("block_pruned_silent")
    plan = build_weight_plan(torch.from_numpy(w), **blocks)
    a = words_to_torch(packed)
    c, u = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=w.shape[1], fuse_lif=fuse)
    if fuse:
        cw, uw = ref.ftp_spmm_fused_lif_ref(a, torch.from_numpy(w), T)
        assert torch.equal(c, cw)
        torch.testing.assert_close(u, uw, rtol=1e-5, atol=1e-5)
    else:
        want = ref.ftp_spmm_ref(a, torch.from_numpy(w), T)
        torch.testing.assert_close(c, want, rtol=1e-5, atol=1e-5)
        assert not u.any()


def test_float_route_matches_reference():
    """spike_format='float' is the differentiable plain path."""
    rng = np.random.default_rng(11)
    s = (rng.random((4, 12, 48)) < 0.3).astype(np.float32)
    w = _normal(rng, 48, 32) / 4
    from repro.serve.policy import FLOAT_DENSE as J_FLOAT

    want = np.asarray(j_ops.dispatch(jnp.asarray(s), jnp.asarray(w), J_FLOAT, 4))
    got = ops.dispatch(torch.from_numpy(s), torch.from_numpy(w), FLOAT_DENSE, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    js, ju = j_ops.dispatch(jnp.asarray(s), jnp.asarray(w), J_FLOAT, 4,
                            fuse_lif=True)
    ts, tu = ops.dispatch(torch.from_numpy(s), torch.from_numpy(w), FLOAT_DENSE,
                          4, fuse_lif=True)
    assert int((ts.numpy() != np.asarray(js)).sum()) == 0
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)


def test_dispatch_refuses_unported_routes():
    """A plan under a dense policy and a non-policy raise.  Raw weights
    under a dual_sparse policy build their plan per call (the route is
    ported): the same result as the plan built at load."""
    packed, w, T, _ = _bsr_case("all_silent")
    plan = build_weight_plan(torch.from_numpy(w))
    with pytest.raises(ValueError, match="weight_sparsity"):
        ops.dispatch(words_to_torch(packed), plan, FLOAT_DENSE, T)
    got, _ = ops.dispatch(words_to_torch(packed), torch.from_numpy(w),
                          PACKED_DUAL, T)
    want, _ = ops.dispatch(words_to_torch(packed), plan, PACKED_DUAL, T,
                           n_out=w.shape[1])
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        ops.dispatch(words_to_torch(packed), plan, "packed_dual", T)


def test_wrapper_checks_inputs_and_has_no_fallback():
    """The wrapper validates before it dispatches, and a tensor on any
    device but the CPU goes to the kernel or raises — the plain version is
    never a fallback for it."""
    packed, w, T, _ = _bsr_case("all_silent")
    plan = build_weight_plan(torch.from_numpy(w))
    a = words_to_torch(packed)
    act = torch.zeros((4, plan.nkb), dtype=torch.int32)
    args = (plan.payload, plan.kidx, plan.vidx, plan.cnt)
    with pytest.raises(ValueError, match="int32"):
        ftp_spmm.ftp_spmm_bsr(a.float(), *args, act, 64, T, bm=4)
    with pytest.raises(ValueError, match="act"):
        ftp_spmm.ftp_spmm_bsr(a, *args, act[:2], 64, T, bm=4)
    with pytest.raises(ValueError, match="n_out"):
        ftp_spmm.ftp_spmm_bsr(a, *args, act, 10**6, T, bm=4)
    meta = [t.to("meta") for t in (a, *args, act)]
    before = ftp_spmm.LAUNCHES
    with pytest.raises(ValueError, match="no ftp_bsr kernel"):
        ftp_spmm.ftp_spmm_bsr(*meta, 64, T, bm=4)
    assert ftp_spmm.LAUNCHES == before
