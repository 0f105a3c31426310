"""The paper's own SNN track on the port against the JAX reference, on the
CPU: the rest of `core`'s public API, the fiber format, the inner-join
model, silent-neuron preprocessing on every spiking path, the per-call
dual-sparse route of `ops.dispatch` with the offline `build_block_join`,
and the LTH example's forward.

Inputs are drawn with numpy from a seed and handed to both packages
(uint32 spike words as the port's int32 words with the same bits,
`repro_torch.bridge`).  Tolerances:
* host models (fibers, inner join, compression efficiency, block maps,
  join lists): equal;
* spike words and masks: equal (0 flips — the f32 sums differ only in the
  order of exact {0,1} x weight products, and no sum here lies within that
  rounding of v_th);
* f32 full sums, potentials and outputs: within 1e-5;
* the per-call route: the port's plain BSR version (the wrapper on CPU
  tensors) against the reference's Pallas kernel in interpret mode, as
  its own tests run it.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

import repro.core as j_core
from repro.core import fibers as j_fib
from repro.core import ftp as j_ftp
from repro.core import innerjoin as j_ij
from repro.core import lif as j_lif
from repro.core import packing as j_pack
from repro.core import snn_layers as j_snn
from repro.kernels import ops as j_ops
from repro.serve import policy as j_policy
import repro_torch.core as t_core
from repro_torch.bridge import to_torch, words_to_numpy, words_to_torch
from repro_torch.core import fibers as t_fib
from repro_torch.core import ftp as t_ftp
from repro_torch.core import innerjoin as t_ij
from repro_torch.core import lif as t_lif
from repro_torch.core import packing as t_pack
from repro_torch.core import snn_layers as t_snn
from repro_torch.kernels import ftp_spmm, ops
from repro_torch.serve import policy as t_policy

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

# small tests in parallel workers that share the cores
torch.set_num_threads(1)


def _spikes(rng, T, M, K, density=0.3):
    return (rng.random((T, M, K)) < density).astype(np.float32)


def _words(spikes):
    """(T, ...) {0,1} -> uint32 words, bit t = spikes[t]."""
    out = np.zeros(spikes.shape[1:], np.uint32)
    for t in range(spikes.shape[0]):
        out |= spikes[t].astype(np.uint32) << t
    return out


def _table_ii_words(rng, T, M, K, d_a, ns):
    """Packed words at a Table II layer's sparsity: a neuron is non-silent
    with probability ``ns`` and then fires at each timestep with
    probability d_a / ns, at least once."""
    live = rng.random((M, K)) < ns
    fire = rng.random((T, M, K)) < min(1.0, d_a / ns)
    first = rng.integers(0, T, size=(M, K))
    fire[first, np.arange(M)[:, None], np.arange(K)[None, :]] = True
    return _words(fire & live[None])


# ---------------------------------------------------------------------------
# core's public API
# ---------------------------------------------------------------------------

def test_core_exports_the_reference_public_list():
    assert t_core.__all__ == j_core.__all__
    for name in t_core.__all__:
        assert getattr(t_core, name) is not None


@pytest.mark.parametrize("min_spikes", [1, 2, 3])
def test_mask_low_activity_spikes_matches_reference(min_spikes):
    s = _spikes(np.random.default_rng(min_spikes), 4, 12, 40)
    want = np.asarray(j_pack.mask_low_activity_spikes(jnp.asarray(s), min_spikes))
    got = t_pack.mask_low_activity_spikes(torch.from_numpy(s), min_spikes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_low_activity_spikes_is_multiplicative():
    """Gradients flow through the surviving spikes, and only through them."""
    s = torch.from_numpy(_spikes(np.random.default_rng(9), 4, 6, 30))
    x = torch.ones_like(s, requires_grad=True)
    t_pack.mask_low_activity_spikes(s * x, 2).sum().backward()
    keep = (s.sum(0, keepdim=True) >= 2).float()
    torch.testing.assert_close(x.grad, s * keep)


@pytest.mark.parametrize("bk,bn", [(8, 16), (32, 32), (64, 8)])
def test_block_nonzero_map_matches_reference(bk, bn):
    _, w = _mk(np.random.default_rng(bk + bn), 4, 8, 64, 64, w_density=0.01)
    w[:32, :32] = 0
    w[:, :16] = 0  # an all-zero block at each block shape
    want = np.asarray(j_pack.block_nonzero_map(jnp.asarray(w), bk, bn))
    got = t_pack.block_nonzero_map(torch.from_numpy(w), bk, bn)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.all() and want.any()
    with pytest.raises(ValueError, match="not divisible"):
        t_pack.block_nonzero_map(torch.from_numpy(w[:63]), bk, bn)


def test_silent_fraction_and_spike_sparsity_match_reference():
    s = _spikes(np.random.default_rng(4), 4, 16, 48, density=0.1)
    words = _words(s)
    assert float(t_pack.silent_fraction(words_to_torch(words))) == float(
        j_pack.silent_fraction(jnp.asarray(words)))
    assert float(t_pack.spike_sparsity(torch.from_numpy(s))) == float(
        j_pack.spike_sparsity(jnp.asarray(s)))


@pytest.mark.parametrize("T,M,K", [(4, 16, 64), (8, 3, 100), (32, 5, 7)])
def test_compression_efficiency_matches_reference(T, M, K):
    s = (np.random.default_rng(T + K).random((T, M, K)) < 0.2).astype(np.int64)
    want = j_pack.compression_efficiency(s)
    assert t_pack.compression_efficiency(s) == want
    assert t_pack.compression_efficiency(torch.from_numpy(s)) == want


def test_compression_efficiency_paper_example():
    """Paper Fig. 8: a row [1010, 0000, 0000, 0111] -> LoAS 125 %."""
    s = np.zeros((4, 1, 4), np.int64)
    s[0, 0, 0] = s[2, 0, 0] = 1
    s[1, 0, 3] = s[2, 0, 3] = s[3, 0, 3] = 1
    eff = t_pack.compression_efficiency(s)
    assert eff == j_pack.compression_efficiency(s)
    assert eff["silent_fraction"] == 0.5
    assert eff["loas_efficiency"] == pytest.approx(5 / 4)


@pytest.mark.parametrize("T", [1, 4, 32])
def test_plif_packed_matches_reference(T):
    o = (np.random.default_rng(T).normal(size=(T, 9, 33)) * 1.5).astype(np.float32)
    jw, ju = j_lif.plif_packed(jnp.asarray(o))
    tw, tu = t_lif.plif_packed(torch.from_numpy(o))
    np.testing.assert_array_equal(words_to_numpy(tw), np.asarray(jw))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [1, 4, 16, 32])
def test_sequential_spmspm_equals_ftp_and_reference(T):
    """The timestep-sequential baseline equals the FTP schedule (and the
    reference's sequential product); T = 32 sets bit 31."""
    packed, w = _mk(np.random.default_rng(T), T, 20, 96, 48, density=0.3,
                    w_density=0.2)
    a = words_to_torch(packed)
    got = t_ftp.sequential_spmspm(a, torch.from_numpy(w), T)
    torch.testing.assert_close(got, t_ftp.ftp_spmspm(a, torch.from_numpy(w), T),
                               rtol=TOL, atol=TOL)
    want = np.asarray(j_ftp.sequential_spmspm(jnp.asarray(packed),
                                              jnp.asarray(w), T))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# fibers
# ---------------------------------------------------------------------------

def _fibers_equal(t, j, payload_as=None):
    np.testing.assert_array_equal(t.bitmask, j.bitmask)
    np.testing.assert_array_equal(t.pointers, j.pointers)
    payload = t.payload if payload_as is None else t.payload.view(payload_as)
    np.testing.assert_array_equal(payload, j.payload)
    assert tuple(t.shape) == tuple(j.shape) and t.nnz == j.nnz


@pytest.mark.parametrize("T", [4, 32])
def test_fibers_round_trip_and_traffic_match_reference(T):
    rng = np.random.default_rng(T)
    spikes = _spikes(rng, T, 24, 128, density=0.05)
    words = _words(spikes)
    _, w = _mk(rng, 4, 8, 128, 64, w_density=0.05)
    jr = j_fib.compress_rows(words)
    for a in (words_to_numpy(words_to_torch(words)).view(np.int32),
              words_to_torch(words)):
        tr = t_fib.compress_rows(a)
        _fibers_equal(tr, jr, np.uint32)
        np.testing.assert_array_equal(
            t_fib.decompress_rows(tr).view(np.uint32), words)
    jc = j_fib.compress_cols(w)
    tc = t_fib.compress_cols(torch.from_numpy(w))
    _fibers_equal(tc, jc)
    np.testing.assert_array_equal(t_fib.decompress_cols(tc), w)
    for elem_bits in (T, 8):
        assert t_fib.fiber_traffic_bytes(tr, elem_bits) == \
            j_fib.fiber_traffic_bytes(jr, elem_bits)
    assert t_fib.fiber_traffic_bytes(tc, 8, 16) == j_fib.fiber_traffic_bytes(jc, 8, 16)
    assert t_fib.csr_traffic_bytes(torch.from_numpy(spikes)) == \
        j_fib.csr_traffic_bytes(spikes)
    assert t_fib.csr_traffic_bytes(w[None], elem_bits=8) == \
        j_fib.csr_traffic_bytes(w[None], elem_bits=8)
    with pytest.raises(ValueError, match="2-D"):
        t_fib.compress_rows(spikes)


# ---------------------------------------------------------------------------
# the inner-join model
# ---------------------------------------------------------------------------

def _join_equal(t, j):
    np.testing.assert_array_equal(t.out, j.out)
    for f in ("cycles", "matched", "pseudo_accum_adds", "correction_adds",
              "fifo_stall_cycles"):
        assert getattr(t, f) == getattr(j, f), f


def test_inner_join_fig10_walkthrough():
    """Paper Fig. 10: a2 = 1111 accumulates into the pseudo accumulator
    only; a4 = 1010 is corrected at t1 and t3."""
    bm_a = np.zeros(128, bool)
    bm_a[[2, 4]] = True
    bm_b = bm_a.copy()
    pack_a = np.array([0b1111, 0b0101], np.uint32)
    vals_b = np.array([3.0, 5.0])
    res = t_ij.inner_join(bm_a, pack_a.view(np.int32), bm_b, vals_b,
                          t_ij.InnerJoinConfig(fiber_len=128, T=4))
    _join_equal(res, j_ij.inner_join(bm_a, pack_a, bm_b, vals_b,
                                     j_ij.InnerJoinConfig(fiber_len=128, T=4)))
    np.testing.assert_allclose(res.out, [8.0, 3.0, 8.0, 3.0])
    assert res.pseudo_accum_adds == 2 and res.correction_adds == 2


@pytest.mark.parametrize("T", [1, 4, 32])
def test_inner_join_matches_reference_on_seeded_fibers(T):
    """Outputs, cycles and add counts equal; at T = 32 the words carry bit
    31 (negative as the port's int32 words)."""
    rng = np.random.default_rng(T + 50)
    jcfg = j_ij.InnerJoinConfig(fiber_len=128, T=T)
    tcfg = t_ij.InnerJoinConfig(fiber_len=128, T=T)
    assert tcfg.laggy_cycles == jcfg.laggy_cycles
    for _ in range(10):
        bm_a = rng.random(128) < rng.uniform(0.05, 0.6)
        bm_b = rng.random(128) < rng.uniform(0.05, 0.6)
        pack_a = rng.integers(1, 2**T, size=int(bm_a.sum()),
                              dtype=np.uint64).astype(np.uint32)
        if T == 32:
            pack_a[::2] |= np.uint32(1 << 31)
        vals_b = rng.normal(size=int(bm_b.sum()))
        want = j_ij.inner_join(bm_a, pack_a, bm_b, vals_b, jcfg)
        _join_equal(t_ij.inner_join(bm_a, pack_a.view(np.int32), bm_b, vals_b,
                                    tcfg), want)
        ref = t_ij.inner_join_reference(bm_a, pack_a.view(np.int32), bm_b, vals_b, T)
        np.testing.assert_array_equal(
            ref, j_ij.inner_join_reference(bm_a, pack_a, bm_b, vals_b, T))
        np.testing.assert_allclose(want.out, ref, rtol=1e-9, atol=1e-9)
        bm_t = rng.random(128) < 0.3
        assert t_ij.sparten_join_cycles(bm_t, bm_b) == \
            j_ij.sparten_join_cycles(bm_t, bm_b)


# ---------------------------------------------------------------------------
# silent-neuron preprocessing on the four spiking paths
# ---------------------------------------------------------------------------

MIN_SPIKES = 2


@pytest.fixture(scope="module")
def ffn_params():
    """FFN params from the reference (block-pruned, density 0.3) and the
    same values as the port's tensors."""
    jp = j_snn.init_spiking_ffn(jax.random.PRNGKey(11), 64, 256,
                                weight_density=0.3, prune_block=(32, 64))
    return jp, {k: to_torch(np.asarray(v)) for k, v in jp.items()}


def _cfgs(min_spikes=MIN_SPIKES):
    return (j_snn.SpikingConfig(T=4, weight_density=0.3,
                                preprocess_min_spikes=min_spikes),
            t_snn.SpikingConfig(T=4, weight_density=0.3,
                                preprocess_min_spikes=min_spikes))


def _x(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 2).astype(np.float32)


def _encoded_words(seed, *shape):
    from repro.core.lif import direct_encode

    return np.asarray(j_pack.pack_spikes(direct_encode(jnp.asarray(_x(seed, *shape)), 4)))


def test_spiking_config_default_leaves_preprocessing_off():
    assert t_snn.SpikingConfig().preprocess_min_spikes == 0
    assert [f.name for f in dataclasses.fields(t_snn.SpikingConfig)] == \
        [f.name for f in dataclasses.fields(j_snn.SpikingConfig)]


def test_preprocessing_masks_something_here():
    """The inputs below hold neurons that fire once, so the preprocessing
    changes them (the tests then witness it on every path)."""
    words = _encoded_words(1, 21, 64)
    masked = np.asarray(j_pack.mask_low_activity(jnp.asarray(words), MIN_SPIKES))
    assert (masked != words).any()
    np.testing.assert_array_equal(
        words_to_numpy(t_pack.mask_low_activity(words_to_torch(words), MIN_SPIKES)),
        masked)


def test_spiking_linear_train_preprocessed_matches_reference(ffn_params):
    """The train path: output spikes equal, the weight gradient within
    TOL (op by op)."""
    jp, tp = ffn_params
    cfg_j, cfg_t = _cfgs()
    s = _spikes(np.random.default_rng(3), 4, 10, 64, density=0.2)
    with jax.disable_jit():
        want = j_snn.spiking_linear_train(jnp.asarray(s), jp["w_in"], cfg_j)
        jg = jax.grad(lambda w: j_snn.spiking_linear_train(
            jnp.asarray(s), w, cfg_j).sum())(jp["w_in"])
    w = tp["w_in"].clone().requires_grad_()
    got = t_snn.spiking_linear_train(torch.from_numpy(s), w, cfg_t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)
    plain = t_snn.spiking_linear_train(torch.from_numpy(s), tp["w_in"], _cfgs(0)[1])
    assert not torch.equal(plain, got.detach())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spiking_linear_infer_preprocessed_matches_reference(ffn_params, use_kernel):
    jp, tp = ffn_params
    cfg_j, cfg_t = _cfgs()
    words = _encoded_words(1, 21, 64)
    want = j_snn.spiking_linear_infer(jnp.asarray(words), jp["w_in"], cfg_j,
                                      use_kernel=use_kernel)
    got = t_snn.spiking_linear_infer(words_to_torch(words), tp["w_in"], cfg_t)
    assert int((words_to_numpy(got) != np.asarray(want)).sum()) == 0


@pytest.mark.parametrize("route", ["plans", "dense"])
def test_spiking_ffn_apply_packed_preprocessed_matches_reference(ffn_params, route):
    jp, tp = ffn_params
    cfg_j, cfg_t = _cfgs()
    if route == "plans":
        jp, tp = j_snn.attach_join_plans(jp, cfg_j), t_snn.attach_join_plans(tp, cfg_t)
    words = _encoded_words(2, 2, 9, 64)
    jy, jh = j_snn.spiking_ffn_apply_packed(jp, jnp.asarray(words), cfg_j)
    ty, th = t_snn.spiking_ffn_apply_packed(tp, words_to_torch(words), cfg_t)
    assert int((words_to_numpy(th) != np.asarray(jh)).sum()) == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode,route", [("infer", "plans"), ("infer", "dense"),
                                        ("train", "dense")])
def test_spiking_ffn_apply_preprocessed_matches_reference(ffn_params, mode, route):
    jp, tp = ffn_params
    cfg_j, cfg_t = _cfgs()
    if route == "plans":
        jp, tp = j_snn.attach_join_plans(jp, cfg_j), t_snn.attach_join_plans(tp, cfg_t)
    x = _x(6, 3, 7, 64)
    with jax.disable_jit():
        want = j_snn.spiking_ffn_apply(jp, jnp.asarray(x), cfg_j, mode=mode)
    got = t_snn.spiking_ffn_apply(tp, torch.from_numpy(x), cfg_t, mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    off = t_snn.spiking_ffn_apply(tp, torch.from_numpy(x), _cfgs(0)[1], mode=mode)
    assert not torch.equal(off, got)


def test_sparsity_mask_matches_reference(ffn_params):
    jp, tp = ffn_params
    np.testing.assert_array_equal(t_snn.sparsity_mask(tp["w_in"]).numpy(),
                                  np.asarray(j_snn.sparsity_mask(jp["w_in"])))


# ---------------------------------------------------------------------------
# the per-call dual-sparse route
# ---------------------------------------------------------------------------

def _policies(temporal):
    """(reference, port) dual_sparse policies; ``temporal`` None, or the
    adaptive threshold (>1 is lossy and needs approximate exactness)."""
    if temporal is None:
        return j_policy.PACKED_DUAL, t_policy.PACKED_DUAL
    kw_j = dict(spike_format="packed", weight_sparsity="dual_sparse",
                temporal=j_policy.adaptive_t(temporal))
    kw_t = dict(spike_format="packed", weight_sparsity="dual_sparse",
                temporal=t_policy.adaptive_t(temporal))
    if temporal > 1:
        kw_j["exactness"] = j_policy.approximate(1.0)
        kw_t["exactness"] = t_policy.approximate(1.0)
    return j_policy.ExecutionPolicy(**kw_j), t_policy.ExecutionPolicy(**kw_t)


def _thff_cut():
    """T-HFF's sparsity (d_a 0.15, ns 0.18, d_b 0.032) at M 64, K 256, N
    256; the weights scaled so that the LIF fires."""
    rng = np.random.default_rng(23)
    words = _table_ii_words(rng, 4, 64, 256, 0.15, 0.18)
    w = (rng.normal(size=(256, 256)) * 3).astype(np.float32)
    w = t_snn.prune_by_magnitude(torch.from_numpy(w), 0.032).numpy()
    return words, w


def _same(label, got, want, fuse):
    (c, u), (jc, ju) = got, want
    if fuse:
        flips = int((words_to_numpy(c) != np.asarray(jc)).sum())
        assert flips == 0, f"{label}: {flips} spike words differ"
    else:
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("temporal", [None, 1, 2])
@pytest.mark.parametrize("fuse", [True, False])
def test_per_call_route_matches_reference_at_thff_cut(fuse, temporal):
    words, w = _thff_cut()
    jpol, tpol = _policies(temporal)
    want = j_ops.dispatch(jnp.asarray(words), jnp.asarray(w), jpol, 4,
                          fuse_lif=fuse)
    got = ops.dispatch(words_to_torch(words), torch.from_numpy(w), tpol, 4,
                       fuse_lif=fuse)
    assert got[0].shape == want[0].shape
    _same("T-HFF cut", got, want, fuse)
    if fuse:
        assert words_to_numpy(got[0]).any()  # the LIF fired somewhere


@pytest.mark.parametrize("fuse", [True, False])
def test_per_call_route_batched_matches_reference(fuse):
    words, w = _thff_cut()
    batched = words.reshape(4, 16, -1)
    want = j_ops.dispatch(jnp.asarray(batched), jnp.asarray(w),
                          j_policy.PACKED_DUAL, 4, fuse_lif=fuse)
    got = ops.dispatch(words_to_torch(batched), torch.from_numpy(w),
                       t_policy.PACKED_DUAL, 4, fuse_lif=fuse)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    _same("batched", got, want, fuse)


def test_per_call_adaptive_1_equals_the_full_kernel():
    """adaptive_t(1) skips only all-silent planes: equal to the full route."""
    words, w = _thff_cut()
    words &= ~np.uint32(0b0001)  # plane 0 silent everywhere
    a, wt = words_to_torch(words), torch.from_numpy(w)
    full = ops.dispatch(a, wt, t_policy.PACKED_DUAL, 4, fuse_lif=True)
    gated = ops.dispatch(a, wt, _policies(1)[1], 4, fuse_lif=True)
    assert torch.equal(full[0], gated[0]) and torch.equal(full[1], gated[1])


# a narrow VGG16-shaped stack: conv1_1's K = 27 (bk 27), a 64-wide and a
# 128-wide layer, and the 10-class fc (bn 10)
STACK = [(27, 64), (64, 128), (128, 10)]


@pytest.mark.parametrize("fuse_last", [True, False])
def test_per_call_route_matches_reference_on_a_vgg16_shaped_stack(fuse_last):
    rng = np.random.default_rng(31)
    words = _table_ii_words(rng, 4, 64, 27, 0.18, 0.26)
    jwords, twords = jnp.asarray(words), words_to_torch(words)
    for i, (K, N) in enumerate(STACK):
        w = (rng.normal(size=(K, N)) * 2).astype(np.float32)
        w = t_snn.prune_by_magnitude(torch.from_numpy(w), 0.2).numpy()
        fuse = fuse_last or i < len(STACK) - 1
        want = j_ops.dispatch(jwords, jnp.asarray(w), j_policy.PACKED_DUAL, 4,
                              fuse_lif=fuse)
        got = ops.dispatch(twords, torch.from_numpy(w), t_policy.PACKED_DUAL, 4,
                           fuse_lif=fuse)
        assert got[0].shape == want[0].shape
        _same(f"layer {i}", got, want, fuse)
        jwords, twords = want[0], got[0]


def test_per_call_route_launches_nothing_on_the_cpu():
    words, w = _thff_cut()
    before = ftp_spmm.launch_counts()
    ops.dispatch(words_to_torch(words), torch.from_numpy(w),
                 t_policy.PACKED_DUAL, 4, fuse_lif=True)
    assert ftp_spmm.launch_counts() == before


def test_per_call_route_refused_when_pipelined():
    """As the reference: the pipelined policy refuses per-call plans."""
    words, w = _thff_cut()
    pol_j = dataclasses.replace(j_policy.PACKED_DUAL, execution="pipelined")
    pol_t = dataclasses.replace(t_policy.PACKED_DUAL, execution="pipelined")
    with pytest.raises(ValueError, match="pipelined"):
        j_ops.dispatch(jnp.asarray(words), jnp.asarray(w), pol_j, 4)
    with pytest.raises(ValueError, match="pipelined"):
        ops.dispatch(words_to_torch(words), torch.from_numpy(w), pol_t, 4)


@pytest.mark.parametrize("bm,bk,bn", [(16, 128, 128), (8, 32, 64), (64, 64, 32)])
def test_build_block_join_matches_reference(bm, bk, bn):
    words, w = _thff_cut()
    w[:, 64:128] = 0  # whole column blocks without a live slot
    words[16:32] = 0  # silent row tiles
    want = j_ops.build_block_join(words, w, bm, bk, bn)
    got = ops.build_block_join(words_to_torch(words), torch.from_numpy(w),
                               bm, bk, bn)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, j in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, j)
    assert got[4] == want[4]


# ---------------------------------------------------------------------------
# the LTH example
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("min_spikes", [0, 2])
def test_lth_example_forward_matches_reference(min_spikes):
    """`forward` of the port's LTH example at the reference example's
    params, masks and data: hidden spikes equal (0 flips) and logits
    within TOL."""
    j_ex, t_ex = _example("train_snn_lth"), _example("train_snn_lth_torch")
    jp = j_ex.init(jax.random.PRNGKey(2))
    x, _ = j_ex.make_data(64, jax.random.PRNGKey(0))
    jm = {k: (j_snn.prune_by_magnitude(v, 0.1) != 0).astype(jnp.float32)
          for k, v in jp.items()}
    want_logits, want_h = j_ex.forward(jp, x, jm, min_spikes)
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    tm = {k: to_torch(np.asarray(v)) for k, v in jm.items()}
    logits, h = t_ex.forward(tp, to_torch(np.asarray(x)), tm, min_spikes)
    flips = int((h.numpy() != np.asarray(want_h)).sum())
    assert flips == 0, f"{flips} hidden spikes differ"
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)


def test_lth_example_runs_and_keeps_its_density():
    """A few steps on the CPU: finite loss, masked weights at the pruned
    density, preprocessing silences at least as many neurons."""
    out = _example("train_snn_lth_torch").run(steps=3, rounds=1, density=0.1,
                                              device="cpu", log=lambda _: None)
    assert np.isfinite(out["loss"]) and np.isfinite(out["loss_ft"])
    for w in out["weights"].values():
        t_snn.assert_weight_density(w, out["density"], tol=1e-6)
    assert out["silent_ft"] >= out["silent"]
    assert out["sim_speedup"] > 0
