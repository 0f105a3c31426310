"""The port's dense-weight route against the JAX reference, on the CPU:
kernels 1 and 2 (`ftp_spmm`, `ftp_spmm_fused_lif`), `ops.dispatch` under
PACKED_DENSE, the spiking layers in infer mode without join plans, and the
smoke slice served under ``weight_sparsity='dense'``.

On the CPU each wrapper runs its plain version; the reference runs its
Pallas kernels the way its own tests do (interpret mode, through its
padding wrappers in `repro.kernels.ops`).  The CUDA kernel is held against
the plain version on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).

Tolerances:
* full sums and potentials within 1e-5: f32 sums of the same exact
  products (a {0,1} spike times a weight) in another order;
* spike words: a word may differ only where the LIF input lies within 1e-3
  of v_th (an f32 rounding difference there crosses the threshold); at
  these sizes no input lies that close, so the count of such words is
  reported and must be 0 elsewhere;
* served tokens: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro.configs import get_config, smoke_variant
from repro.core import snn_layers as j_snn
from repro.kernels import ops as j_ops
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve.policy import PACKED_DENSE as J_PACKED_DENSE
from repro.serve.policy import adaptive_t as j_adaptive_t
from repro.serve.policy import approximate as j_approximate
from repro_torch import bridge
from repro_torch.bridge import to_torch, words_to_numpy, words_to_torch
from repro_torch.core import snn_layers as t_snn
from repro_torch.core.packing import mask_low_activity_timesteps
from repro_torch.kernels import ftp_spmm, ops
from repro_torch.launch.serve import build_config
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    PACKED_DENSE,
    Engine,
    ExecutionPolicy,
    adaptive_t,
    approximate,
)

torch.set_num_threads(1)

TOL = 1e-5        # full sums / potentials (module docstring)
NEAR_VTH = 1e-3   # a spike word may flip only this close to v_th

# ragged (M, K, N) and T: none of M, K, N a multiple of a block
SHAPES = [(5, 100, 70, 4), (33, 200, 130, 8), (1, 64, 128, 1), (12, 96, 48, 16),
          (7, 40, 24, 32)]


def _case(M, K, N, T, dtype):
    rng = np.random.default_rng(M * 1000 + K + N + T)
    packed, w = _mk(rng, T, M, K, N, density=0.3, w_density=0.4)
    w = (w / 4).astype(dtype)
    return packed, w


def _lif_margin(o, v_th=1.0, tau=0.5):
    u, margin = np.zeros_like(o[0]), np.full_like(o[0], np.inf)
    for t in range(o.shape[0]):
        x = o[t] + u
        margin = np.minimum(margin, np.abs(x - v_th))
        u = tau * x * (1.0 - (x > v_th))
    return margin


def _assert_words(got, want, o):
    """Spike words equal except within NEAR_VTH of the threshold."""
    differ = words_to_numpy(got) != np.asarray(want, np.uint32)
    far = _lif_margin(np.asarray(o, np.float32)) >= NEAR_VTH
    assert not (differ & far).any(), f"{int((differ & far).sum())} words flip"
    return differ


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("M,K,N,T", SHAPES)
def test_ftp_spmm_plain_matches_reference(M, K, N, T, dtype):
    """Kernel 1's plain version vs the reference Pallas `ftp_spmm`."""
    packed, w = _case(M, K, N, T, dtype)
    want = np.asarray(j_ops._spmm(jnp.asarray(packed), jnp.asarray(w), T))
    got = ftp_spmm.ftp_spmm(words_to_torch(packed), to_torch(w), T)
    assert got.shape == (T, M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("M,K,N,T", SHAPES)
def test_ftp_spmm_fused_lif_plain_matches_reference(M, K, N, T, dtype):
    """Kernel 2's plain version vs the reference Pallas
    `ftp_spmm_fused_lif`: words (see NEAR_VTH) and the final U."""
    packed, w = _case(M, K, N, T, dtype)
    want_c, want_u = j_ops._spmm_fused(jnp.asarray(packed), jnp.asarray(w), T)
    a, b = words_to_torch(packed), to_torch(w)
    c, u = ftp_spmm.ftp_spmm_fused_lif(a, b, T)
    differ = _assert_words(c, want_c, ftp_spmm.ftp_spmm(a, b, T).numpy())
    np.testing.assert_allclose(u.numpy()[~differ], np.asarray(want_u)[~differ],
                               rtol=TOL, atol=TOL)


def test_dense_wrappers_check_inputs_and_have_no_fallback():
    packed, w = _case(5, 100, 70, 4, np.float32)
    a, b = words_to_torch(packed), to_torch(w)
    with pytest.raises(ValueError, match="int32"):
        ftp_spmm.ftp_spmm(a.float(), b, 4)
    with pytest.raises(ValueError, match="do not meet"):
        ftp_spmm.ftp_spmm(a, b[:-1], 4)
    with pytest.raises(ValueError, match="T <= 32"):
        ftp_spmm.ftp_spmm_fused_lif(a, b, 33)
    before = ftp_spmm.launch_counts()
    with pytest.raises(ValueError, match="no ftp_dense kernel"):
        ftp_spmm.ftp_spmm(a.to("meta"), b.to("meta"), 4)
    with pytest.raises(ValueError, match="no ftp_dense kernel"):
        ftp_spmm.ftp_spmm_fused_lif(a.to("meta"), b.to("meta"), 4)
    assert ftp_spmm.launch_counts() == before  # plain calls count nothing


# llama3.2-1b's two FFN GEMMs, and ragged shapes (a K below one 64-deep
# step, K tails inside a split, an empty last split, N off the 128-column
# tile)
TC_SHAPES = [(8192, 2048), (2048, 8192), (40, 72), (203, 136), (1000, 264),
             (320, 384), (320, 520), (100000, 8)]


@pytest.mark.parametrize("K,N", TC_SHAPES)
@pytest.mark.parametrize("T", [1, 3, 4, 16, 32])
def test_dense_tc_shape_is_independent_of_M(K, N, T):
    """The tensor-core instance's columns per block, instruction shape, K
    splits and split depth -- the order in which every output element is
    summed -- are the same for every M from 1 to 4096; only the block's
    rows (one m64 tile, or two warpgroups of two) grow with M, and they
    always hold T planes of a power-of-two number of spike rows."""
    shapes = [ftp_spmm.dense_tc_shape(M, K, N, T) for M in range(1, 4097)]
    order = {(s["bn"], s["mma"], s["splits"], s["k_split"]) for s in shapes}
    assert len(order) == 1, order
    bn, mma, splits, k_split = order.pop()
    assert bn == 128 and mma == "m64n128k16" and splits in (1, 2, 4, 8)
    # 64-deep steps covering K, each split the shortest that does
    assert k_split % 64 == 0 and splits * k_split >= K
    assert k_split - 64 < -(-K // splits)
    for s in shapes:
        assert s["rows"] in (64, 256) and s["bm"] & (s["bm"] - 1) == 0
        assert T <= s["rows"] // s["bm"] and s["bm"] <= s["rows"] // 4
    assert {s["rows"] for s in shapes} == {64, 256}
    # one warpgroup of one m64 tile exactly while it holds every row
    t_pad = shapes[0]["rows"] // shapes[0]["bm"]
    assert all((s["rows"] == 64) == (M * t_pad <= 64)
               for M, s in enumerate(shapes, 1))


@pytest.mark.parametrize("K,N,splits", [(8192, 2048, 4), (2048, 8192, 1)])
def test_dense_tc_shape_fills_the_card_at_decode(K, N, splits):
    """At the smallest M the serve's GEMMs split K until the grid has 64
    blocks (each a 64-row block streaming its weight slab; more splits
    cost prefill more in the splits' sum than they gain at decode) or the
    cluster is 8 deep: W_out (8192 -> 2048, 16 column tiles) over 4
    splits, W_in (2048 -> 8192, 64 column tiles) not split."""
    s = ftp_spmm.dense_tc_shape(1, K, N, 4)
    assert s["splits"] == splits and s["k_split"] == K // splits
    blocks = -(-N // s["bn"]) * s["splits"]
    assert blocks >= 64 or s["splits"] == 8
    assert s["rows"] == 64 and s["bm"] == 16


@pytest.mark.parametrize("dtype,N,aligned,want", [
    (torch.bfloat16, 2048, True, "tc"),
    (torch.bfloat16, 8, True, "tc"),
    (torch.bfloat16, 136, True, "tc"),
    (torch.bfloat16, 130, True, "simt"),   # rows not a multiple of 16 bytes
    (torch.bfloat16, 2048, False, "simt"),  # an unaligned base
    (torch.float32, 2048, True, "simt"),
    (torch.float32, 130, False, "simt"),
])
def test_dense_instance_routes_by_dtype_n_and_alignment(dtype, N, aligned, want):
    assert ftp_spmm.dense_instance(dtype, N, aligned) == want


def test_dense_instance_counts_start_at_zero_and_are_named():
    """launch_counts() keeps the four kernels' names and adds one count per
    dense and per BSR instance; all start at 0 and CPU calls (plain
    versions) move none."""
    ftp_spmm.reset_launch_counts()
    counts = ftp_spmm.launch_counts()
    assert tuple(counts)[:4] == ftp_spmm.KERNEL_NAMES
    assert counts == dict.fromkeys(
        ftp_spmm.KERNEL_NAMES + ("ftp_dense_tc", "ftp_dense_simt",
                                 "ftp_bsr_tc", "ftp_bsr_simt"), 0)
    packed, w = _case(5, 100, 72, 4, np.float32)
    a = words_to_torch(packed)
    for b in (to_torch(w), to_torch(w).to(torch.bfloat16)):
        ftp_spmm.ftp_spmm(a, b, 4)
        ftp_spmm.ftp_spmm_fused_lif(a, b, 4)
    assert ftp_spmm.launch_counts() == counts


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_dispatch_packed_dense_matches_reference(batched, fuse):
    """`ops.dispatch` under PACKED_DENSE, (M, K) and (B, M, K) operands,
    against the reference's dispatch under its PACKED_DENSE."""
    T, N = 4, 90
    packed, w = _case(24, 150, N, T, ml_dtypes.bfloat16)
    if batched:
        packed = packed.reshape(3, 8, 150)
    ja, jw = jnp.asarray(packed), jnp.asarray(w)
    a, b = words_to_torch(packed), to_torch(w)
    want = j_ops.dispatch(ja, jw, J_PACKED_DENSE, T, fuse_lif=fuse)
    got = ops.dispatch(a, b, PACKED_DENSE, T, fuse_lif=fuse)
    if not fuse:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        return
    o = ops.dispatch(a, b, PACKED_DENSE, T).numpy()
    o = o.reshape(T, -1, N)
    c, u = got
    assert c.shape == want[0].shape and u.shape == want[1].shape
    differ = _assert_words(c.reshape(-1, N), np.asarray(want[0]).reshape(-1, N), o)
    np.testing.assert_allclose(u.reshape(-1, N).numpy()[~differ],
                               np.asarray(want[1]).reshape(-1, N)[~differ],
                               rtol=TOL, atol=TOL)


def test_dispatch_dense_lossy_temporal_masks_the_operand():
    """Dense weights under adaptive(min_spikes=2): exactly the full route on
    `mask_low_activity_timesteps(input)` (the dense kernels have no
    timestep gate), and the reference's lossy dense route within TOL."""
    T, M, K, N = 8, 32, 128, 64
    rng = np.random.default_rng(11)
    packed, w = _mk(rng, T, M, K, N, density=0.15, w_density=0.2)
    packed &= ~np.uint32((1 << 1) | (1 << 3) | (1 << 6) | (1 << 7))
    packed[rng.integers(M), rng.integers(K)] |= np.uint32(1 << 1)
    a, b = words_to_torch(packed), to_torch(w)
    lossy = ExecutionPolicy(spike_format="packed", temporal=adaptive_t(2),
                            exactness=approximate(8.0))
    masked = mask_low_activity_timesteps(a, T, 2)
    assert not torch.equal(masked, a)
    for fuse in (True, False):
        got = ops.dispatch(a, b, lossy, T, fuse_lif=fuse)
        want = ops.dispatch(masked, b, PACKED_DENSE, T, fuse_lif=fuse)
        for g, m in zip(got if fuse else (got,), want if fuse else (want,)):
            assert torch.equal(g, m)
    j_lossy = JPolicy(spike_format="packed", temporal=j_adaptive_t(2),
                      exactness=j_approximate(8.0))
    jo = j_ops.dispatch(jnp.asarray(packed), jnp.asarray(w), j_lossy, T)
    np.testing.assert_allclose(ops.dispatch(a, b, lossy, T).numpy(),
                               np.asarray(jo), rtol=TOL, atol=TOL)
    # min_spikes=1 is the identity on the operand
    exact = ExecutionPolicy(spike_format="packed", temporal=adaptive_t())
    assert torch.equal(ops.dispatch(a, b, exact, T),
                       ops.dispatch(a, b, PACKED_DENSE, T))


# ---------------------------------------------------------------------------
# spiking layers in infer mode without plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ffn_params():
    jparams = j_snn.init_spiking_ffn(jax.random.PRNGKey(3), 64, 256,
                                     weight_density=0.3, prune_block=(32, 64))
    tparams = {k: bridge.to_torch(np.asarray(v)) for k, v in jparams.items()}
    return jparams, tparams


def _x(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 2).astype(np.float32)


# ``use_kernel`` picks the reference's route (its Pallas kernel in interpret
# mode, or its plain `ftp_layer`); the port's route follows the device alone,
# so on the CPU it runs its plain version against both.

@pytest.mark.parametrize("use_kernel", [False, True])
def test_spiking_linear_infer_matches_reference(ffn_params, use_kernel):
    """One LoAS layer on packed words: the port's plain `ftp_layer` (CPU
    words) against either route of the reference; words equal."""
    from repro.core.lif import direct_encode
    from repro.core.packing import pack_spikes

    jparams, tparams = ffn_params
    words = np.asarray(pack_spikes(direct_encode(jnp.asarray(_x(5, 21, 64)), 4)))
    want = j_snn.spiking_linear_infer(jnp.asarray(words), jparams["w_in"],
                                      j_snn.SpikingConfig(T=4),
                                      use_kernel=use_kernel)
    got = t_snn.spiking_linear_infer(words_to_torch(words), tparams["w_in"],
                                     t_snn.SpikingConfig(T=4))
    assert int((words_to_numpy(got) != np.asarray(want)).sum()) == 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spiking_ffn_apply_infer_without_plans_matches_reference(
        ffn_params, use_kernel):
    """`spiking_ffn_apply(mode='infer')` with no plans: both GEMMs against
    the dense weights; outputs within TOL of either route of the
    reference."""
    jparams, tparams = ffn_params
    x = _x(6, 3, 7, 64)
    cfg_j = j_snn.SpikingConfig(T=4, weight_density=0.3)
    cfg_t = t_snn.SpikingConfig(T=4, weight_density=0.3)
    want = j_snn.spiking_ffn_apply(jparams, jnp.asarray(x), cfg_j, mode="infer",
                                   use_kernel=use_kernel)
    got = t_snn.spiking_ffn_apply(tparams, torch.from_numpy(x), cfg_t,
                                  mode="infer")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_spiking_layers_on_cpu_words_launch_nothing(ffn_params):
    """The route follows the words' device: on the CPU the infer layers
    without plans run the plain version and no kernel's count moves."""
    _, tparams = ffn_params
    words = words_to_torch(_mk(np.random.default_rng(8), 4, 9, 64, 8)[0])
    cfg = t_snn.SpikingConfig(T=4)
    before = ftp_spmm.launch_counts()
    t_snn.spiking_linear_infer(words, tparams["w_in"], cfg)
    t_snn.spiking_ffn_apply_packed(tparams, words, cfg)
    t_snn.spiking_ffn_apply(tparams, torch.from_numpy(_x(9, 5, 64)), cfg,
                            mode="infer")
    assert ftp_spmm.launch_counts() == before


@pytest.mark.parametrize("route", ["plans", "dense"])
def test_spiking_ffn_apply_packed_matches_reference(ffn_params, route):
    """The spike-domain FFN (packed words in, analog out + packed hidden
    words): hidden words equal, outputs within TOL, with plans (the BSR
    route) and without (`ftp_layer` against the dense weights)."""
    from repro.core.lif import direct_encode
    from repro.core.packing import pack_spikes

    jparams, tparams = ffn_params
    words = np.asarray(pack_spikes(direct_encode(jnp.asarray(_x(7, 2, 9, 64)), 4)))
    cfg_j = j_snn.SpikingConfig(T=4, weight_density=0.3)
    cfg_t = t_snn.SpikingConfig(T=4, weight_density=0.3)
    if route == "plans":
        jparams = j_snn.attach_join_plans(jparams, cfg_j)
        tparams = t_snn.attach_join_plans(tparams, cfg_t)
    jy, jh = j_snn.spiking_ffn_apply_packed(jparams, jnp.asarray(words), cfg_j)
    ty, th = t_snn.spiking_ffn_apply_packed(tparams, words_to_torch(words), cfg_t)
    assert th.shape == jh.shape and ty.shape == jy.shape
    assert int((words_to_numpy(th) != np.asarray(jh)).sum()) == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the smoke slice served under weight_sparsity='dense'
# ---------------------------------------------------------------------------

B, P, GEN = 2, 8, 4


@pytest.fixture(scope="module")
def slice_models():
    jcfg = dataclasses.replace(
        smoke_variant(get_config("llama3_2_1b")), spiking_ffn=True,
        spiking_weight_density=0.3,
    )
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                        weight_density=0.3)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, t_build(tcfg), tp)


def test_engine_dense_route_tokens_match_reference_and_dual(slice_models):
    """The engine under PACKED_DENSE (no join plans) emits the reference
    engine's tokens under its PACKED_DENSE route, and the port's own
    dual-sparse engine's tokens for the same params."""
    (jcfg, jm, jp), (tcfg, tm, tp) = slice_models
    prompts = list(np.random.default_rng(3).integers(
        0, jcfg.vocab, size=(B, P)).astype(np.int32))
    want = JEngine(jm, jp, max_len=P + GEN, max_slots=B,
                   policy=JPolicy.for_arch(jcfg, weight_sparsity="dense")
                   ).generate_batch(prompts, GEN)
    dense = Engine(tm, tp, max_len=P + GEN, max_slots=B, device="cpu",
                   policy=ExecutionPolicy.for_arch(tcfg, weight_sparsity="dense"))
    got = dense.generate_batch(prompts, GEN)
    dual = Engine(tm, tp, max_len=P + GEN, max_slots=B, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg)).generate_batch(prompts, GEN)
    for w, g, d in zip(want, got, dual):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)
    s = dense.summary()
    assert s["dual_sparse"] is False and s["total_tokens"] == B * GEN
    assert "plan_in" not in dense.params["layers"][0]["mlp"]
