"""The port's temporal axis against the JAX reference, on the CPU: the
timestep scorers of `core.packing`, the policy's temporal/exactness axes
and parity helpers, kernel 4's plain version (the BSR kernel gated by a
timestep-activity map), the BSR plain version at T > 8, and the engine's
``timesteps_skipped`` count.

Tolerances:
* packing, policy decisions, skip counts and served tokens: exact;
* kernel 4 against kernel 3 in the port: equal (``torch.equal``) at
  min_spikes=1, and equal to kernel 3 on the masked input at min_spikes=2 —
  a gated plane adds nothing, and every other add is the same;
* the port against the reference: within 1e-5 of the `repro.kernels.ref`
  oracles (f32 sums of the same exact products in another order).  On this
  host the reference's own Pallas adaptive kernel differs from its folded
  kernel by 1 ulp (ROADMAP "Reference caveats"), so the oracles, not the
  Pallas output, are the reference here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro.configs import get_config, smoke_variant
from repro.core import packing as j_packing
from repro.kernels import ref as j_ref
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import policy as j_policy
from repro_torch import bridge
from repro_torch.bridge import words_to_numpy, words_to_torch
from repro_torch.core import packing as t_packing
from repro_torch.kernels import ftp_spmm, ops
from repro_torch.kernels.join_plan import build_weight_plan
from repro_torch.launch.serve import build_config
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    PACKED_DUAL,
    PACKED_DUAL_ADAPTIVE,
    Engine,
    Exactness,
    ExecutionPolicy,
    ParityError,
    Temporal,
    adaptive_t,
    approximate,
    check_parity,
    drift_report,
    max_logit_drift,
)

torch.set_num_threads(1)

TOL = 1e-5


def _words(rng, shape, T, silent=()):
    """Random uint32 words with every bit (31 included) in play, planes in
    ``silent`` cleared below T."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    for t in silent:
        w &= ~np.uint32(1 << t)
    return w


# ---------------------------------------------------------------------------
# packing: the timestep scorers, exact at every T up to 32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 4, 8, 16, 31, 32])
def test_timestep_popcount_and_activity_map_exact(T):
    rng = np.random.default_rng(T)
    w = _words(rng, (13, 37), T, silent=range(0, T, 3))
    got = t_packing.timestep_popcount(words_to_torch(w), T)
    want = np.asarray(j_packing.timestep_popcount(jnp.asarray(w), T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 2, 200):
        np.testing.assert_array_equal(
            t_packing.timestep_activity_map(words_to_torch(w), T, k).numpy(),
            np.asarray(j_packing.timestep_activity_map(jnp.asarray(w), T, k)))


@pytest.mark.parametrize("T", [1, 4, 8, 16, 31, 32])
@pytest.mark.parametrize("min_spikes", [1, 2, 5])
def test_mask_low_activity_timesteps_exact(T, min_spikes):
    """Bit-exact with the reference; bits at t >= T are preserved; the
    identity at min_spikes=1; idempotent."""
    rng = np.random.default_rng(100 * T + min_spikes)
    w = _words(rng, (9, 21), T, silent=range(1, T, 4))
    # a plane with exactly one spike, which min_spikes >= 2 must drop
    if T > 2:
        w &= ~np.uint32(1 << 2)
        w[3, 5] |= np.uint32(1 << 2)
    a = words_to_torch(w)
    got = t_packing.mask_low_activity_timesteps(a, T, min_spikes)
    want = np.asarray(j_packing.mask_low_activity_timesteps(jnp.asarray(w), T,
                                                            min_spikes))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    if T < 32:
        above = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << T) - 1)
        np.testing.assert_array_equal(words_to_numpy(got) & above, w & above)
    if min_spikes == 1:
        assert torch.equal(got, a)
    assert torch.equal(t_packing.mask_low_activity_timesteps(got, T, min_spikes),
                       got)


# ---------------------------------------------------------------------------
# policy: the temporal and exactness axes, as the reference validates them
# ---------------------------------------------------------------------------

def test_temporal_axis_validated_and_described():
    assert Temporal().describe() == "full"
    assert adaptive_t().describe() == "adaptive(min_spikes=1)"
    assert adaptive_t(3).describe() == "adaptive(min_spikes=3)"
    assert not Temporal().enabled
    assert adaptive_t().enabled and not adaptive_t().lossy
    assert adaptive_t(2).lossy
    for bad in (dict(mode="sometimes"), dict(min_spikes=0),
                dict(mode="full", min_spikes=2)):
        with pytest.raises(ValueError):
            Temporal(**bad)
        with pytest.raises(ValueError):
            j_policy.Temporal(**bad)


def test_exactness_axis_validated():
    assert Exactness() == Exactness("bitwise")
    assert approximate(0.2) == Exactness("approximate", 0.2)
    for bad in (dict(mode="close"), dict(mode="approximate", tol=0.0),
                dict(mode="bitwise", tol=0.1)):
        with pytest.raises(ValueError):
            Exactness(**bad)
        with pytest.raises(ValueError):
            j_policy.Exactness(**bad)


def test_adaptive_requires_packed_spikes():
    with pytest.raises(ValueError, match="packed"):
        ExecutionPolicy(spike_format="float", temporal=adaptive_t())


def test_lossy_requires_approximate_contract():
    ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                    temporal=adaptive_t())
    with pytest.raises(ValueError, match="approximate"):
        ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                        temporal=adaptive_t(2))
    pol = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                          temporal=adaptive_t(2), exactness=approximate(1.0))
    assert pol.temporal.lossy and not pol.token_identical
    assert "temporal=adaptive(min_spikes=2)" in pol.describe()


def test_approximate_without_lossy_temporal_needs_the_mesh_slice():
    """Both packages refuse this single-device combination with a
    ValueError: approximate needs a model axis (psum-TP) or lossy temporal
    skipping."""
    with pytest.raises(ValueError, match="model axis"):
        j_policy.ExecutionPolicy(spike_format="packed",
                                 weight_sparsity="dual_sparse",
                                 exactness=j_policy.approximate(0.05))
    with pytest.raises(ValueError, match="model axis"):
        ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                        exactness=approximate(0.05))


def test_preset_and_for_arch_temporal():
    assert PACKED_DUAL_ADAPTIVE.temporal.enabled
    cfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                       weight_density=0.3)
    pol = ExecutionPolicy.for_arch(cfg, temporal=adaptive_t())
    assert pol.temporal.enabled and pol.spike_format == "packed"
    assert ExecutionPolicy.for_arch(cfg).temporal == Temporal()
    dense = ExecutionPolicy.for_arch(cfg, weight_sparsity="dense")
    assert dense.spike_format == "packed" and dense.weight_sparsity == "dense"


def test_parity_helpers_match_reference():
    """`max_logit_drift`, `drift_report` and `check_parity` give the
    reference's numbers and decisions on the same traces."""
    rng = np.random.default_rng(0)
    ref_tok = [rng.integers(0, 9, 5), rng.integers(0, 9, 4)]
    got_tok = [ref_tok[0].copy(), ref_tok[1].copy()]
    got_tok[1][2] += 1  # a flip: later steps are not compared
    ref_log = [list(rng.normal(size=(5, 7))), list(rng.normal(size=(4, 7)))]
    got_log = [[r + rng.normal(size=7) * 0.01 for r in req] for req in ref_log]
    for i in range(2):
        assert max_logit_drift(ref_tok[i], got_tok[i], ref_log[i], got_log[i]) == \
            j_policy.max_logit_drift(ref_tok[i], got_tok[i], ref_log[i], got_log[i])
    assert drift_report(ref_tok, got_tok, ref_log, got_log) == \
        j_policy.drift_report(ref_tok, got_tok, ref_log, got_log)
    pol = ExecutionPolicy(spike_format="packed", temporal=adaptive_t(2),
                          exactness=approximate(0.5))
    jpol = j_policy.ExecutionPolicy(spike_format="packed",
                                    temporal=j_policy.adaptive_t(2),
                                    exactness=j_policy.approximate(0.5))
    rep = check_parity(pol, ref_tok, got_tok, ref_logits=ref_log,
                       got_logits=got_log)
    assert rep == j_policy.check_parity(jpol, ref_tok, got_tok,
                                        ref_logits=ref_log, got_logits=got_log)
    assert rep["token_identical"] is False
    with pytest.raises(ParityError):
        check_parity(PACKED_DUAL, ref_tok, got_tok)
    tight = dataclasses.replace(pol, exactness=approximate(1e-6))
    with pytest.raises(ParityError):
        check_parity(tight, ref_tok, got_tok, ref_logits=ref_log,
                     got_logits=got_log)


# ---------------------------------------------------------------------------
# kernel 4's plain version, and the BSR plain version at T > 8
# ---------------------------------------------------------------------------

def _bursty(rng, T, M, K, N, silent, density=0.25, w_density=0.05):
    packed, w = _mk(rng, T, M, K, N, density=density, w_density=w_density)
    keep = np.uint32(0)
    for t in range(T):
        if t not in silent:
            keep |= np.uint32(1) << np.uint32(t)
    return (packed & keep).astype(np.uint32), w


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T", [8, 16, 32])
def test_adaptive_bsr_equals_full_at_min_spikes_1(T, fuse, batched):
    """With most planes silent, kernel 4's plain version equals kernel 3's
    (``torch.equal``) and the reference oracle within TOL."""
    rng = np.random.default_rng(42 + T)
    M, K, N = 48, 160, 96
    packed, w = _bursty(rng, T, M, K, N, silent=set(range(1, T, 2)) | {0})
    plan = build_weight_plan(torch.from_numpy(w))
    a = words_to_torch(packed)
    if batched:
        a = a.reshape(3, 16, K)
    out_a, u_a = ops.dispatch(a, plan, PACKED_DUAL_ADAPTIVE, T, n_out=N,
                              fuse_lif=fuse)
    out_f, u_f = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=N, fuse_lif=fuse)
    assert torch.equal(out_a, out_f) and torch.equal(u_a, u_f)
    ja, jw = jnp.asarray(packed), jnp.asarray(w)
    if fuse:
        cw, uw = j_ref.ftp_spmm_fused_lif_ref(ja, jw, T)
        assert int((words_to_numpy(out_a).reshape(M, N) != np.asarray(cw)).sum()) == 0
        np.testing.assert_allclose(u_a.reshape(M, N).numpy(), np.asarray(uw),
                                   rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(out_a.reshape(T, M, N).numpy(),
                                   np.asarray(j_ref.ftp_spmm_ref(ja, jw, T)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [8, 16])
def test_lossy_bsr_equals_full_on_masked_input(T):
    """min_spikes=2: exactly kernel 3 applied to
    `mask_low_activity_timesteps(input, T, 2)`."""
    rng = np.random.default_rng(11)
    M, K, N = 32, 128, 64
    packed, w = _mk(rng, T, M, K, N, density=0.15, w_density=0.2)
    packed &= ~np.uint32((1 << 1) | (1 << 3) | (1 << 6) | (1 << 7))
    packed[rng.integers(M), rng.integers(K)] |= np.uint32(1 << 1)
    packed[rng.integers(M), rng.integers(K)] |= np.uint32(1 << 3)
    lossy = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                            temporal=adaptive_t(2), exactness=approximate(8.0))
    plan = build_weight_plan(torch.from_numpy(w))
    a = words_to_torch(packed)
    masked = t_packing.mask_low_activity_timesteps(a, T, 2)
    assert not torch.equal(masked, a), "no low-activity plane: vacuous"
    for fuse in (True, False):
        out_l, u_l = ops.dispatch(a, plan, lossy, T, n_out=N, fuse_lif=fuse)
        out_m, u_m = ops.dispatch(masked, plan, PACKED_DUAL, T, n_out=N,
                                  fuse_lif=fuse)
        assert torch.equal(out_l, out_m) and torch.equal(u_l, u_m)


def test_bsr_plain_at_T16_matches_reference():
    """The BSR kernel's plain version at T = 16 (the reference's adaptive
    bench depth) against the reference oracles, 256-wide blocks."""
    T, M, K, N = 16, 40, 512, 256
    rng = np.random.default_rng(16)
    packed, w = _bursty(rng, T, M, K, N, silent=set(range(12)), density=0.15,
                        w_density=0.03)
    plan = build_weight_plan(torch.from_numpy(w), bk=256, bn=256)
    a, ja, jw = words_to_torch(packed), jnp.asarray(packed), jnp.asarray(w)
    c, u = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=N, fuse_lif=True)
    cw, uw = j_ref.ftp_spmm_fused_lif_ref(ja, jw, T)
    assert int((words_to_numpy(c) != np.asarray(cw)).sum()) == 0
    np.testing.assert_allclose(u.numpy(), np.asarray(uw), rtol=TOL, atol=TOL)
    o, _ = ops.dispatch(a, plan, PACKED_DUAL, T, n_out=N)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_ref.ftp_spmm_ref(ja, jw, T)),
                               rtol=TOL, atol=TOL)


def test_adaptive_wrapper_checks_its_map():
    rng = np.random.default_rng(3)
    packed, w = _mk(rng, 4, 8, 64, 32, w_density=0.3)
    plan = build_weight_plan(torch.from_numpy(w))
    a = words_to_torch(packed)
    args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
            ops._activity(a, 4, plan), 32, 4)
    with pytest.raises(ValueError, match="tmap"):
        ftp_spmm.ftp_spmm_bsr(*args, bm=4, tmap=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ftp_spmm.ftp_spmm_bsr(*args, bm=4, tmap=torch.ones(4))
    before = ftp_spmm.launch_counts()
    c, _ = ftp_spmm.ftp_spmm_bsr(*args, bm=4, tmap=torch.zeros(4, dtype=torch.int32))
    assert not c.any()  # every plane gated: no current, no spike
    assert ftp_spmm.launch_counts() == before  # plain calls count nothing


# ---------------------------------------------------------------------------
# serving: tokens and the timestep skip count against the reference engine
# ---------------------------------------------------------------------------

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


def _x_prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in (9, 5, 12)]


@pytest.mark.parametrize("weight_sparsity,min_spikes", [
    ("dual_sparse", 1), ("dual_sparse", 2), ("dense", 1)])
def test_engine_adaptive_tokens_and_skips_match_reference(
        slice_models, weight_sparsity, min_spikes):
    """The engine under a temporal policy emits the reference engine's
    tokens and counts the same skippable timestep planes; the served model
    walks every plane (reference caveat), so the tokens also equal the
    full-temporal engine's."""
    (jcfg, jm, jp), (tcfg, tm, tp) = slice_models
    prompts = _x_prompts(jcfg.vocab)
    lossy = min_spikes > 1
    jpol = JPolicy.for_arch(
        jcfg, weight_sparsity=weight_sparsity,
        temporal=j_policy.adaptive_t(min_spikes),
        exactness=j_policy.approximate(1.0) if lossy else None)
    tpol = ExecutionPolicy.for_arch(
        tcfg, weight_sparsity=weight_sparsity, temporal=adaptive_t(min_spikes),
        exactness=approximate(1.0) if lossy else None)
    je = JEngine(jm, jp, max_len=20, max_slots=4, policy=jpol)
    want = je.generate_batch(prompts, 6)
    engine = Engine(tm, tp, max_len=20, max_slots=4, policy=tpol, device="cpu",
                    capture_logits=lossy)
    got = engine.generate_batch(prompts, 6)
    full = Engine(tm, tp, max_len=20, max_slots=4, device="cpu",
                  policy=ExecutionPolicy.for_arch(
                      tcfg, weight_sparsity=weight_sparsity)
                  ).generate_batch(prompts, 6)
    for w, g, f in zip(want, got, full):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)
    s = engine.summary()
    assert s["timesteps_skipped"] == je.metrics.timesteps_skipped > 0
    assert s["temporal"] == je.summary()["temporal"] == tpol.temporal.describe()
    assert s["exactness"] == ("approximate" if lossy else "bitwise")
    assert s["token_identical"] is (not lossy)
    traces = engine.drain_logit_traces()
    assert len(traces) == (3 if lossy else 0) and engine.logit_traces == {}


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging", ["dense", "paged"])
def test_adaptive_token_identity_matrix_mesh(slice_models, execution, paging):
    """The ``placement=mesh`` cells of the reference's adaptive matrix:
    adaptive(min_spikes=1) on a data=4 x model=2 mesh of logical CPU
    devices (each data group scores its own rows' planes) emits the
    full-temporal single-device engine's tokens."""
    from repro_torch.launch.mesh import LogicalDevice
    from repro_torch.serve import Placement, make_serve_mesh, paged

    (jcfg, jm, jp), (tcfg, tm, tp) = slice_models
    mesh = make_serve_mesh("data=4,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(8)])
    prompts = _x_prompts(tcfg.vocab)
    full = Engine(tm, tp, max_len=24, max_slots=4, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg)
                  ).generate_batch(prompts, 6)
    engine = Engine(tm, tp, max_len=24, max_slots=4, device="cpu",
                    policy=ExecutionPolicy.for_arch(
                        tcfg, temporal=adaptive_t(), execution=execution,
                        paging=paged(8) if paging == "paged" else None,
                        placement=Placement(mesh=mesh)))
    got = engine.generate_batch(prompts, 6)
    for a, b in zip(full, got):
        np.testing.assert_array_equal(a, b)
    assert engine.metrics.timesteps_skipped > 0
    assert engine.summary()["temporal"] == "adaptive(min_spikes=1)"


def test_record_timestep_skips_counts_planes(slice_models):
    """With T=4 and words whose only set bit is t0, exactly the 3 silent
    planes count; a full-temporal engine counts nothing."""
    _, (tcfg, tm, tp) = slice_models
    engine = Engine(tm, tp, max_len=16, device="cpu",
                    policy=ExecutionPolicy.for_arch(tcfg, temporal=adaptive_t()))
    words = words_to_torch(np.array([[1, 0, 0], [0, 0, 0]], np.uint32))
    engine.record_timestep_skips(words)
    assert engine.summary()["timesteps_skipped"] == tcfg.spiking_T - 1
    engine.record_timestep_skips(torch.zeros((0,), dtype=torch.int32))
    assert engine.summary()["timesteps_skipped"] == tcfg.spiking_T - 1
    engine.metrics.reset()
    assert engine.summary()["timesteps_skipped"] == 0
    full = Engine(tm, tp, max_len=16, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg))
    full.record_timestep_skips(words)
    assert full.summary()["timesteps_skipped"] == 0
    assert full.summary()["temporal"] == "full"
