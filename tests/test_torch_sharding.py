"""The port's serve mesh (`repro_torch.serve.sharding`, `launch.mesh`, the
sharded entries of `kernels.ops`, `join_plan.split_plan` / `shard_plan`,
the meshed `Engine`) against the JAX reference, on the CPU: the cases of
`tests/test_serve_sharding.py`.

The port's mesh is a grid of logical devices in one process; here eight of
them map onto the CPU, as the reference's tests run on eight fake XLA host
devices (`tests/conftest.py`).  Held:
* mesh specs, block picks and the plans' fields: equal to the reference's;
* the sharded BSR route (fused and full sums, rows dividing the data axis
  and not) and the sharded dense route: equal to the port's unsharded
  call bit for bit, and to the reference's sharded call on its eight
  devices (spike words exactly, sums and U within 1e-5: f32 sums of the
  same products, the tolerance of `tests/test_torch_kernels.py`);
* the meshed engine at data=4 x model=2 and at the two axis extremes:
  tokens and captured logits bit for bit the port's single-device serve,
  tokens equal to the reference's single-device engine (the reference's
  engine is not run on a mesh: it aborts in JAX's CPU gather);
* no join-plan or kernel build after the first step (the port's
  counterpart of "no retrace").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _data import mk_packed_and_weights as _mk

from repro.configs import get_config, smoke_variant
from repro.kernels import join_plan as j_join
from repro.kernels import ops as j_ops
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import make_serve_mesh as j_make_serve_mesh
from repro.serve import parse_mesh_spec as j_parse_mesh_spec
from repro.serve.policy import Placement as JPlacement
from repro_torch import bridge
from repro_torch.bridge import words_to_numpy, words_to_torch
from repro_torch.kernels import ftp_spmm, ops, ref
from repro_torch.kernels.join_plan import (
    ShardedWeightJoinPlan,
    build_sharded_weight_plan,
    build_weight_plan,
    pick_shard_blocks,
    shard_plan,
    split_plan,
    stack_plans,
)
from repro_torch.launch.mesh import (
    LogicalDevice,
    Mesh,
    data_groups,
    force_fake_devices,
    logical_devices,
    make_mesh_for,
)
from repro_torch.launch.serve import build_config
from repro_torch.models import layers as model_layers
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import Engine, ExecutionPolicy, Placement
from repro_torch.serve.policy import (
    PACKED_DENSE,
    PACKED_DUAL,
    approximate,
)
from repro_torch.serve.sharding import (
    MODEL_SHARDED_DIMS,
    cache_sharding,
    make_serve_mesh,
    mesh_summary,
    parse_mesh_spec,
    place_cache,
    place_plans,
    shard_vocab,
)

torch.set_num_threads(1)

CPU8 = [LogicalDevice(i, torch.device("cpu")) for i in range(8)]


def _mesh(spec):
    return make_serve_mesh(spec, devices=CPU8)


def _mesh_policy(mesh, cfg=None, **over):
    if cfg is not None:
        return ExecutionPolicy.for_arch(cfg, placement=Placement(mesh=mesh),
                                        **over)
    return ExecutionPolicy(placement=Placement(mesh=mesh), **over)


# ---------------------------------------------------------------------------
# mesh spec / construction
# ---------------------------------------------------------------------------

def test_parse_mesh_spec_forms():
    for spec, n in (("data,model", 8), ("data=4,model=2", 8), ("4,2", 8),
                    ("data=2,model", 8), ("data,model=4", 8),
                    ("data,model", 1), ("data,model", 6)):
        assert parse_mesh_spec(spec, n) == j_parse_mesh_spec(spec, n)
    assert parse_mesh_spec("data,model", 8) == (4, 2)
    assert parse_mesh_spec("data=2,model", 8) == (2, 4)
    for bad in ("data", "model,data", "data=8,model=2", "data=-1,model=2",
                "data=0,model=2"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, 8)
        with pytest.raises(ValueError):
            j_parse_mesh_spec(bad, 8)


def test_make_serve_mesh_and_single_device_fallback():
    prev = force_fake_devices(8)
    try:
        mesh = make_serve_mesh("data,model", device="cpu")
        assert mesh.shape == {"data": 4, "model": 2}
        assert [d.id for d in mesh.devices.flat] == list(range(8))
        assert mesh.physical_devices() == [torch.device("cpu")]
        assert mesh_summary(mesh) == {"mesh": "data=4xmodel=2",
                                      "mesh_devices": 8,
                                      "mesh_physical_devices": 1}
        assert make_mesh_for(8, device="cpu").shape == {"data": 4, "model": 2}
    finally:
        force_fake_devices(prev)
    assert len(logical_devices("cpu")) == 1
    assert make_serve_mesh("data,model", devices=CPU8[:1]) is None
    assert make_serve_mesh(None, devices=CPU8) is None
    assert make_serve_mesh("data=1,model=1", devices=CPU8) is None
    # no silent fallback: a spec that needs more devices than exist raises
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_serve_mesh("data=8,model=2", devices=CPU8)
    # a mesh row is the (1, model) mesh one data group runs on
    row = _mesh("data=4,model=2").row(2)
    assert row.shape == {"data": 1, "model": 2}
    assert [d.id for d in row.devices.flat] == [4, 5]
    assert mesh_summary(None)["mesh"] is None
    with pytest.raises(ValueError, match="appears twice"):
        Mesh([[CPU8[0], CPU8[0]]])


# ---------------------------------------------------------------------------
# plan column-splitting
# ---------------------------------------------------------------------------

def test_pick_shard_blocks_shrinks_bn_for_tiny_layers():
    cases = [(64, 128, 1), (64, 128, 2), (128, 64, 2), (64, 128, 4),
             (2048, 8192, 2), (8192, 2048, 4), (96, 192, 2)]
    for K, N, s in cases:
        assert pick_shard_blocks(K, N, s) == j_join.pick_shard_blocks(K, N, s)
    assert pick_shard_blocks(64, 128, 1) == (64, 128)
    assert pick_shard_blocks(64, 128, 2) == (64, 64)
    assert pick_shard_blocks(128, 64, 2) == (128, 32)
    assert pick_shard_blocks(64, 128, 4) == (64, 32)


def _fields_equal(tp, jp):
    for f in ("kidx", "vidx", "cnt", "bmap"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tp.payload.float().numpy(),
                                  np.asarray(jp.payload, np.float32))


@pytest.mark.parametrize("parts", [2, 4])
def test_split_plan_slabs_reconstruct_dense_result(parts):
    """Each slab is a self-contained plan for its contiguous column range:
    its fields equal the reference's slab, field for field, and running
    the kernel slab by slab and concatenating equals the dense result
    exactly."""
    rng = np.random.default_rng(0)
    T, M, K, N = 4, 16, 96, 256
    packed, w = _mk(rng, T, M, K, N, w_density=0.15)
    plan = build_sharded_weight_plan(torch.from_numpy(w), parts)
    jplan = j_join.build_sharded_weight_plan(w, parts)
    _fields_equal(plan, jplan)
    subs = split_plan(plan, parts)
    jsubs = j_join.split_plan(jplan, parts)
    assert len(subs) == parts
    for tp, jp in zip(subs, jsubs):
        _fields_equal(tp, jp)
    a = words_to_torch(packed)
    outs = [ops.dispatch(a, p, PACKED_DUAL, T, fuse_lif=True)[0]
            for p in subs]
    got = torch.cat(outs, dim=-1)[:, :N]
    want, _ = ref.ftp_spmm_fused_lif_ref(a, torch.from_numpy(w), T)
    assert torch.equal(got, want)
    # stacked: the reference's shard_plan, field for field, plus the parent
    sp = shard_plan(plan, parts)
    _fields_equal(sp, j_join.shard_plan(jplan, parts))
    assert isinstance(sp, ShardedWeightJoinPlan) and sp.shards == parts


def test_split_plan_rejects_indivisible():
    rng = np.random.default_rng(1)
    _, w = _mk(rng, 2, 8, 32, 48)
    plan = build_weight_plan(torch.from_numpy(w), bk=32, bn=16)  # 3 blocks
    with pytest.raises(ValueError, match="3 column blocks"):
        split_plan(plan, 2)
    with pytest.raises(ValueError):
        j_join.split_plan(j_join.build_weight_plan(w, bk=32, bn=16), 2)


def test_shard_plan_records_parent_launch_shape():
    """A slab launches with its parent plan's shape: `shard_plan` records
    the parent's (nnb, jmax), and the tensor-core split count and slots a
    rank the whole plan would launch with (a slab's own geometry gives
    others, summing each element in another order on the card)."""
    g = torch.Generator().manual_seed(3)
    # llama3.2-1b's W_in geometry, narrowed: 64 column blocks of 128
    w = torch.randn(1024, 8192, generator=g)
    w[torch.rand(1024, 8192, generator=g) > 0.05] = 0
    w = w.to(torch.bfloat16)
    plan = build_sharded_weight_plan(w, 2)
    sp = shard_plan(plan, 2)
    assert sp.parent == (plan.nnb, plan.jmax) == (64, plan.jmax)
    whole = ftp_spmm.bsr_tc_shape(plan.nnb, plan.bn, plan.jmax, 4, 4)
    # what `ftp_spmm.ftp_spmm_bsr(parent=sp.parent)` launches every slab with
    assert ftp_spmm.bsr_tc_shape(sp.parent_nnb, sp.bn, sp.parent_jmax, 4,
                                 4) == whole
    own = ftp_spmm.bsr_tc_shape(sp.nnb, sp.bn, sp.jmax, 4, 4)
    assert own["splits"] != whole["splits"]  # why the parent's is recorded
    # every slab fits the parent's shape: splits x slots covers its jmax
    assert sp.jmax <= plan.jmax <= whole["splits"] * whole["slots_per_rank"]
    # stacking layers keeps the type and the widest parent
    st = stack_plans([sp, sp])
    assert isinstance(st, ShardedWeightJoinPlan) and st.parent == sp.parent


def test_slab_payload_is_aligned_and_contiguous():
    """A slab is a view of the stacked payload at a whole number of (bk,
    bn) blocks from its base: contiguous, with a 16-byte aligned base (what
    the BSR kernels' tensor-core instance needs; an unaligned base would
    run SIMT)."""
    rng = np.random.default_rng(4)
    _, w = _mk(rng, 4, 8, 256, 512, w_density=0.3)
    sp = shard_plan(build_sharded_weight_plan(
        torch.from_numpy(w).to(torch.bfloat16), 4), 4)
    for j in range(4):
        slab = sp.slab(j)
        assert slab.payload.is_contiguous()
        assert slab.payload.data_ptr() % 16 == 0
        assert ftp_spmm.bsr_instance(slab.payload.dtype, slab.bk, slab.bn,
                                     slab.payload.data_ptr() % 16 == 0) == "tc"
    with pytest.raises(ValueError, match="slice the layer axis"):
        stack_plans([sp, sp]).slab(0)


# ---------------------------------------------------------------------------
# sharded kernel entries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def j_mesh():
    return j_make_serve_mesh("data=4,model=2")


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("M", [32, 30])  # 30: rows don't divide `data`
def test_sharded_bsr_matches_unsharded(fuse, M, j_mesh):
    mesh = _mesh("data=4,model=2")
    rng = np.random.default_rng(2)
    T, K, N = 4, 96, 192
    packed, w = _mk(rng, T, M, K, N, w_density=0.1)
    a = words_to_torch(packed)
    c0, u0 = ops.dispatch(a, build_weight_plan(torch.from_numpy(w)),
                          PACKED_DUAL, T, n_out=N, fuse_lif=fuse)
    sp = shard_plan(build_sharded_weight_plan(torch.from_numpy(w), 2), 2)
    ftp_spmm.reset_launch_counts()
    c1, u1 = ops.dispatch(a, sp, _mesh_policy(
        mesh, spike_format="packed", weight_sparsity="dual_sparse"),
        T, n_out=N, fuse_lif=fuse)
    assert torch.equal(c0, c1) and torch.equal(u0, u1)
    # the reference's shard_map entry on its eight fake devices
    jsp = j_join.shard_plan(j_join.build_sharded_weight_plan(w, 2), 2)
    jc, ju = j_ops.dispatch(jnp.asarray(packed), jsp, JPolicy(
        spike_format="packed", weight_sparsity="dual_sparse",
        placement=JPlacement(mesh=j_mesh)), T, n_out=N, fuse_lif=fuse)
    if fuse:
        assert (words_to_numpy(c1) == np.asarray(jc)).all()
    else:
        np.testing.assert_allclose(c1.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    # a plan with no mesh is refused, never run unsharded
    with pytest.raises(ValueError, match="serve mesh"):
        ops.dispatch(a, sp, PACKED_DUAL, T, n_out=N, fuse_lif=fuse)


def test_sharded_ftp_spmm_matches_unsharded():
    mesh = _mesh("data=4,model=2")
    rng = np.random.default_rng(3)
    T, M, K, N = 4, 32, 64, 128
    packed, w = _mk(rng, T, M, K, N, w_density=0.3)
    a, wt = words_to_torch(packed), torch.from_numpy(w)
    want = ops.dispatch(a, wt, PACKED_DENSE, T)
    got = ops.dispatch(a, wt, _mesh_policy(mesh, spike_format="packed"), T)
    assert torch.equal(want, got)
    jwant = j_ops.dispatch(jnp.asarray(packed), jnp.asarray(w),
                           JPolicy(spike_format="packed"), T)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)
    # odd column count: the unsharded route, as in the reference
    wo = wt[:, :127].contiguous()
    got2 = ops.dispatch(a, wo, _mesh_policy(mesh, spike_format="packed"), T)
    assert torch.equal(ops.dispatch(a, wo, PACKED_DENSE, T), got2)
    # batched operands fold into rows first
    ab = a.reshape(2, 16, K)
    got3 = ops.dispatch(ab, wt, _mesh_policy(mesh, spike_format="packed"), T)
    assert torch.equal(got3.reshape(T, M, N), want)


def test_layer_stacked_plain_plan_never_misrouted_under_mesh():
    """Routing is by TYPE, not rank: a plain plan runs unsharded under a
    mesh (layer 0's result, never a cross-layer mixture), and a sharded
    plan with its layer axis still on fails loudly."""
    mesh = _mesh("data=4,model=2")
    rng = np.random.default_rng(6)
    _, w0 = _mk(rng, 4, 8, 64, 32, w_density=0.5)
    _, w1 = _mk(rng, 4, 8, 64, 32, w_density=0.5)
    p0 = build_weight_plan(torch.from_numpy(w0))
    stacked = stack_plans([p0, build_weight_plan(torch.from_numpy(w1))])
    assert stacked.payload.shape[0] == 2  # same leading size as mesh model
    assert not isinstance(stacked, ShardedWeightJoinPlan)
    a = torch.from_numpy((rng.random((8, 64)) < 0.3).astype(np.int32))
    want, _ = ops.dispatch(a, p0, PACKED_DUAL, 4, n_out=32, fuse_lif=True)
    with ops.serve_mesh_scope(mesh):
        got, _ = ops.dispatch(a, p0, PACKED_DUAL, 4, n_out=32, fuse_lif=True)
    assert torch.equal(want, got)
    sharded_stacked = stack_plans([
        shard_plan(build_sharded_weight_plan(torch.from_numpy(w0), 2), 2),
        shard_plan(build_sharded_weight_plan(torch.from_numpy(w1), 2), 2),
    ])
    assert isinstance(sharded_stacked, ShardedWeightJoinPlan)
    with ops.serve_mesh_scope(mesh):
        with pytest.raises(ValueError, match="slice the layer axis"):
            ops.dispatch(torch.zeros((8, 64), dtype=torch.int32),
                         sharded_stacked, PACKED_DUAL, 4, fuse_lif=True)


def test_sharded_bsr_no_build_across_spike_activity(monkeypatch):
    """New spike activity (same shapes) through the sharded entry builds
    no plan and no kernel, and launches data x model slab calls."""
    from repro_torch.kernels import _build, join_plan

    mesh = _mesh("data=4,model=2")
    rng = np.random.default_rng(4)
    _, w = _mk(rng, 4, 32, 96, 128, w_density=0.2)
    sp = shard_plan(build_sharded_weight_plan(torch.from_numpy(w), 2), 2)
    builds = []
    monkeypatch.setattr(join_plan, "build_weight_plan",
                        lambda *a, **k: builds.append("plan"))
    monkeypatch.setattr(_build, "load", lambda *a, **k: builds.append("lib"))
    calls = []
    real = ops._bsr
    monkeypatch.setattr(ops, "_bsr", lambda *a, **k: calls.append(1) or
                        real(*a, **k))
    with ops.serve_mesh_scope(mesh):
        for density in (0.5, 0.05, 0.0):
            a = torch.from_numpy(
                (rng.random((32, 96)) < density).astype(np.int32))
            ops.dispatch(a, sp, PACKED_DUAL, 4, fuse_lif=True)
    assert builds == [] and len(calls) == 3 * 4 * 2


# ---------------------------------------------------------------------------
# cache / batch placement
# ---------------------------------------------------------------------------

def test_cache_sharding_batch_axis_with_fallback():
    mesh = _mesh("data=4,model=2")
    cfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                       weight_density=1.0)
    model = t_build(cfg)
    axes = model.cache_axes()
    cache = model.init_cache(4, 16, device="cpu")
    placed = place_cache(cache, axes, mesh)
    assert cache_sharding(placed["k"], axes["k"], mesh)[1] == "data"
    assert cache_sharding(placed["kv_pos"], axes["kv_pos"], mesh) == (None,)
    assert data_groups(mesh, 4) == [(i, slice(i, i + 1)) for i in range(4)]
    # 3 rows don't divide data=4: replicated, the whole cohort on row 0
    c3 = model.init_cache(3, 16, device="cpu")
    assert all(s is None for s in cache_sharding(c3["k"], axes["k"], mesh))
    assert data_groups(mesh, 3) == [(0, slice(0, 3))]
    with pytest.raises(ValueError, match="do not match"):
        place_cache({"k": cache["k"]}, axes, mesh)
    # the reference's rule for the same leaves
    from repro.serve.sharding import cache_sharding as j_cache_sharding

    jm = j_make_serve_mesh("data=4,model=2")
    for rows in (4, 3):
        leaf = jnp.zeros((2, rows, 16, 2, 8))
        assert tuple(j_cache_sharding(leaf, axes["k"], jm).spec) == \
            cache_sharding(torch.zeros(2, rows, 16, 2, 8), axes["k"], mesh)


# ---------------------------------------------------------------------------
# engine end-to-end
# ---------------------------------------------------------------------------

def _models(spiking: bool, seed: int = 0):
    jcfg = smoke_variant(get_config("llama3_2_1b"))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=spiking,
                        weight_density=0.3)
    if spiking:
        jcfg = dataclasses.replace(jcfg, spiking_ffn=True, spiking_T=4,
                                   spiking_weight_density=0.3)
        tcfg = dataclasses.replace(tcfg, spiking_T=4)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


@pytest.fixture(scope="module")
def dual():
    return _models(True)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, vocab, size=(n,)), np.int32)
            for n in lens]


def _serve(models, prompts, gen, policy, **kw):
    tcfg, tm, tp = models[1]
    eng = Engine(tm, tp, policy=policy, device="cpu", capture_logits=True,
                 **kw)
    out = eng.generate_batch(prompts, gen)
    return out, eng.drain_logit_traces(), eng


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _traces_same(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        _same(ta, tb)


def test_engine_sharded_dual_sparse_token_identity_and_no_build(
        dual, monkeypatch):
    """The acceptance test: a llama smoke with pruned spiking FFNs on a
    4 x 2 mesh of logical CPU devices (dual-sparse on) emits the tokens and
    logits of the single-device serve bit for bit, equal to the reference
    engine's tokens, and a later request builds no plan and no kernel."""
    from repro_torch.kernels import _build, join_plan

    (jcfg, jm, jp), (tcfg, _, _) = dual
    prompts = _prompts(tcfg.vocab, [12, 12, 12, 12], seed=7)
    want, want_l, single = _serve(dual, prompts, 6,
                                  ExecutionPolicy.for_arch(tcfg),
                                  max_len=24, max_slots=4)
    assert single.spiking_dual_sparse
    mesh = _mesh("data=4,model=2")
    got, got_l, eng = _serve(dual, prompts, 6, _mesh_policy(mesh, tcfg),
                             max_len=24, max_slots=4)
    _same(want, got)
    _traces_same(want_l, got_l)
    jwant = JEngine(jm, jp, max_len=24, max_slots=4,
                    policy=JPolicy.for_arch(jcfg)).generate_batch(prompts, 6)
    _same(jwant, got)
    # the sharded route is live: (shards, ...) plans dealt over the mesh
    plan = eng.params["layers"][0]["mlp"]["plan_in"]
    assert isinstance(plan, ShardedWeightJoinPlan) and plan.shards == 2
    assert plan.payload.ndim == 4
    vocab = eng.params["unembed"]
    assert isinstance(vocab, model_layers.VocabSlabs) and vocab.shards == 2
    builds = []
    monkeypatch.setattr(join_plan, "build_weight_plan",
                        lambda *a, **k: builds.append("plan"))
    monkeypatch.setattr(_build, "load", lambda *a, **k: builds.append("lib"))
    calls = []
    real = ops._bsr
    monkeypatch.setattr(ops, "_bsr", lambda *a, **k: calls.append(1) or
                        real(*a, **k))
    eng.generate_batch(_prompts(tcfg.vocab, [12] * 4, seed=8), 6)
    assert builds == []
    # data x model slab calls per FFN GEMM: 8 per GEMM, 2 GEMMs a layer,
    # one prefill and five decodes
    assert len(calls) == 8 * 2 * tcfg.n_layers * 6
    s = eng.summary()
    assert s["mesh"] == "data=4xmodel=2" and s["mesh_devices"] == 8
    assert s["mesh_physical_devices"] == 1 and s["dual_sparse"] is True


@pytest.mark.parametrize("spec", ["data=8,model=1", "data=1,model=2"])
def test_engine_sharded_axis_extremes_token_identity(spec):
    """Pure-data and pure-model meshes keep token identity on the
    dual-sparse spiking path (the reference file's seed-1 model)."""
    models = _models(True, seed=1)
    (jcfg, jm, jp), (tcfg, _, _) = models
    prompts = _prompts(tcfg.vocab, [10, 10], seed=3)
    want, want_l, _ = _serve(models, prompts, 5,
                             ExecutionPolicy.for_arch(tcfg),
                             max_len=20, max_slots=2)
    got, got_l, eng = _serve(models, prompts, 5,
                             _mesh_policy(_mesh(spec), tcfg),
                             max_len=20, max_slots=2)
    _same(want, got)
    _traces_same(want_l, got_l)
    jwant = JEngine(jm, jp, max_len=20, max_slots=2,
                    policy=JPolicy.for_arch(jcfg)).generate_batch(prompts, 5)
    _same(jwant, got)
    assert eng.batch_align == int(spec.split(",")[0].split("=")[1])


@pytest.mark.parametrize("model_dims", [None, ()])
def test_engine_vocab_slabs_or_whole_keep_logits(dual, model_dims):
    """The unembedding's vocab columns on the model axis (the default
    ``vocab`` dim: 2 of its 8 column blocks a shard) or whole on every mesh
    row (``model_dims=()``): tokens and logits of the single-device serve
    either way, since every path makes the same per-block products."""
    (_, _, _), (tcfg, _, _) = dual
    prompts = _prompts(tcfg.vocab, [8, 8], seed=11)
    want, want_l, _ = _serve(dual, prompts, 4, ExecutionPolicy.for_arch(tcfg),
                             max_len=16, max_slots=2)
    pol = ExecutionPolicy.for_arch(tcfg, placement=Placement(
        mesh=_mesh("data=1,model=4"), model_dims=model_dims))
    got, got_l, eng = _serve(dual, prompts, 4, pol, max_len=16, max_slots=2)
    _same(want, got)
    _traces_same(want_l, got_l)
    vocab = eng.params["unembed"]
    if model_dims is None:
        assert isinstance(vocab, model_layers.VocabSlabs) and vocab.shards == 4
    else:
        assert isinstance(vocab, torch.Tensor)


def test_engine_sharded_plain_arch_and_ragged_batch():
    """A non-spiking arch under the mesh, with a request count that does
    NOT divide the data axis: admission pads the batch up to it, and the
    tokens stay those of the unsharded serve and of the reference."""
    models = _models(False)
    (jcfg, jm, jp), (tcfg, _, _) = models
    prompts = _prompts(tcfg.vocab, [9, 9, 9], seed=5)
    want, want_l, _ = _serve(models, prompts, 5,
                             ExecutionPolicy.for_arch(tcfg),
                             max_len=20, max_slots=4, batch_align=1)
    got, got_l, eng = _serve(models, prompts, 5,
                             _mesh_policy(_mesh("data=4,model=2"), tcfg),
                             max_len=20, max_slots=4)
    _same(want, got)
    _traces_same(want_l, got_l)
    jwant = JEngine(jm, jp, max_len=20, max_slots=4,
                    batch_align=1).generate_batch(prompts, 5)
    _same(jwant, got)
    # mesh engines align prefill batches up to the data axis
    assert eng.batch_align == 4
    assert eng.summary()["padded_rows"] >= 1


def test_place_plans_deals_slabs_over_model_axis():
    cfg = dataclasses.replace(
        build_config("llama3_2_1b", smoke=True, spiking=True,
                     weight_density=0.3), spiking_T=4)
    model = t_build(cfg)
    params = model.init(0, device="cpu")
    mesh = _mesh("data=4,model=2")
    p = model_layers.attach_spiking_ffn_plans(params, cfg, model_shards=2)
    p = place_plans(p, mesh)
    plan = p["layers"][0]["mlp"]["plan_in"]
    # (shards, ...) fields: slab j is what logical device (i, j) joins
    assert isinstance(plan, ShardedWeightJoinPlan)
    assert plan.payload.ndim == 4 and plan.payload.shape[0] == 2
    assert plan.slab(1, mesh.physical(3, 1)).payload.data_ptr() == \
        plan.payload[1].data_ptr()  # one physical device: shared, no copy
    # the unembedding's vocab columns go on the model axis, the reference's
    # rule for a ``vocab`` dim the axis divides: here as slabs of its fixed
    # column blocks, views of one tensor on one physical device
    from repro.serve.sharding import param_spec as j_param_spec

    jm = j_make_serve_mesh("data=4,model=2")
    assert tuple(j_param_spec(("d_model", "vocab"), (cfg.d_model, cfg.vocab),
                              jm)) == (None, "model")
    prepared = model.prepare(p)
    blocks = prepared["unembed"]
    assert blocks.shape == (model_layers.VOCAB_BLOCKS, cfg.d_model,
                            cfg.vocab // model_layers.VOCAB_BLOCKS)
    v = shard_vocab(prepared, mesh, MODEL_SHARDED_DIMS)["unembed"]
    assert isinstance(v, model_layers.VocabSlabs) and v.shards == 2
    assert v.slab(1, mesh.physical(3, 1)).data_ptr() == blocks[4].data_ptr()
    # without ``vocab`` in the model dims, or an axis that does not divide
    # the blocks, the unembedding stays whole on every mesh row
    assert shard_vocab(prepared, mesh, frozenset())["unembed"] is blocks
    m3 = make_serve_mesh("data=1,model=3", devices=CPU8[:3])
    assert shard_vocab(prepared, m3, MODEL_SHARDED_DIMS)["unembed"] is blocks
    with pytest.raises(ValueError, match="model axis is 4"):
        place_plans(p, _mesh("data=2,model=4"))


# ---------------------------------------------------------------------------
# the policy's placement axis
# ---------------------------------------------------------------------------

def test_dispatch_mesh_placement_is_exact():
    """A bitwise policy whose placement carries a mesh routes through the
    sharded entries and stays bit-identical to the unsharded result."""
    rng = np.random.default_rng(9)
    T, M, K, N = 4, 32, 64, 128
    packed, w = _mk(rng, T, M, K, N, w_density=0.3)
    mesh = _mesh("data=4,model=2")
    pol = ExecutionPolicy(spike_format="packed",
                          placement=Placement(mesh=mesh))
    a, wt = words_to_torch(packed), torch.from_numpy(w)
    assert torch.equal(ops.dispatch(a, wt, PACKED_DENSE, T),
                       ops.dispatch(a, wt, pol, T))
    # the policy's mesh is installed for the call only
    assert ops.get_serve_mesh() is None


def test_bitwise_refuses_psum_model_dims():
    """Per-axis rules that put float contractions across shards are
    refused under a bitwise contract; the reduction-free set is fine."""
    mesh = _mesh("data=4,model=2")
    with pytest.raises(ValueError, match="token-identity contract"):
        ExecutionPolicy(placement=Placement(mesh=mesh,
                                            model_dims=("d_ff", "vocab")))
    pol = ExecutionPolicy(placement=Placement(mesh=mesh,
                                              model_dims=("vocab",)))
    assert pol.model_sharded_dims() == frozenset({"vocab"})
    assert ExecutionPolicy(placement=Placement(mesh=mesh)
                           ).model_sharded_dims() == frozenset({"vocab"})
    assert pol.placement.data_size == 4 and pol.placement.model_size == 2
    assert pol.placement.describe() == "data=4xmodel=2"
    assert Placement().describe() == "single-device"
    # the reference decides the same way
    jm = j_make_serve_mesh("data=4,model=2")
    with pytest.raises(ValueError, match="token-identity contract"):
        JPolicy(placement=JPlacement(mesh=jm, model_dims=("d_ff", "vocab")))
    assert Placement.from_spec("data=2,model=2", devices=CPU8).describe() == \
        JPlacement.from_spec("data=2,model=2").describe()


def test_refusals_name_their_items():
    """What stays refused names the queue item that lifts it: the train
    mesh (12c).  The 12b cases serve now: approximate without a model axis
    raises the reference's ValueError, expand_kv serves, and the psum dims
    deal out as TP slabs beside the vocab's."""
    with pytest.raises(ValueError, match="model axis"):
        ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                        exactness=approximate(0.05))
    pol = ExecutionPolicy(exactness=approximate(0.05),
                          placement=Placement(mesh=_mesh("data=4,model=2")))
    assert not pol.token_identical
    cfg = dataclasses.replace(
        build_config("llama3_2_1b", smoke=True, spiking=False,
                     weight_density=1.0), expand_kv=True)
    model = t_build(cfg)
    params = model.init(0, device="cpu")
    out = Engine(model, params, max_len=16, device="cpu").generate_batch(
        [np.zeros(4, np.int32)], 2)
    assert len(out[0]) == 2
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="item 12c"):
        train.main(["--arch", "llama3_2_1b", "--smoke", "--mesh", "host",
                    "--device", "cpu"])
    from repro_torch.serve.sharding import (
        APPROX_MODEL_SHARDED_DIMS,
        shard_params,
    )

    mesh = _mesh("data=4,model=2")
    tp, log = shard_params(model.prepare(params), mesh,
                           APPROX_MODEL_SHARDED_DIMS, cfg)
    placed = shard_vocab(tp, mesh, APPROX_MODEL_SHARDED_DIMS)
    assert isinstance(placed["unembed"], model_layers.VocabSlabs)
    assert isinstance(placed["layers"][0]["attn"]["wq"], model_layers.TPSlabs)
    assert len(log) == 7 * cfg.n_layers


def test_engine_mesh_device_must_match():
    """A mesh of CPU logical devices under an engine on another device is
    refused (no silent placement); without a card and without ``device``
    the meshed engine raises like every entry point."""
    cfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                       weight_density=1.0)
    model = t_build(cfg)
    params = model.init(0, device="cpu")
    pol = ExecutionPolicy.for_arch(cfg, placement=Placement(
        mesh=_mesh("data=2,model=2")))
    with pytest.raises(ValueError, match="serve mesh's devices are cpu"):
        Engine(model, params, max_len=16, device="meta", policy=pol)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(model, params, max_len=16, policy=pol)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_serve_mesh("data,model")


def test_cli_mesh_serve_matches_unsharded(capsys):
    """The serve CLI with ``--mesh data,model --fake-devices 8`` prints the
    reference's mesh line and serves the unsharded run's tokens."""
    from repro_torch.launch import serve

    base = ["--arch", "llama3_2_1b", "--smoke", "--spiking",
            "--weight-density", "0.3", "--batch", "4", "--gen", "4",
            "--prompt-len", "8", "--device", "cpu"]
    prev = force_fake_devices(0)
    try:
        assert serve.main(base + ["--mesh", "data,model",
                                  "--fake-devices", "8"]) == 0
    finally:
        force_fake_devices(prev)
    meshed = capsys.readouterr().out
    assert "mesh: {'data': 4, 'model': 2} over 8 logical devices" in meshed
    assert '"mesh": "data=4xmodel=2"' in meshed
    assert serve.main(base + ["--mesh", "data,model"]) == 0
    single = capsys.readouterr().out
    assert "mesh: single device" in single
    sample = [ln for ln in meshed.splitlines() if ln.startswith("sample:")]
    assert sample == [ln for ln in single.splitlines()
                      if ln.startswith("sample:")]
