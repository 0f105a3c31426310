"""The port's approximate-TP serving (`serve.sharding.shard_params`, the
column- and row-parallel model code of `models.layers`, `models.rwkv6` and
`models.mamba2`, the approximate `Engine` surface and the serve CLI)
against the JAX reference, on the CPU's logical devices.

Held:
* the reference's three psum-TP cells of `tests/test_serve_policy.py`
  (the reference's params through `bridge`): the float llama at 4 x 2 and
  the dual-sparse spiking llama at 2 x 2 within ``APPROX_TOL`` 0.25 of the
  bitwise single-device engine (the port's against its own, the
  reference's against its own), the port's TP tokens equal to the
  reference's single-device tokens and its TP logits within 0.25 of the
  reference's TP logits, and approximate without a model axis refused
  with the reference's `ValueError`;
* each TP module in f32 against its unsharded self within ``F32_TOL``
  1e-5 (the shards' partial sums add in another order than one product
  does; the measured maximum is printed);
* the bitwise contracts of one TP policy: data = 1 x m == data = 2 x m,
  sync == pipelined, dense == paged, and a re-mesh keeps every token;
* every arch family serving under approximate-TP within 0.25 of its
  bitwise single-device serve;
* ``bucket_align`` (the reference's ragged-prompt cell) and the CLI's
  drift line.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import Placement as JPlacement
from repro.serve import approximate as j_approximate
from repro.serve import check_parity as j_check_parity
from repro.serve import make_serve_mesh as j_make_serve_mesh
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels.join_plan import ShardedWeightJoinPlan
from repro_torch.launch.mesh import LogicalDevice, force_fake_devices
from repro_torch.launch.serve import build_config
from repro_torch.models import layers, mamba2, rwkv6
from repro_torch.models.layers import TPSlabs
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    PACKED_DENSE,
    PACKED_DUAL,
    Engine,
    ExecutionPolicy,
    Placement,
    approximate,
    check_parity,
    paged,
)
from repro_torch.serve.sharding import (
    APPROX_MODEL_SHARDED_DIMS,
    make_serve_mesh,
    shard_params,
)

torch.set_num_threads(1)

APPROX_TOL = 0.25   # the reference test's bound
F32_TOL = 1e-5
CPU8 = [LogicalDevice(i, torch.device("cpu")) for i in range(8)]


def _mesh(spec):
    return make_serve_mesh(spec, devices=CPU8)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, vocab, size=(n,)), np.int32)
            for n in lens]


def _approx(cfg, spec, **over):
    return ExecutionPolicy.for_arch(
        cfg, placement=Placement(mesh=_mesh(spec)),
        exactness=approximate(APPROX_TOL), **over)


def _serve(model, params, prompts, gen, policy=None, **kw):
    kw.setdefault("max_len", max(len(p) for p in prompts) + gen)
    eng = Engine(model, params, max_slots=len(prompts), policy=policy,
                 capture_logits=True, device="cpu", **kw)
    out = eng.generate_batch(prompts, gen)
    return out, eng.drain_logit_traces(), eng


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# the reference's cells
# ---------------------------------------------------------------------------

def test_approximate_tp_float_llama_4x2_bounded_drift():
    """The reference's acceptance cell: a float llama at data=4 x model=2
    under approximate(0.25) deals wq column-parallel and wd row-parallel,
    captures logits by default, and drifts <= 0.25 from the bitwise
    single-device engine; the reference's engine on its eight devices
    drifts within the same bound from its own."""
    jcfg = smoke_variant(get_config("llama3_2_1b"))
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                        weight_density=1.0)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    prompts = _prompts(tcfg.vocab, [12, 12, 12, 12], seed=11)

    want, want_l, _ = _serve(tm, tp, prompts, 6, max_len=24)
    pol = ExecutionPolicy(placement=Placement(mesh=_mesh("data=4,model=2")),
                          exactness=approximate(APPROX_TOL))
    eng = Engine(tm, tp, max_len=24, max_slots=4, policy=pol, device="cpu")
    assert eng.capture_logits  # on by default under approximate
    got = eng.generate_batch(prompts, 6)
    lay = eng.params["layers"][0]
    assert isinstance(lay["attn"]["wq"], TPSlabs)
    assert lay["attn"]["wq"].shards == 2 and lay["attn"]["wq"].kind == "col"
    assert isinstance(lay["mlp"]["wd"], TPSlabs)
    assert lay["mlp"]["wd"].shards == 2 and lay["mlp"]["wd"].kind == "row"
    got_l = eng.drain_logit_traces()
    rep = check_parity(pol, want, got, ref_logits=want_l, got_logits=got_l)
    assert not eng.logit_traces
    assert rep["max_logit_drift"] <= APPROX_TOL
    s = eng.summary()
    assert s["exactness"] == "approximate" and s["token_identical"] is False
    assert s["drift_tol"] == APPROX_TOL
    # wq wk wv wo, wg wu wd in each layer
    assert s["tp_weights_dealt"] == 7 * tcfg.n_layers
    assert s["tp_weights_whole"] == 0

    jpol = JPolicy(placement=JPlacement(mesh=j_make_serve_mesh("data=4,model=2")),
                   exactness=j_approximate(APPROX_TOL))
    _hold_to_reference(jm, jp, jpol, prompts, 6, 24, pol, got, got_l,
                       "4x2 float llama", rep)


def _hold_to_reference(jm, jp, jpol, prompts, gen, max_len, pol, got, got_l,
                       label, rep, j_single=None):
    """The reference engine on its own devices: its TP serve drifts within
    APPROX_TOL from its single-device serve, the port's TP tokens equal
    the reference's single-device tokens, and the port's TP logits sit
    within APPROX_TOL of the reference's TP logits (each request compared
    up to its first token flip, `check_parity`)."""
    single = {} if j_single is None else {"policy": j_single}
    jref = JEngine(jm, jp, max_len=max_len, max_slots=len(prompts),
                   capture_logits=True, **single)
    jwant = jref.generate_batch(prompts, gen)
    jeng = JEngine(jm, jp, max_len=max_len, max_slots=len(prompts),
                   policy=jpol)
    jgot = jeng.generate_batch(prompts, gen)
    jgot_l = jeng.drain_logit_traces()
    jrep = j_check_parity(jpol, jwant, jgot,
                          ref_logits=jref.drain_logit_traces(),
                          got_logits=jgot_l)
    assert jrep["max_logit_drift"] <= APPROX_TOL
    _same(jwant, got)
    cross = check_parity(pol, [np.asarray(t) for t in jgot], got,
                         ref_logits=[np.asarray(t) for t in jgot_l],
                         got_logits=got_l)
    print(f"{label} drift: port {rep['max_logit_drift']:.3e}, reference "
          f"{jrep['max_logit_drift']:.3e}, port TP vs reference TP "
          f"{cross['max_logit_drift']:.3e}")
    assert cross["max_logit_drift"] <= APPROX_TOL


def test_approximate_tp_dual_sparse_spiking_2x2():
    """Approximate composes with the dual-sparse spiking path: the FFN
    plans stay column slabs (`ShardedWeightJoinPlan`, each contraction in
    one shard), attention goes psum-TP, and the drift from the bitwise
    single-device engine stays within 0.25; held to the reference's engine
    as the float cell is."""
    from repro.models import layers as j_layers

    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               spiking_ffn=True, spiking_T=4,
                               spiking_weight_density=0.3)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        build_config("llama3_2_1b", smoke=True, spiking=True,
                     weight_density=0.3), spiking_T=4)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    prompts = _prompts(tcfg.vocab, [10, 10], seed=13)
    want, want_l, _ = _serve(tm, tp, prompts, 5,
                             ExecutionPolicy.for_arch(tcfg), max_len=20)
    pol = _approx(tcfg, "data=2,model=2")
    assert pol.weight_sparsity == "dual_sparse"
    got, got_l, eng = _serve(tm, tp, prompts, 5, pol, max_len=20)
    rep = check_parity(pol, want, got, ref_logits=want_l, got_logits=got_l)
    assert rep["max_logit_drift"] <= APPROX_TOL
    mlp = eng.params["layers"][0]["mlp"]
    assert isinstance(mlp["plan_in"], ShardedWeightJoinPlan)
    assert mlp["plan_in"].shards == 2
    assert not isinstance(mlp["wu"], TPSlabs)  # packed: no psum in the FFN
    assert isinstance(eng.params["layers"][0]["attn"]["wo"], TPSlabs)
    assert eng.summary()["dual_sparse"] is True
    jpol = JPolicy.for_arch(
        jcfg, placement=JPlacement(mesh=j_make_serve_mesh("data=2,model=2")),
        exactness=j_approximate(APPROX_TOL))
    try:
        _hold_to_reference(jm, jp, jpol, prompts, 5, 20, pol, got, got_l,
                           "2x2 dual-sparse llama", rep,
                           j_single=JPolicy.for_arch(jcfg))
    finally:
        j_layers.set_spiking_ffn_mode("train")


def test_approximate_requires_model_axis():
    """Approximate without lossy temporal skipping needs a model axis >= 2:
    no mesh, or a data-only mesh, raises the reference's ValueError."""
    with pytest.raises(ValueError, match="model axis"):
        ExecutionPolicy(exactness=approximate(0.1))
    with pytest.raises(ValueError, match="model axis"):
        ExecutionPolicy(placement=Placement(mesh=_mesh("data=8,model=1")),
                        exactness=approximate(0.1))
    with pytest.raises(ValueError, match="model axis"):
        JPolicy(exactness=j_approximate(0.1))
    assert ExecutionPolicy(placement=Placement(mesh=_mesh("data=4,model=2")),
                           exactness=approximate(0.1)).model_sharded_dims() \
        == APPROX_MODEL_SHARDED_DIMS


# ---------------------------------------------------------------------------
# each TP module in f32 against its unsharded self
# ---------------------------------------------------------------------------

def _f32(arch, spiking=False, **over):
    cfg = dataclasses.replace(
        build_config(arch, smoke=True, spiking=spiking, weight_density=1.0),
        param_dtype="float32", compute_dtype="float32", **over)
    model = t_build(cfg)
    params = model.prepare(model.init(0, device="cpu"))
    tp, log = shard_params(params, _mesh("data=1,model=2"),
                           APPROX_MODEL_SHARDED_DIMS, cfg)
    return cfg, params, tp, log


def _x(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g)


def _maxdiff(a, b):
    if isinstance(a, dict):
        return max(_maxdiff(a[k], b[k]) for k in a if k != "pos")
    return float((a.float() - b.float()).abs().max())


def _run_attn(cfg, p):
    """A prefill of 8 positions and a decode at position 8 of 3 rows: both
    outputs and the f32 cache."""
    B, S = 3, 8
    cache = {"k": torch.zeros(B, 16, cfg.n_kv, cfg.head_dim),
             "v": torch.zeros(B, 16, cfg.n_kv, cfg.head_dim),
             "kv_pos": torch.full((16,), -1, dtype=torch.int32), "pos": 0}
    outs = []
    for pos, n, seed in ((0, S, 1), (S, 1, 2)):
        cache["kv_pos"][pos:pos + n] = torch.arange(pos, pos + n,
                                                    dtype=torch.int32)
        cache["pos"] = pos
        positions = (pos + torch.arange(n))[None].expand(B, n)
        outs.append(layers.attn_apply(p, _x(cfg, B, n, seed), cfg,
                                      positions=positions, cache=cache))
    return outs, cache


def _run_recurrent(cfg, apply, p, state):
    """A prefill of 8 positions, then a decode, from ``state``."""
    outs = []
    for n, seed in ((8, 1), (1, 2)):
        y, state = apply(p, _x(cfg, 3, n, seed), cfg, state)
        outs.append(y)
    return outs, state


def _module(case):
    if case.startswith("attn"):
        arch, over = {"attn_gqa": ("llama3_2_1b", {}),
                      "attn_mqa": ("gemma_2b", {}),
                      "attn_mqa_expand_kv": ("gemma_2b", {"expand_kv": True}),
                      "attn_gqa_expand_kv": ("llama3_2_1b", {"expand_kv": True}),
                      "attn_qk_norm": ("qwen3_14b", {})}[case]
        cfg, params, tp, log = _f32(arch, **over)
        return (cfg, log,
                lambda: _run_attn(cfg, params["layers"][0]["attn"]),
                lambda: _run_attn(cfg, tp["layers"][0]["attn"]))
    if case in ("mlp_gated", "mlp_plain", "spiking_float"):
        arch = {"mlp_gated": "llama3_2_1b", "mlp_plain": "nemotron_4_340b",
                "spiking_float": "llama3_2_1b"}[case]
        cfg, params, tp, log = _f32(arch, spiking=case == "spiking_float")
        x = _x(cfg, 5, 3, 3)
        return (cfg, log,
                lambda: layers.mlp_apply(params["layers"][0]["mlp"], x, cfg),
                lambda: layers.mlp_apply(tp["layers"][0]["mlp"], x, cfg))
    if case == "moe":
        cfg, params, tp, log = _f32("phi3_5_moe")
        x = _x(cfg, 4, 3, 4)
        return (cfg, log,
                lambda: layers.moe_apply(params["layers"][0]["moe"], x, cfg),
                lambda: layers.moe_apply(tp["layers"][0]["moe"], x, cfg))
    if case == "rwkv6":
        cfg, params, tp, log = _f32("rwkv6_1_6b")
        H, dh = cfg.ssm_heads, cfg.ssm_head_dim

        def state():
            return {"tm_prev": torch.zeros(3, cfg.d_model),
                    "cm_prev": torch.zeros(3, cfg.d_model),
                    "wkv": torch.zeros(3, H, dh, dh)}
        return (cfg, log,
                lambda: _run_recurrent(cfg, rwkv6.block_apply,
                                       params["layers"][0], state()),
                lambda: _run_recurrent(cfg, rwkv6.block_apply,
                                       tp["layers"][0], state()))
    assert case == "mamba2"
    cfg, params, tp, log = _f32("zamba2_7b")
    d_in = cfg.ssm_expand * cfg.d_model

    def state():
        return {"conv": torch.zeros(3, cfg.conv_width - 1, d_in),
                "ssm": torch.zeros(3, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)}
    return (cfg, log,
            lambda: _run_recurrent(cfg, mamba2.mamba_apply,
                                   params["mamba"][0], state()),
            lambda: _run_recurrent(cfg, mamba2.mamba_apply,
                                   tp["mamba"][0], state()))


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) if k != "pos" for t in _flat(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("case", [
    "attn_gqa", "attn_mqa", "attn_mqa_expand_kv", "attn_gqa_expand_kv",
    "attn_qk_norm", "mlp_gated", "mlp_plain", "moe", "rwkv6", "mamba2",
    "spiking_float"])
def test_tp_module_equals_unsharded_f32(case):
    """Each TP module on a data=1 x model=2 mesh of CPU logical devices
    equals its unsharded self in f32 within 1e-5 (outputs and the state or
    cache it writes); its weights were dealt as TPSlabs."""
    cfg, log, plain, sharded = _module(case)
    assert any(kind != "whole" for _, kind, _ in log), log
    want = _flat(plain())
    with ops.serve_mesh_scope(_mesh("data=1,model=2")):
        got = _flat(sharded())
    assert len(want) == len(got)
    err = max(_maxdiff(a, b) for a, b in zip(want, got))
    print(f"{case}: max |TP - unsharded| {err:.3e} (f32)")
    assert err <= F32_TOL, (case, err)


def test_tp_slabs_are_views_on_one_device_and_copies_across_devices():
    """On the weight's own device every slab is a view of it (no copy);
    dealt over two devices each device holds contiguous copies of its own
    slabs only; a slab asked for on a device it was not dealt to raises."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    w = torch.arange(24.0).reshape(4, 6)
    col = TPSlabs(w, 2, "col")
    for j in range(2):
        s = col.slab(j, cpu)
        assert s.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
        assert torch.equal(s, w[:, 3 * j:3 * j + 3])
    row = TPSlabs(w, 2, "row", devices=[[cpu], [meta]])
    assert row.slab(0, cpu).untyped_storage().data_ptr() != \
        w.untyped_storage().data_ptr()
    assert row.slab(0, cpu).is_contiguous()
    assert torch.equal(row.slab(0, cpu), w[:2])
    assert row.slab(1, meta).shape == (2, 6)
    with pytest.raises(ValueError, match="not dealt"):
        row.slab(1, cpu)


def test_mqa_keeps_kv_whole_and_logs_it():
    """gemma's single KV head cannot split at a whole head: wk / wv stay
    whole on every shard, and the placement log says so."""
    cfg, _, tp, log = _f32("gemma_2b")
    attn = tp["layers"][0]["attn"]
    assert isinstance(attn["wq"], TPSlabs) and isinstance(attn["wk"],
                                                          torch.Tensor)
    whole = sorted(p for p, kind, _ in log if kind == "whole")
    assert whole == [f"layers[{i}].attn.{w}" for i in range(cfg.n_layers)
                     for w in ("wk", "wv")]


# ---------------------------------------------------------------------------
# bitwise contracts under one TP policy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    cfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                       weight_density=1.0)
    model = t_build(cfg)
    return cfg, model, model.init(0, device="cpu")


def test_data_axis_and_executors_bitwise_under_tp(llama):
    """data = 1 x 2 == data = 2 x 2 (every product runs over fixed row
    blocks on each shard), sync == pipelined and dense == paged, tokens and
    captured logits bit for bit; the drift from one device stays within
    0.25."""
    cfg, model, params = llama
    prompts = _prompts(cfg.vocab, [12, 12, 12, 12], seed=3)
    want, want_l, _ = _serve(model, params, prompts, 6, _approx(cfg, "data=1,model=2"),
                             max_len=24)
    for spec, over in (("data=2,model=2", {}),
                       ("data=2,model=2", {"execution": "pipelined"}),
                       ("data=2,model=2", {"paging": paged(8)})):
        got, got_l, _ = _serve(model, params, prompts, 6,
                               _approx(cfg, spec, **over), max_len=24)
        _same(want, got)
        for a, b in zip(want_l, got_l):
            _same(a, b)
    one, one_l, _ = _serve(model, params, prompts, 6, max_len=24)
    rep = check_parity(_approx(cfg, "data=1,model=2"), one, want,
                       ref_logits=one_l, got_logits=want_l)
    assert rep["max_logit_drift"] <= APPROX_TOL


def test_remesh_keeps_every_token_under_tp(llama):
    """A live 2 x 2 TP serve re-meshed to 1 x 2 after 3 steps re-deals its
    TP slabs from the base weights and emits the tokens of the undisturbed
    2 x 2 serve."""
    cfg, model, params = llama
    prompts = _prompts(cfg.vocab, [12, 12, 12, 12], seed=5)
    want, _, _ = _serve(model, params, prompts, 8, _approx(cfg, "data=2,model=2"),
                        max_len=24)
    eng = Engine(model, params, max_len=24, max_slots=4,
                 policy=_approx(cfg, "data=2,model=2"), device="cpu")
    tickets = [eng.submit(p, 8) for p in prompts]
    for _ in range(3):
        eng.step()
    rep = eng.remesh(mesh=_mesh("data=1,model=2"))
    assert rep["remeshed"] and rep["mesh"] == "data=1xmodel=2"
    assert isinstance(eng.params["layers"][0]["attn"]["wq"], TPSlabs)
    out = eng.run()
    _same(want, [out[t.rid] for t in tickets])


def test_dispatch_under_approximate_mesh_takes_the_sharded_ffn_routes(
        monkeypatch):
    """No new kernel route: under an approximate mesh policy the packed
    FFN's kernel 3 runs as plan column slabs (`ops._bsr_sharded`) and
    kernel 1 as dense column slabs (`ops._spmm_mesh`), equal to the
    unsharded calls bit for bit."""
    from _data import mk_packed_and_weights as _mk

    from repro_torch.kernels.join_plan import (
        build_sharded_weight_plan,
        build_weight_plan,
        shard_plan,
    )

    mesh = _mesh("data=2,model=2")
    pol = dataclasses.replace(PACKED_DENSE, placement=Placement(mesh=mesh),
                              exactness=approximate(APPROX_TOL))
    calls = []
    for name in ("_bsr_sharded", "_spmm_mesh"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    packed, w = _mk(np.random.default_rng(2), 4, 16, 96, 256, w_density=0.1)
    a, w = bridge.words_to_torch(packed), torch.from_numpy(w)
    got = ops.dispatch(a, w, pol, 4)
    want = ops.dispatch(a, w, PACKED_DENSE, 4)
    assert torch.equal(got, want) and calls == ["_spmm_mesh"]
    dual = dataclasses.replace(pol, weight_sparsity="dual_sparse")
    plan = shard_plan(build_sharded_weight_plan(w, 2), 2)
    got, _ = ops.dispatch(a, plan, dual, 4, fuse_lif=False, n_out=w.shape[1])
    want, _ = ops.dispatch(a, build_weight_plan(w), PACKED_DUAL, 4,
                           fuse_lif=False, n_out=w.shape[1])
    assert torch.equal(got, want) and calls[-1] == "_bsr_sharded"


# ---------------------------------------------------------------------------
# every family under approximate-TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [
    ("gemma_2b", {}),
    ("gemma_2b", {"expand_kv": True}),
    ("qwen3_14b", {}),
    ("phi3_5_moe", {}),
    ("rwkv6_1_6b", {}),
    ("zamba2_7b", {}),
    ("llama3_2_1b", {"spiking_ffn": True}),
], ids=["gemma", "gemma_expand_kv", "qwen3", "phi3_5_moe", "rwkv6",
        "zamba2", "llama_spiking_float"])
def test_families_serve_approximate_tp_within_tol(arch, over):
    """Each family serves at data=2 x model=2 under approximate(0.25) in
    bf16, its TP weights dealt, its drift from the bitwise single-device
    serve within the bound (the spiking llama with spike_format='float':
    its FFN goes TP like a plain MLP; the MoE arch keeps its attention
    whole, `shard_params`)."""
    cfg = dataclasses.replace(
        build_config(arch, smoke=True, spiking=False, weight_density=1.0),
        **over)
    model = t_build(cfg)
    params = model.init(0, device="cpu")
    fmt = {"spike_format": "float"} if cfg.spiking_ffn else {}
    prompts = _prompts(cfg.vocab, [8, 8, 8, 8], seed=9)
    want, want_l, _ = _serve(model, params, prompts, 5,
                             ExecutionPolicy.for_arch(cfg, **fmt), max_len=16)
    pol = _approx(cfg, "data=2,model=2", **fmt)
    got, got_l, eng = _serve(model, params, prompts, 5, pol, max_len=16)
    if cfg.spiking_ffn:
        assert isinstance(eng.params["layers"][0]["mlp"]["wu"], TPSlabs)
    if cfg.n_experts:  # row-coupled: attention whole, the experts dealt
        assert not isinstance(eng.params["layers"][0]["attn"]["wq"], TPSlabs)
        assert isinstance(eng.params["layers"][0]["moe"]["wd"], TPSlabs)
        assert eng.summary()["tp_weights_whole"] == 4 * cfg.n_layers
    rep = check_parity(pol, want, got, ref_logits=want_l, got_logits=got_l)
    s = eng.summary()
    assert s["tp_weights_dealt"] > 0
    print(f"{arch} {over}: drift {rep['max_logit_drift']:.3e}, "
          f"token match {rep['token_match_fraction']:.2f}, TP weights "
          f"{s['tp_weights_dealt']} dealt / {s['tp_weights_whole']} whole")
    assert rep["max_logit_drift"] <= APPROX_TOL


# ---------------------------------------------------------------------------
# bucket_align and the CLI
# ---------------------------------------------------------------------------

def test_bucket_align_approximate_mode_serves_ragged_prompts(llama):
    """bucket_align > 1 pads ragged prompts to one bucket length (token 0,
    approximate outputs): every request gets its full budget from one
    prefill batch; a drained engine's successor keeps the bucket."""
    cfg, model, params = llama
    engine = Engine(model, params, max_len=32, max_slots=4, bucket_align=8,
                    device="cpu")
    prompts = _prompts(cfg.vocab, [5, 7, 8], seed=6)  # all bucket to 8
    outs = engine.generate_batch(prompts, 4)
    assert [len(o) for o in outs] == [4, 4, 4]
    assert engine.summary()["prefill_batches"] == 1
    engine.submit(prompts[0], 4)
    handoff = engine.drain(step_budget=0)
    assert handoff.meta["bucket_align"] == 8
    succ = Engine.resume(model, params, handoff, device="cpu")
    assert succ.scheduler.bucket_align == 8


def test_cli_approximate_tp_prints_drift(capsys):
    """The reference's approximate-TP serve command on the port's CLI: the
    drift line against a bitwise single-device engine, and the summary's
    contract and measurement keys."""
    from repro_torch.launch import serve

    prev = force_fake_devices(0)
    try:
        assert serve.main(["--arch", "llama3_2_1b", "--smoke", "--mesh",
                           "data,model", "--fake-devices", "8",
                           "--exactness", "approximate", "--tol", "0.25",
                           "--batch", "4", "--gen", "6",
                           "--device", "cpu"]) == 0
    finally:
        force_fake_devices(prev)
    out = capsys.readouterr().out
    assert "approximate drift: max |logit drift|" in out
    assert "<= tol 0.25" in out
    assert '"token_identical": false' in out and '"drift_tol": 0.25' in out
    assert '"max_logit_drift"' in out and '"mesh": "data=4xmodel=2"' in out
