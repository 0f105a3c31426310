"""The port's pipelined executor (`repro_torch.serve.executor`) against the
JAX reference's, on the CPU at smoke size: the single-device cases of
`tests/test_serve_executor.py`.

Both packages get the reference's params (`repro_torch.bridge`).  Held:
* port pipelined == port sync, bit for bit in tokens and captured logits
  (pipelining reorders host work only);
* port pipelined == the JAX reference engine under the same policy and
  schedule: greedy tokens identical, captured logits within 0.25 of the
  jitted reference (the bound `tests/test_torch_models.py` states and
  explains).

The reference's mesh cases run on a mesh of logical CPU devices
(`launch.mesh`): ``test_rebalance_pad_policy``,
``test_cache_pad_rows_appends_zero_rows``,
``test_pipelined_mesh_rebalance_repacks_skewed_cohorts`` and
``test_rebalanced_cohort_cache_shards_down_data_axis`` (the port's cache
sits on the mesh's lead device, so "shards down the data axis" is: the
re-packed rows divide the axis and the next decode runs in data groups).
The reference's ``test_pipelined_moe_clamps_window_and_keeps_identity``
is ported in `tests/test_torch_moe.py`; here the window clamp and the
engine's other row-coupling rules (no cohort merge, no batch padding) are
held on an engine marked row-coupled.
The reference's ``test_pipelined_dual_sparse_zero_retrace`` becomes
``test_no_plan_or_kernel_build_after_first_step``: the port does not trace,
so what must not recur per request is a join-plan build or a kernel build.
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
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_config, generate
from repro_torch.models.registry import build_model as t_build
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.serve import (
    DenseCacheOps,
    Engine,
    ExecutionPolicy,
    PackedSpikeCache,
    PipelinedExecutor,
    Placement,
    SyncExecutor,
    cache_pad_rows,
    make_serve_mesh,
    rebalance_pad,
)
from repro_torch.serve.policy import PACKED_DUAL

torch.set_num_threads(1)

STAGES = ("admit", "prefill", "merge", "decode", "sample_sync", "encode",
          "retire")
LOGIT_TOL = 0.25


def _models(spiking: bool):
    jcfg = smoke_variant(get_config("llama3_2_1b"))
    if spiking:
        jcfg = dataclasses.replace(jcfg, spiking_ffn=True,
                                   spiking_weight_density=0.3)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=spiking,
                        weight_density=0.3)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


@pytest.fixture(scope="module")
def dual():
    """The main path: llama3.2-1b smoke with dual-sparse spiking FFNs."""
    return _models(True)


@pytest.fixture(scope="module")
def dense():
    """The plain llama3.2-1b smoke (the reference file's model)."""
    return _models(False)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _port(models, execution="sync", **kw):
    tcfg, tm, tp = models[1]
    return Engine(tm, tp, policy=ExecutionPolicy.for_arch(tcfg, execution=execution),
                  device="cpu", **kw)


def _ref(models, execution="sync", **kw):
    jcfg, jm, jp = models[0]
    return JEngine(jm, jp, policy=JPolicy.for_arch(jcfg, execution=execution), **kw)


def _staggered(engine, prompts, gens, arrivals):
    """Submit request i at step arrivals[i]; drive until drained."""
    tickets, i, step = [], 0, 0
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            tickets.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    return [np.asarray(engine.results[t.rid].generated, np.int32)
            for t in tickets]


def _same_traces(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# units: policy axis, executor selection, dispatch
# ---------------------------------------------------------------------------

def test_execution_axis_validated_and_described():
    with pytest.raises(ValueError, match="execution"):
        ExecutionPolicy(execution="async")
    pol = ExecutionPolicy(execution="pipelined")
    assert "execution='pipelined'" in pol.describe()
    assert ExecutionPolicy().execution == "sync"
    assert pol.token_identical
    want = JPolicy(execution="pipelined").describe()
    assert "execution='pipelined'" in want and "paging=none" in pol.describe()


def test_executor_selected_by_policy(dense):
    e_sync = _port(dense, max_len=16)
    assert type(e_sync.executor) is SyncExecutor
    e_pipe = _port(dense, "pipelined", max_len=16, pipeline_depth=3)
    assert type(e_pipe.executor) is PipelinedExecutor
    assert e_pipe.executor.depth == 3
    s = e_pipe.summary()
    assert s["execution"] == "pipelined" and s["pipeline_depth"] == 3
    with pytest.raises(ValueError, match="depth"):
        _port(dense, "pipelined", max_len=16, pipeline_depth=0)


def test_row_coupled_engine_clamps_window_to_one(dense):
    """The executor lands every step before the next dispatches when the
    engine's rows are coupled (MoE capacity routing in the reference)."""
    engine = _port(dense, "pipelined", max_len=16, pipeline_depth=4)
    engine.row_independent = False
    assert PipelinedExecutor(engine, depth=4).depth == 1
    assert _port(dense, max_len=16).row_independent


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_row_coupled_engine_never_merges_and_pads_no_batch(dense, execution):
    """An engine whose arch couples its rows (``n_experts`` set: MoE
    capacity routing in the reference) keeps two cohorts that reach one
    length apart, where an independent-row engine merges them, and forces
    ``batch_align`` to 1 (the reference engine's `merge_cohorts` and
    alignment rule).  The model computes the dense llama either way: only
    the engine's reading of the config changes."""
    tcfg, tm, tp = dense[1]
    coupled_model = dataclasses.replace(
        tm, cfg=dataclasses.replace(tcfg, n_experts=4))
    prompts = _prompts(tcfg.vocab, [8, 9], seed=21)
    runs = {}
    for name, model in (("independent", tm), ("coupled", coupled_model)):
        eng = Engine(model, tp, max_len=20, max_slots=4, batch_align=4,
                     device="cpu", policy=ExecutionPolicy.for_arch(
                         tcfg, execution=execution))
        lengths = []

        def watch(eng=eng, lengths=lengths):
            lengths.append(sorted(c.length for c in eng.cohorts))

        eng.submit(prompts[0], 6)
        eng.step()
        watch()
        eng.submit(prompts[1], 6)
        while not eng.idle:
            eng.step()
            watch()
        runs[name] = eng, lengths
    eng, lengths = runs["coupled"]
    assert not eng.merge_cohorts and eng.batch_align == 1
    assert any(len(ls) == 2 and ls[0] == ls[1] for ls in lengths), lengths
    assert eng.metrics.n_merges == 0 and eng.summary()["padded_rows"] == 0
    eng, _ = runs["independent"]
    assert eng.merge_cohorts and eng.batch_align == 4
    assert eng.metrics.n_merges == 1


def test_dispatch_pipelined_refuses_per_call_plan_building():
    """Per-call plan building reads the weights on the host; the pipelined
    policy refuses it as the reference does, and a prebuilt plan gives the
    sync policy's result."""
    from repro_torch.kernels.join_plan import build_weight_plan

    pol = dataclasses.replace(PACKED_DUAL, execution="pipelined")
    with pytest.raises(ValueError, match="pipelined"):
        ops.dispatch(torch.zeros((8, 32), dtype=torch.int32),
                     torch.zeros((32, 16)), pol, 4)
    rng = np.random.default_rng(0)
    w = np.where(rng.random((32, 16)) < 0.3,
                 rng.standard_normal((32, 16)).astype(np.float32), 0.0)
    plan = build_weight_plan(torch.from_numpy(w))
    a = torch.from_numpy((rng.random((8, 32)) < 0.5).astype(np.int32))
    out, _ = ops.dispatch(a, plan, pol, 4, n_out=16, fuse_lif=True)
    want, _ = ops.dispatch(a, plan, PACKED_DUAL, 4, n_out=16, fuse_lif=True)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# pipelined == sync == the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_pipelined_matches_reference_engine_and_sync(dual, depth):
    """At every window depth the port's pipelined serve gives the JAX
    reference engine's pipelined tokens, logits within the jitted bound,
    and the port's sync serve bit for bit."""
    B, P, G = 3, 8, 5
    prompts = _prompts(dual[0][0].vocab, [P] * B, seed=depth)
    ref = _ref(dual, "pipelined", max_len=P + G, max_slots=B,
               pipeline_depth=depth, capture_logits=True)
    want = ref.generate_batch(prompts, G)
    want_logits = ref.drain_logit_traces()
    pipe = _port(dual, "pipelined", max_len=P + G, max_slots=B,
                 pipeline_depth=depth, capture_logits=True)
    got = pipe.generate_batch(prompts, G)
    got_logits = pipe.drain_logit_traces()
    sync = _port(dual, max_len=P + G, max_slots=B, capture_logits=True)
    sync_out = sync.generate_batch(prompts, G)
    for w, g, s in zip(want, got, sync_out):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    _same_traces(got_logits, sync.drain_logit_traces())
    for tw, tg in zip(want_logits, got_logits):
        np.testing.assert_allclose(np.stack(tg), np.stack(tw), rtol=0,
                                   atol=LOGIT_TOL)
    s = pipe.summary()
    assert s["total_tokens"] == B * G and s["dual_sparse"]
    assert set(STAGES) <= set(s["stage_s"])


def test_pipelined_matches_own_generate_loop(dense):
    """On-device token feedback equals the host-round-trip greedy loop."""
    B, P, G = 4, 8, 6
    prompts = _prompts(dense[1][0].vocab, [P] * B, seed=0)
    _, tm, _ = dense[1]
    engine = _port(dense, "pipelined", max_len=P + G, max_slots=B)
    got = engine.generate_batch(prompts, G)
    want = generate(tm, engine.params, torch.from_numpy(np.stack(prompts)).long(),
                    tm.init_cache(B, P + G, device="cpu"), G)
    for i in range(B):
        np.testing.assert_array_equal(got[i], want[i].numpy())


@pytest.mark.parametrize("which", ["dual", "dense"])
def test_pipelined_staggered_continuous_batching(which, dual, dense):
    """Mixed lengths, staggered arrivals, a merge, retirement and batch
    padding: the port's pipelined serve equals the reference engine's
    pipelined serve of the same schedule, and the port's sync serve.  The
    len-10 request arrives when the (8, 8) cohort reaches position 10
    (cohort lengths advance at decode dispatch), so the merge happens under
    either executor."""
    models = dual if which == "dual" else dense
    lens, gens = [8, 8, 12, 10, 8, 14], [6, 6, 5, 5, 4, 6]
    arrivals = [0, 0, 0, 2, 3, 4]
    prompts = _prompts(models[0][0].vocab, lens, seed=1)
    kw = dict(max_len=24, max_slots=6, batch_align=2)
    want = _staggered(_ref(models, "pipelined", **kw), prompts, gens, arrivals)
    pipe = _port(models, "pipelined", **kw)
    got = _staggered(pipe, prompts, gens, arrivals)
    sync = _staggered(_port(models, **kw), prompts, gens, arrivals)
    for w, g, s in zip(want, got, sync):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    s = pipe.summary()
    assert s["cohort_merges"] >= 1 and s["padded_rows"] >= 1


def test_pipelined_eos_stops_early_despite_speculation(dense):
    """EOS lives in a not-yet-landed step: the executor finds it up to
    depth-1 steps late, discards the decodes past it, and the output still
    ends exactly at EOS, as in the reference engine."""
    (p,) = _prompts(dense[0][0].vocab, [8], seed=3)
    ref = _port(dense, max_len=40, max_slots=1).generate_batch([p], 32)[0]
    eos = int(ref[3])
    engine = _port(dense, "pipelined", max_len=40, max_slots=1, eos_id=eos,
                   pipeline_depth=3)
    (out,) = engine.generate_batch([p], 32)
    assert len(out) == 4 and out[-1] == eos
    assert engine.metrics.completed[0].finish_reason == "eos"
    assert engine.metrics.n_decode_batches >= 3
    (want,) = _ref(dense, "pipelined", max_len=40, max_slots=1, eos_id=eos,
                   pipeline_depth=3).generate_batch([p], 32)
    np.testing.assert_array_equal(out, want)


def test_pipelined_max_new_one_never_decodes(dense):
    """Budget exhaustion is known from token counts (no wait): a request
    satisfied at prefill never dispatches a decode."""
    prompts = _prompts(dense[0][0].vocab, [8, 8, 8], seed=4)
    engine = _port(dense, "pipelined", max_len=16, max_slots=4)
    outs = engine.generate_batch(prompts, 1)
    assert all(len(o) == 1 for o in outs)
    assert engine.summary()["decode_batches"] == 0


def test_pipelined_flush_exposes_inflight_tokens(dense):
    """`Engine.flush()` lands every dispatched decode for external
    steppers."""
    (p,) = _prompts(dense[0][0].vocab, [8], seed=5)
    engine = _port(dense, "pipelined", max_len=32, max_slots=1,
                   pipeline_depth=4)
    t = engine.submit(p, 8)
    engine.step()   # prefill + decode 1 (in flight)
    engine.step()   # decode 2 (in flight)
    st = engine.cohorts[0].slots[0]
    in_flight = len(engine.cohorts[0].pending)
    assert in_flight >= 1
    n_before = len(st.generated)
    engine.flush()
    assert len(st.generated) == n_before + in_flight
    assert not engine.cohorts[0].pending
    engine.run()
    assert len(engine.results[t.rid].generated) == 8


# ---------------------------------------------------------------------------
# stage timing, logit traces
# ---------------------------------------------------------------------------

def test_stage_timing_attributes_sync_vs_pipelined(dense):
    prompts = _prompts(dense[0][0].vocab, [12] * 4, seed=6)
    for execution in ("sync", "pipelined"):
        engine = _port(dense, execution, max_len=24, max_slots=4)
        engine.generate_batch(prompts, 6)
        s = engine.summary()
        assert s["execution"] == execution
        stage_s = s["stage_s"]
        assert set(STAGES) <= set(stage_s)
        assert all(v >= 0.0 for v in stage_s.values())
        assert stage_s["decode"] > 0.0 and stage_s["prefill"] > 0.0
        assert sum(stage_s.values()) <= s["wall_s"] * 1.5


def test_pipelined_eos_speculation_never_grows_logit_traces(dense):
    """Decodes past an un-landed EOS are discarded by emit and by capture:
    one trace row per emitted token, as under sync, bit for bit."""
    (p,) = _prompts(dense[0][0].vocab, [8], seed=3)
    ref = _port(dense, max_len=40, max_slots=1).generate_batch([p], 32)[0]
    eos = int(ref[3])
    traces = {}
    for execution in ("sync", "pipelined"):
        engine = _port(dense, execution, max_len=40, max_slots=1, eos_id=eos,
                       capture_logits=True, pipeline_depth=3)
        (out,) = engine.generate_batch([p], 32)
        assert len(out) == 4 and out[-1] == eos
        traces[execution] = engine.drain_logit_traces()
    (ts,), (tp,) = traces["sync"], traces["pipelined"]
    assert len(ts) == len(tp) == 4
    _same_traces([ts], [tp])


def test_pipelined_logit_traces_match_sync_and_reference(dense):
    """Deferred capture lands the same logit rows in the same order as
    sync (bit for bit) and as the reference engine (within the bound)."""
    prompts = _prompts(dense[0][0].vocab, [10, 10], seed=12)
    traces = {}
    for execution in ("sync", "pipelined"):
        engine = _port(dense, execution, max_len=20, max_slots=2,
                       capture_logits=True)
        engine.generate_batch(prompts, 5)
        traces[execution] = engine.drain_logit_traces()
    _same_traces(traces["sync"], traces["pipelined"])
    ref = _ref(dense, "pipelined", max_len=20, max_slots=2,
               capture_logits=True)
    ref.generate_batch(prompts, 5)
    for tw, tg in zip(ref.drain_logit_traces(), traces["pipelined"]):
        np.testing.assert_allclose(np.stack(tg), np.stack(tw), rtol=0,
                                   atol=LOGIT_TOL)


def test_logit_trace_window_bounds_capture_buffer(dense):
    prompts = _prompts(dense[0][0].vocab, [8, 8], seed=7)
    engine = _port(dense, "pipelined", max_len=24, max_slots=2,
                   capture_logits=True, logit_trace_window=3)
    engine.generate_batch(prompts, 8)
    assert all(len(t) == 3 for t in engine.logit_traces.values())
    drained = engine.drain_logit_traces()
    assert len(drained) == 2 and not engine.logit_traces
    engine2 = _port(dense, max_len=24, max_slots=2, capture_logits=True)
    engine2.generate_batch(prompts, 8)
    assert all(len(t) == 8 for t in engine2.logit_traces.values())
    with pytest.raises(ValueError, match="logit_trace_window"):
        _port(dense, max_len=24, capture_logits=True, logit_trace_window=0)


# ---------------------------------------------------------------------------
# spiking paths: deferred encode, no per-request plan or kernel build
# ---------------------------------------------------------------------------

def test_pipelined_spiking_packed_token_identical_and_telemetry(dual):
    """The encode from the device tokens changes when the words are
    applied, never what is encoded: tokens, spike telemetry and skipped
    planes match sync."""
    prompts = _prompts(dual[0][0].vocab, [12, 12, 12], seed=2)
    e_sync = _port(dual, max_len=24, max_slots=4)
    a = e_sync.generate_batch(prompts, 6)
    e_pipe = _port(dual, "pipelined", max_len=24, max_slots=4)
    b = e_pipe.generate_batch(prompts, 6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ss, sp = e_sync.summary(), e_pipe.summary()
    assert sp["spike_sparsity"] == ss["spike_sparsity"]
    assert sp["stage_s"]["encode"] >= 0.0


def test_packed_spike_cache_update_async_defers_materialization():
    c = PackedSpikeCache(T=4, width=8, device="cpu")
    c.append(torch.zeros((2, 8), dtype=torch.int32))
    c.update_async(torch.full((2, 8), 0b0101, dtype=torch.int32))
    assert c._pending is not None          # staged, not applied
    assert c.spike_sparsity() < 1.0        # first access applies it
    assert c._pending is None
    assert torch.equal(c.words, torch.full((2, 8), 0b0101, dtype=torch.int32))
    # the newest staged words win
    c.update_async(torch.zeros((2, 8), dtype=torch.int32))
    c.update_async(torch.ones((2, 8), dtype=torch.int32))
    c.take([0])
    assert torch.equal(c.words, torch.ones((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        c.update_async(torch.ones((3, 8), dtype=torch.int32))
        len(c)


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_no_plan_or_kernel_build_after_first_step(dual, execution,
                                                  monkeypatch):
    """The port's counterpart of the reference's zero-retrace contract:
    join plans are built once at engine construction and kernels once per
    process, so after the first engine step no plan or kernel build runs,
    for this request or a later one."""
    from repro_torch.kernels import _build, join_plan

    builds = {"plan": 0, "kernel": 0}
    real_plan, real_load = join_plan.build_weight_plan, _build.load

    def plan(*a, **kw):
        builds["plan"] += 1
        return real_plan(*a, **kw)

    def load(*a, **kw):
        builds["kernel"] += 1
        return real_load(*a, **kw)

    monkeypatch.setattr(join_plan, "build_weight_plan", plan)
    monkeypatch.setattr(_build, "load", load)
    engine = _port(dual, execution, max_len=24, max_slots=4)
    assert builds["plan"] == 2 * dual[1][0].n_layers  # W_in + W_out a layer
    for t in [engine.submit(p, 6)
              for p in _prompts(dual[0][0].vocab, [12] * 3, seed=10)]:
        assert t.outcome == "queued"
    engine.step()
    seen = dict(builds)
    engine.run()
    engine.generate_batch(_prompts(dual[0][0].vocab, [12] * 3, seed=11), 6)
    assert builds == seen


# ---------------------------------------------------------------------------
# the mesh's load-skew re-pack
# ---------------------------------------------------------------------------

def _mesh42():
    return make_serve_mesh("data=4,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(8)])


def test_rebalance_pad_policy():
    from repro.serve.scheduler import rebalance_pad as j_rebalance_pad

    for n, d in ((4, 4), (3, 4), (5, 4), (1, 8), (3, 1), (0, 4)):
        assert rebalance_pad(n, d) == j_rebalance_pad(n, d)
    assert rebalance_pad(3, 4) == 1 and rebalance_pad(5, 4) == 3
    assert rebalance_pad(3, 1) == 0 and rebalance_pad(0, 4) == 0


def test_cache_pad_rows_appends_zero_rows(dense):
    tm = dense[1][1]
    axes = tm.cache_axes()
    cache = tm.init_cache(3, 16, device="cpu")
    cache["k"].normal_()
    padded = DenseCacheOps(axes).pad_rows(cache, 2)
    assert DenseCacheOps(axes).batch_size(padded) == 5
    assert torch.equal(padded["k"][:, :3], cache["k"])
    assert not padded["k"][:, 3:].any()
    assert torch.equal(padded["kv_pos"], cache["kv_pos"])
    assert cache_pad_rows(cache, axes, 0) is cache


def _skewed(models, execution, gens, seed):
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, [10] * 4, seed=seed)
    refs = []
    for p, g in zip(prompts, gens):
        params = Engine(tm, tp, max_len=20, device="cpu",
                        policy=ExecutionPolicy.for_arch(tcfg)).params
        cache = tm.init_cache(1, 20, device="cpu")
        refs.append(generate(tm, params, torch.from_numpy(p)[None].long(),
                             cache, g, spiking_mode="infer")[0].numpy())
    engine = Engine(tm, tp, max_len=20, max_slots=4, device="cpu",
                    policy=ExecutionPolicy.for_arch(
                        tcfg, execution=execution,
                        placement=Placement(mesh=_mesh42())))
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    return engine, reqs, refs


def test_pipelined_mesh_rebalance_repacks_skewed_cohorts(dual):
    """Uneven budgets shrink the cohort 4 -> 3 -> 2 on a data=4 mesh: the
    pipelined executor re-packs with dummy rows (sync keeps the whole-row
    fallback on mesh row 0), and the tokens stay those of solo runs."""
    engine, reqs, refs = _skewed(dual, "pipelined", [3, 5, 7, 7], seed=8)
    engine.run()
    for r, w in zip(reqs, refs):
        np.testing.assert_array_equal(
            w, np.asarray(engine.results[r.rid].generated, np.int32))
    s = engine.summary()
    assert s["rebalances"] >= 2          # 3 -> pad 1, 2 -> pad 2
    assert s["padded_rows"] >= 3
    sync, sreqs, refs = _skewed(dual, "sync", [3, 5, 7, 7], seed=8)
    sync.run()
    for r, w in zip(sreqs, refs):
        np.testing.assert_array_equal(
            w, np.asarray(sync.results[r.rid].generated, np.int32))
    assert sync.summary()["rebalances"] == 0


def test_rebalanced_cohort_cache_shards_down_data_axis(dual, monkeypatch):
    """After a re-pack the cohort's rows divide the data axis again, and
    its next decode runs in four data groups (the point of rebalancing
    against the whole-row fallback)."""
    engine, _, _ = _skewed(dual, "pipelined", [2, 8, 8, 8], seed=9)
    group_rows = []
    real = engine._dense_call

    def spy(call, trees, tokens, cache):
        group_rows.append((tokens.shape[0], len(engine._groups(tokens.shape[0]))))
        return real(call, trees, tokens, cache)

    monkeypatch.setattr(engine, "_dense_call", spy)
    seen_repack = False
    while not engine.idle:
        engine.step()
        for c in engine.cohorts:
            if c.n_dummy > 0 and len(c.slots) == 3:
                assert (len(c.slots) + c.n_dummy) % 4 == 0
                seen_repack = True
    assert engine.metrics.n_rebalances >= 1 and seen_repack
    assert all(groups == 4 for rows, groups in group_rows if rows % 4 == 0)
    assert (4, 4) in group_rows
