"""The port's paged cache and radix prefix index (`repro_torch.serve.paging`)
against the JAX reference's, on the CPU at smoke size: the single-device
cases of `tests/test_serve_paging.py`.

Engine tests hold port paged == port dense bit for bit (tokens and
captured logits: gather and scatter only move data), port paged == the JAX
reference's paged engine in greedy tokens under the same policy and
schedule, and merge/retire to zero page moves.  Structural tests run the
port's `CacheStore`, `PagedCacheOps` and `RadixPrefixIndex` beside the
reference's on the same operation sequence (the reference's toy layout:
one sequence leaf, one state leaf, two locals) and hold page ids,
ref-counts, free lists, hits, evictions and copy-on-write pages equal.

The rwkv6 and zamba2 cells of ``test_paged_token_identity_staggered`` and
``test_prefix_hit_skips_prefill_token_identical`` are
``test_paged_token_identity_staggered_recurrent`` and
``test_prefix_hit_skips_prefill_recurrent``: their caches page a state leaf
per row (rwkv6 has no sequence leaf at all; zamba2 pages the shared
block's k / v too).  ``test_meshed_paged_identity_and_rebalance_without_copies``
runs on a data=4 x model=2 mesh of logical CPU devices (`launch.mesh`), for
the dense llama and for the dual-sparse main path, against the unsharded
serve and the reference's (unsharded) engine.
``test_admission_ticket_lifecycle_and_shim`` keeps its lifecycle part:
the port has no deprecated ticket shim.  The reference's
``test_prefix_hit_zero_retrace_dual_sparse`` becomes
``test_prefix_hit_builds_no_plan_or_kernel`` (the port does not trace).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.models.registry import build_model as j_build
from repro.serve import CacheStore as JStore
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import PagedCache as JPagedCache
from repro.serve import PagedCacheOps as JOps
from repro.serve import PageLayout as JLayout
from repro.serve import RadixPrefixIndex as JIndex
from repro.serve import paged as j_paged
from repro_torch import bridge
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.launch.serve import build_config
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    AdmissionError,
    AdmissionTicket,
    CacheStore,
    Engine,
    ExecutionPolicy,
    PagedCache,
    PagedCacheOps,
    PagedSpikeCache,
    PageLayout,
    PagePoolExhausted,
    Paging,
    Placement,
    RadixPrefixIndex,
    Scheduler,
    make_serve_mesh,
    paged,
)
from repro_torch.serve.paging import SpikeSlotPool

torch.set_num_threads(1)

LOGIT_TOL = 0.25  # port vs the jitted reference (tests/test_torch_models.py)


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
    return _models(True)


@pytest.fixture(scope="module")
def dense():
    return _models(False)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lens]


def _port(models, paging=None, execution="sync", **kw):
    tcfg, tm, tp = models[1]
    pol = ExecutionPolicy.for_arch(tcfg, execution=execution, paging=paging)
    return Engine(tm, tp, policy=pol, device="cpu", **kw)


def _ref(models, paging=None, execution="sync", **kw):
    jcfg, jm, jp = models[0]
    pol = JPolicy.for_arch(jcfg, execution=execution, paging=paging)
    return JEngine(jm, jp, policy=pol, **kw)


def _run_staggered(engine, prompts, gens, arrivals):
    """The reference test's driver: request i arrives at step arrivals[i]."""
    reqs, t = [], 0
    while len(engine.results) < len(prompts) or reqs == []:
        for i, arr in enumerate(arrivals):
            if arr == t:
                reqs.append(engine.submit(prompts[i], gens[i]))
        engine.step()
        t += 1
        if t > 200:
            raise RuntimeError("staggered serve did not drain")
        if len(reqs) == len(prompts) and engine.idle:
            break
    engine.flush()
    while not engine.idle:
        engine.step()
    return [np.asarray(engine.results[r.rid].generated, np.int32)
            for r in reqs]


# ---------------------------------------------------------------------------
# paged == dense == the reference's paged engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_paged_token_identity_staggered(dense, execution):
    """Staggered continuous batching (a merge, retires, prefix publishes)
    under paged storage: the dense engine's tokens and logits bit for bit,
    and the reference paged engine's tokens.  The len-9 prompt arrives when
    the len-8 cohort reaches position 9, forcing a merge."""
    prompts = _prompts(dense[0][0].vocab, [8, 9, 12])
    gens, arrivals = [4, 5, 4], [0, 1, 1]
    kw = dict(max_len=32, max_slots=8, capture_logits=True)
    d = _port(dense, execution=execution, **kw)
    want = _run_staggered(d, prompts, gens, arrivals)
    p = _port(dense, paged(8), execution, **kw)
    got = _run_staggered(p, prompts, gens, arrivals)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    for ta, tb in zip(d.drain_logit_traces(), p.drain_logit_traces()):
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(y, x)
    assert p.metrics.n_merges >= 1
    ref = _ref(dense, j_paged(8), execution, max_len=32, max_slots=8)
    for a, b in zip(_run_staggered(ref, prompts, gens, arrivals), got):
        np.testing.assert_array_equal(b, a)


_RECURRENT: dict = {}


@pytest.mark.parametrize("which", ["dense", "dual"])
def test_meshed_paged_identity_and_rebalance_without_copies(which, request):
    """Paged + pipelined over a data=4 x model=2 mesh stays token-identical
    to dense unsharded serving (and to the reference's engine: the jitted
    one, or at its near tie, prompt 4 of the dense model at a top-2 gap of
    0.011, the op-by-op one); the load-skew re-pack pads cohorts with
    zeroed pages, never by copying cache state."""
    models = request.getfixturevalue(which)
    tcfg, tm, tp = models[1]
    mesh = make_serve_mesh("data=4,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(8)])
    pol = ExecutionPolicy.for_arch(tcfg, placement=Placement(mesh=mesh),
                                   execution="pipelined", paging=paged(8))
    pe = Engine(tm, tp, max_len=32, max_slots=8, policy=pol,
                prefix_cache=False, device="cpu")
    prompts = _prompts(tcfg.vocab, [8, 8, 8, 8, 12])
    want = _port(models, max_len=32, max_slots=8).generate_batch(prompts, 6)
    got = pe.generate_batch(prompts, 6)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    jwant = _ref(models, max_len=32, max_slots=8).generate_batch(prompts, 6)
    if not all(np.array_equal(a, b) for a, b in zip(jwant, got)):
        with jax.disable_jit():
            jwant = _ref(models, max_len=32, max_slots=8).generate_batch(
                prompts, 6)
    for a, b in zip(jwant, got):
        np.testing.assert_array_equal(a, b)
    assert pe.metrics.n_page_moves == 0
    s = pe.summary()
    assert s["mesh"] == "data=4xmodel=2" and s["padded_rows"] >= 3


def _recurrent(arch):
    """(reference, port) cfg, model and params of a recurrent arch's smoke
    variant (the port's bridged from the reference's)."""
    if arch not in _RECURRENT:
        jcfg = smoke_variant(get_config(arch))
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = build_config(arch, smoke=True, spiking=False, weight_density=1.0)
        tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
        _RECURRENT[arch] = (jcfg, jm, jp), (tcfg, t_build(tcfg), tp)
    return _RECURRENT[arch]


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "zamba2_7b"])
def test_paged_token_identity_staggered_recurrent(arch, execution):
    """The reference's rwkv6 / zamba2 cells of the staggered test: paged ==
    dense bit for bit (tokens and captured logits; the state leaves are one
    page per row), a merge happened, and the tokens equal the reference's
    paged engine's."""
    models = _recurrent(arch)
    prompts = _prompts(models[0][0].vocab, [8, 9, 12])
    gens, arrivals = [4, 5, 4], [0, 1, 1]
    kw = dict(max_len=32, max_slots=8, capture_logits=True)
    d = _port(models, execution=execution, **kw)
    want = _run_staggered(d, prompts, gens, arrivals)
    p = _port(models, paged(8), execution, **kw)
    got = _run_staggered(p, prompts, gens, arrivals)
    assert p.store.layout.has_state
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    for ta, tb in zip(d.drain_logit_traces(), p.drain_logit_traces()):
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(y, x)
    assert p.metrics.n_merges >= 1
    ref = _ref(models, j_paged(8), execution, max_len=32, max_slots=8)
    for a, b in zip(_run_staggered(ref, prompts, gens, arrivals), got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "zamba2_7b"])
def test_prefix_hit_skips_prefill_recurrent(arch):
    """The reference's rwkv6 / zamba2 cells of the prefix-hit test: a
    repeated prompt is a full-prompt hit (its state page and locals come
    from the index), no prefill runs, and the tokens are the cold path's."""
    models = _recurrent(arch)
    prompts = _prompts(models[0][0].vocab, [8, 12])
    pe = _port(models, paged(8), max_len=32, max_slots=8)
    cold = pe.generate_batch(prompts, 5)
    prefills_before = pe.metrics.n_prefill_batches
    t0, t1 = pe.submit(prompts[0], 5), pe.submit(prompts[1], 5)
    assert t0.prefix_hit and t1.prefix_hit
    assert t0.reused_tokens == 8 and t1.reused_tokens == 12
    out = pe.run()
    assert pe.metrics.n_prefill_batches == prefills_before
    assert pe.metrics.n_prefix_hits == 2
    np.testing.assert_array_equal(out[t0.rid], cold[0])
    np.testing.assert_array_equal(out[t1.rid], cold[1])


def test_paged_token_identity_dual_sparse(dual):
    prompts = _prompts(dual[0][0].vocab, [8, 8, 12])
    kw = dict(max_len=32, max_slots=8)
    want = _port(dual, **kw).generate_batch(prompts, 5)
    pe = _port(dual, paged(8), **kw)
    got = pe.generate_batch(prompts, 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert pe.spiking_packed and pe._spike_pool is not None
    ref = _ref(dual, j_paged(8), **kw).generate_batch(prompts, 5)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_paged_logits_near_reference_paged_engine(dual):
    """Captured logits of the port's paged serve within the jitted bound of
    the reference's paged serve (both capture, so neither has a prefix
    index)."""
    prompts = _prompts(dual[0][0].vocab, [8, 8], seed=3)
    kw = dict(max_len=16, max_slots=2, capture_logits=True)
    pe = _port(dual, paged(8), "pipelined", **kw)
    ref = _ref(dual, j_paged(8), "pipelined", **kw)
    got, want = pe.generate_batch(prompts, 5), ref.generate_batch(prompts, 5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    for tw, tg in zip(ref.drain_logit_traces(), pe.drain_logit_traces()):
        np.testing.assert_allclose(np.stack(tg), np.stack(tw), rtol=0,
                                   atol=LOGIT_TOL)
    assert pe.prefix_index is None


def test_paged_rejects_indivisible_max_len(dense):
    with pytest.raises(ValueError, match="multiple"):
        _port(dense, paged(8), max_len=30, max_slots=4)


def test_paging_axis_validated_and_described():
    with pytest.raises(ValueError, match="multiple of 8"):
        paged(12)
    with pytest.raises(ValueError, match="paging mode"):
        Paging("virtual")
    pol = ExecutionPolicy(paging=paged(16))
    assert "paging=paged(page_size=16)" in pol.describe()
    assert pol.paging.describe() == JPolicy(paging=j_paged(16)).paging.describe()
    assert ExecutionPolicy().paging == Paging()


# ---------------------------------------------------------------------------
# zero page moves on merge / retire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_merge_retire_move_no_pages(dense, execution):
    """With the prefix index off, a staggered serve full of merges and
    retires never copies a page, and every page returns to the pool."""
    pe = _port(dense, paged(8), execution, max_len=32, max_slots=8,
               prefix_cache=False)
    prompts = _prompts(dense[0][0].vocab, [8, 8, 9, 10])
    _run_staggered(pe, prompts, [6, 4, 5, 4], [0, 0, 1, 2])
    assert pe.metrics.n_merges > 0
    assert pe.metrics.n_page_moves == 0
    s = pe.store.summary()
    assert s["seq_pages_free"] == s["seq_pages_total"]


# ---------------------------------------------------------------------------
# prefix reuse: skip prefill, stay token-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_prefix_hit_skips_prefill_token_identical(dense, execution):
    prompts = _prompts(dense[0][0].vocab, [8, 12])
    pe = _port(dense, paged(8), execution, max_len=32, max_slots=8)
    cold = pe.generate_batch(prompts, 5)
    prefills_before = pe.metrics.n_prefill_batches
    t0 = pe.submit(prompts[0], 5)
    t1 = pe.submit(prompts[1], 5)
    assert t0.prefix_hit and t1.prefix_hit
    assert t0.reused_tokens == 8 and t1.reused_tokens == 12
    out = pe.run()
    assert pe.metrics.n_prefill_batches == prefills_before
    assert pe.metrics.n_prefix_hits == 2
    assert pe.metrics.n_prefix_tokens_reused == 20
    np.testing.assert_array_equal(out[t0.rid], cold[0])
    np.testing.assert_array_equal(out[t1.rid], cold[1])
    assert t0.outcome == "admitted"
    # the reference engine's hits give the same tokens
    ref = _ref(dense, j_paged(8), execution, max_len=32, max_slots=8)
    ref.generate_batch(prompts, 5)
    want = ref.generate_batch(prompts, 5)
    assert ref.metrics.n_prefix_hits == 2
    np.testing.assert_array_equal(out[t0.rid], want[0])
    np.testing.assert_array_equal(out[t1.rid], want[1])


def test_prefix_hit_builds_no_plan_or_kernel(dual, monkeypatch):
    """A hit reuses the engine's join plans and the built kernels: no plan
    or kernel build runs for it (the reference: no retrace)."""
    from repro_torch.kernels import _build, join_plan

    prompts = _prompts(dual[0][0].vocab, [8])
    pe = _port(dual, paged(8), max_len=32, max_slots=8)
    cold = pe.generate_batch(prompts, 5)
    calls = []
    monkeypatch.setattr(join_plan, "build_weight_plan",
                        lambda *a, **k: calls.append("plan"))
    monkeypatch.setattr(_build, "load", lambda *a, **k: calls.append("kernel"))
    t = pe.submit(prompts[0], 5)
    out = pe.run()
    assert t.prefix_hit and not calls
    np.testing.assert_array_equal(out[t.rid], cold[0])


def test_partial_prefix_is_not_a_hit(dense):
    """Only exact full-prompt matches reuse pages."""
    prompts = _prompts(dense[0][0].vocab, [16])
    pe = _port(dense, paged(8), max_len=32, max_slots=8)
    pe.generate_batch(prompts, 4)
    extended = np.concatenate([prompts[0], prompts[0][:2]])
    t = pe.submit(extended[:18], 4)
    t2 = pe.submit(prompts[0][:8], 4)
    assert not t.prefix_hit and not t2.prefix_hit
    pe.run()


def test_prefix_cache_flag_validation(dense):
    with pytest.raises(ValueError, match="paged"):
        _port(dense, max_len=32, max_slots=4, prefix_cache=True)
    with pytest.raises(ValueError, match="bitwise|capture"):
        _port(dense, paged(8), max_len=32, max_slots=4, capture_logits=True,
              prefix_cache=True)


# ---------------------------------------------------------------------------
# layout / store / cache-ops units, beside the reference's
# ---------------------------------------------------------------------------

def _toy_layouts(ps=8, S=32):
    """(reference, port) layouts of the reference tests' toy cache."""
    jt = {"k": jnp.zeros((2, 1, S, 2), jnp.float32),
          "state": jnp.zeros((2, 1, 3), jnp.float32),
          "kv_pos": jnp.zeros((S,), jnp.int32),
          "pos": jnp.zeros((), jnp.int32)}
    tt = {"k": torch.zeros((2, 1, S, 2)), "state": torch.zeros((2, 1, 3)),
          "kv_pos": torch.zeros((S,), dtype=torch.int32), "pos": 0}
    axes = {"k": ("layers", "batch", "cache_seq", None),
            "state": ("layers", "batch", None),
            "kv_pos": ("cache_seq",), "pos": ()}
    return JLayout(jt, axes, ps), PageLayout(tt, axes, ps)


def _toy_stores(n_rows=6, ps=8, S=32):
    jl, tl = _toy_layouts(ps, S)
    return JStore(jl, n_rows), CacheStore(tl, n_rows)


def _same_books(js, ts):
    """Page accounting equal: ref-counts and free lists of both kinds."""
    np.testing.assert_array_equal(ts._seq_ref, js._seq_ref)
    np.testing.assert_array_equal(ts._state_ref, js._state_ref)
    assert ts._seq_free == js._seq_free
    assert ts._state_free == js._state_free


def _pages_equal(js, ts, key_j="l0", key_t="k"):
    """Pool contents equal (the reference pools lead with the page axis,
    the port's hold it where the batch axis was)."""
    np.testing.assert_array_equal(
        ts.pools[key_t].movedim(1, 0).numpy(), np.asarray(js.pools[key_j]))


def test_layout_classification_and_validation():
    jl, tl = _toy_layouts()
    assert (tl.pages_per_row, tl.has_state) == (jl.pages_per_row, jl.has_state)
    assert tl.pages_per_row == 4 and tl.has_state
    assert tl.seq_keys == ["k"] and tl.state_keys == ["state"]
    assert tl.local_keys == ["kv_pos", "pos"] and tl.pos_key == "pos"
    with pytest.raises(ValueError, match="multiple"):
        _toy_layouts(ps=8, S=28)


def test_gather_scatter_roundtrip_is_exact():
    """scatter_all then gather rebuilds the dense view bit for bit; a step
    scatter writes exactly the touched page."""
    _, tl = _toy_layouts()
    store = CacheStore(tl, 4)
    seq, state = store.alloc_rows(2)
    seq_dev, state_dev = (torch.from_numpy(seq).long(),
                          torch.from_numpy(state).long())
    g = torch.Generator().manual_seed(0)
    cache = {"k": torch.randn((2, 2, 32, 2), generator=g),
             "state": torch.randn((2, 2, 3), generator=g),
             "kv_pos": torch.arange(32, dtype=torch.int32), "pos": 5}
    tl.scatter_all(store.pools, cache, seq_dev, state_dev)
    view = tl.gather(store.pools, seq_dev, state_dev, tl.locals_of(cache))
    assert view["k"].is_contiguous()
    assert torch.equal(view["k"], cache["k"])
    assert torch.equal(view["state"], cache["state"])
    view["k"][:, :, 9] = 7.0                     # a write at position 9
    before = store.pools["k"].clone()
    tl.scatter_step(store.pools, view, seq_dev, state_dev, pos=9)
    changed = (store.pools["k"] != before).any(dim=(0, 2, 3))
    assert set(np.nonzero(changed.numpy())[0]) == {int(seq[0, 1]), int(seq[1, 1])}


def test_store_alloc_free_refcount_roundtrip():
    js, ts = _toy_stores(n_rows=2)
    for store in (js, ts):
        seq, state = store.alloc_rows(2)
        assert store.free_seq_pages == store.n_seq_pages - 8
        store.incref_seq(seq[0])
        store.decref_seq(seq[0])
        assert store.free_seq_pages == store.n_seq_pages - 8
        store.decref_seq(seq)
        store.decref_state(state)
        assert store.free_seq_pages == store.n_seq_pages
        assert store.free_state_pages == store.n_state_pages
        with pytest.raises(PagePoolExhausted if store is ts else Exception):
            store.alloc_seq(store.n_seq_pages + 1)
    _same_books(js, ts)


def test_paged_cache_ops_are_table_edits():
    js, ts = _toy_stores(n_rows=8)
    jops, tops = JOps(js), PagedCacheOps(ts)
    jloc = [jnp.zeros((32,), jnp.int32), jnp.zeros((), jnp.int32)]
    tloc = {"kv_pos": torch.zeros((32,), dtype=torch.int32), "pos": 0}
    ja = JPagedCache(js, *js.alloc_rows(2), jloc)
    jb = JPagedCache(js, *js.alloc_rows(1), jloc)
    ta = PagedCache(ts, *ts.alloc_rows(2), tloc)
    tb = PagedCache(ts, *ts.alloc_rows(1), tloc)
    np.testing.assert_array_equal(ta.seq_table, ja.seq_table)
    jm, tm = jops.concat([ja, jb]), tops.concat([ta, tb])
    assert tops.batch_size(tm) == jops.batch_size(jm) == 3
    np.testing.assert_array_equal(tm.seq_table, jm.seq_table)
    jk, tk = jops.take(jm, [0, 2]), tops.take(tm, [0, 2])
    np.testing.assert_array_equal(tk.seq_table, jk.seq_table)
    np.testing.assert_array_equal(tk.state_table, jk.state_table)
    _same_books(js, ts)
    assert ts.free_seq_pages == ts.n_seq_pages - 2 * 4
    tops.take(tk, [])
    jops.take(jk, [])
    _same_books(js, ts)
    assert ts.free_seq_pages == ts.n_seq_pages
    # differing locals refuse to merge (the cohort-position invariant)
    c = PagedCache(ts, *ts.alloc_rows(1), dict(tloc, pos=1))
    with pytest.raises(ValueError, match="locals"):
        tops.concat([PagedCache(ts, *ts.alloc_rows(1), tloc), c])


def test_paged_spike_cache_pool_bookkeeping():
    pool = SpikeSlotPool(width=4, n_rows=8)
    a = PagedSpikeCache(T=4, width=4, pool=pool)
    b = PagedSpikeCache(T=4, width=4, pool=pool)
    a.append(torch.ones((2, 4), dtype=torch.int32))
    b.append(torch.full((1, 4), 7, dtype=torch.int32))
    a.merge(b)
    assert len(a) == 3 and len(b) == 0
    assert torch.equal(a.words[2], torch.full((4,), 7, dtype=torch.int32))
    a.take([2])
    assert len(a) == 1 and len(pool._free) == 7
    a.update(torch.zeros((1, 4), dtype=torch.int32))
    assert a.silent_fraction() == 1.0
    a.update_async(torch.ones((1, 4), dtype=torch.int32))
    assert a.spike_sparsity() == 0.75      # bit 0 of 4 timesteps
    a.take([])
    assert len(pool._free) == 8


# ---------------------------------------------------------------------------
# radix index: the reference's operation sequences, both packages in step
# ---------------------------------------------------------------------------

def _publish(index, store, prompt, locals_, first_token=1):
    """Publish a prompt as a freshly 'prefilled' row, then release the row
    (as retirement would): the index's holds must keep pages alive."""
    seq, state = store.alloc_rows_zeroed(1)
    entry = index.publish(prompt, seq[0], int(state[0]), locals_, first_token)
    store.decref_seq(seq)
    store.decref_state(state)
    return entry


J_LOCALS = [np.zeros((32,), np.int32), np.zeros((), np.int32)]
T_LOCALS = {"kv_pos": torch.zeros((32,), dtype=torch.int32), "pos": 0}


def _same_entry(je, te):
    assert (je is None) == (te is None)
    if je is None:
        return
    np.testing.assert_array_equal(te.full_pages, je.full_pages)
    assert (te.tail_page, te.state_page, te.alive, te.last_used) == (
        je.tail_page, je.state_page, je.alive, je.last_used)


def test_hash_collision_safety(monkeypatch):
    """With every hash colliding, lookups still only match exact prompts
    and the trie still tells chunks apart, in both packages alike."""
    monkeypatch.setattr(RadixPrefixIndex, "_hash", staticmethod(lambda d: 42))
    monkeypatch.setattr(JIndex, "_hash", staticmethod(lambda d: 42))
    js, ts = _toy_stores(n_rows=8)
    ji, ti = JIndex(js, max_entries=8), RadixPrefixIndex(ts, max_entries=8)
    p1 = np.arange(12, dtype=np.int32)
    p2 = np.arange(12, dtype=np.int32) + 100
    out = []
    for p in (p1, p2):
        je, te = _publish(ji, js, p, J_LOCALS), _publish(ti, ts, p, T_LOCALS)
        _same_entry(je, te)
        out.append(te)
    e1, e2 = out
    assert ti.lookup(p1) is e1 and ti.lookup(p2) is e2
    assert ti.lookup(np.arange(12, dtype=np.int32) + 1) is None
    assert e1.full_pages[0] != e2.full_pages[0]
    _same_books(js, ts)


@pytest.mark.parametrize("seed", range(12))
def test_refcounts_conserved_under_interleaved_admit_retire(seed):
    """A seeded random interleaving of publish / hit-admit / retire / evict
    keeps page accounting conserved and equal to the reference's after
    every operation, and draining everything frees every page."""
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(5, 41))
    js, ts = _toy_stores(n_rows=10)
    ji, ti = JIndex(js, max_entries=4), RadixPrefixIndex(ts, max_entries=4)
    prompt_pool = [rng.integers(0, 50, size=(n,)).astype(np.int32)
                   for n in (8, 8, 12, 16, 20)]
    live = []                       # (ref row, port row) admitted hits
    for _ in range(n_ops):
        op = int(rng.integers(4))
        p = prompt_pool[int(rng.integers(len(prompt_pool)))]
        if op == 0:
            _same_entry(_publish(ji, js, p, J_LOCALS),
                        _publish(ti, ts, p, T_LOCALS))
        elif op == 1:
            je, te = ji.lookup(p), ti.lookup(p)
            _same_entry(je, te)
            if te is not None:
                try:
                    tr = ti.admit(te)
                except PagePoolExhausted:
                    with pytest.raises(Exception, match="out of"):
                        ji.admit(je)
                else:
                    jr = ji.admit(je)
                    np.testing.assert_array_equal(tr[0], jr[0])
                    np.testing.assert_array_equal(tr[1], jr[1])
                    live.append((jr, tr))
        elif op == 2 and live:
            (jseq, jst), (tseq, tst) = live.pop(int(rng.integers(len(live))))
            js.decref_seq(jseq)
            js.decref_state(jst)
            ts.decref_seq(tseq)
            ts.decref_state(tst)
        elif op == 3:
            assert ti.evict_lru() == ji.evict_lru()
        held = int((ts._seq_ref > 0).sum())
        assert ts.free_seq_pages + held == ts.n_seq_pages
        _same_books(js, ts)
        assert (ti.n_hits, ti.n_lookups, len(ti)) == (ji.n_hits, ji.n_lookups,
                                                      len(ji))
    for (jseq, jst), (tseq, tst) in live:
        js.decref_seq(jseq)
        js.decref_state(jst)
        ts.decref_seq(tseq)
        ts.decref_state(tst)
    while ti.evict_lru():
        assert ji.evict_lru()
    assert not ji.evict_lru()
    assert ts.free_seq_pages == ts.n_seq_pages
    assert ts.free_state_pages == ts.n_state_pages
    _same_books(js, ts)


def test_copy_on_write_at_divergence_page():
    """A hit shares the full-chunk pages by reference but gets its own copy
    of the divergence (tail) page, the same pages as the reference's."""
    js, ts = _toy_stores(n_rows=8)
    ji, ti = JIndex(js, max_entries=8), RadixPrefixIndex(ts, max_entries=8)
    prompt = np.arange(12, dtype=np.int32)     # 1 full chunk + a 4-token tail
    jseq, jst = js.alloc_rows_zeroed(1)
    tseq, tst = ts.alloc_rows_zeroed(1)
    js.pools["l0"] = js.pools["l0"].at[int(jseq[0][1])].set(7.0)
    ts.pools["k"][:, int(tseq[0][1])] = 7.0
    je = ji.publish(prompt, jseq[0], int(jst[0]), J_LOCALS, first_token=5)
    entry = ti.publish(prompt, tseq[0], int(tst[0]), T_LOCALS, first_token=5)
    for store, seq, st in ((js, jseq, jst), (ts, tseq, tst)):
        store.decref_seq(seq)
        store.decref_state(st)
    _same_entry(je, entry)
    ja, jb = ji.admit(je), ji.admit(je)
    (row_a, st_a), (row_b, st_b) = ti.admit(entry), ti.admit(entry)
    np.testing.assert_array_equal(row_a, ja[0])
    np.testing.assert_array_equal(row_b, jb[0])
    assert row_a[0] == row_b[0] == entry.full_pages[0]
    assert ts.seq_refcount(int(entry.full_pages[0])) == 3
    tails = {int(entry.tail_page), int(row_a[1]), int(row_b[1])}
    assert len(tails) == 3
    for t in tails:
        assert bool((ts.pools["k"][:, t] == 7.0).all())
    _pages_equal(js, ts)
    _same_books(js, ts)
    assert ts.metrics is None and js.metrics is None
    # writes into one hit's tail page leave the snapshot and the other hit
    ts.pools["k"][:, int(row_a[1])] = 9.0
    assert bool((ts.pools["k"][:, int(entry.tail_page)] == 7.0).all())
    assert bool((ts.pools["k"][:, int(row_b[1])] == 7.0).all())
    assert len({int(st_a[0]), int(st_b[0]), int(entry.state_page)}) == 3


@pytest.mark.parametrize("seed", range(6))
def test_eviction_under_page_pool_pressure(seed):
    """Publishing more prompts than the pool can snapshot evicts LRU
    entries through the store's pressure hook, as the reference does;
    pinned entries are never evicted."""
    rng = np.random.default_rng(seed)
    js, ts = _toy_stores(n_rows=4)             # 16 sequence pages
    ji, ti = JIndex(js, max_entries=32), RadixPrefixIndex(ts, max_entries=32)
    prompts = [rng.integers(0, 50, size=(12,)).astype(np.int32)
               for _ in range(10)]
    published = []
    for p in prompts:
        try:
            te = _publish(ti, ts, p, T_LOCALS)
        except PagePoolExhausted:
            with pytest.raises(Exception, match="out of"):
                _publish(ji, js, p, J_LOCALS)
            continue
        _same_entry(_publish(ji, js, p, J_LOCALS), te)
        if te is not None:
            published.append(te)
        _same_books(js, ts)
    assert published
    assert any(not e.alive for e in published)
    held = int((ts._seq_ref > 0).sum())
    assert ts.free_seq_pages + held == ts.n_seq_pages
    survivor = next(e for e in published if e.alive)
    survivor.pins += 1
    for p in prompts[:4]:
        try:
            _publish(ti, ts, p + 1000, T_LOCALS)
        except PagePoolExhausted:
            pass
    assert survivor.alive
    survivor.pins -= 1


def test_evicted_entry_cannot_serve_queued_hit():
    _, ts = _toy_stores(n_rows=8)
    index = RadixPrefixIndex(ts, max_entries=8)
    entry = _publish(index, ts, np.arange(12, dtype=np.int32), T_LOCALS)
    index._evict(entry)
    with pytest.raises(RuntimeError, match="evicted"):
        index.admit(entry)


def test_hit_pin_held_through_selection_to_admit_window():
    """The submit-time pin is held from selection until the engine's admit
    completes (`release_hit_pins`), so pool pressure inside that window
    cannot evict a selected hit."""
    _, ts = _toy_stores(n_rows=8)
    index = RadixPrefixIndex(ts, max_entries=8)
    prompt = np.arange(12, dtype=np.int32)
    entry = _publish(index, ts, prompt, T_LOCALS)
    s = Scheduler(max_slots=4, max_queue=8, max_len=64, prefix_index=index)
    t = s.submit(prompt, 4)
    assert t.prefix_hit and entry.pins == 1
    group = s.next_prefix_hits()
    assert [r.rid for r, _ in group] == [t.rid]
    assert entry.pins == 1
    assert not index.evict_lru()
    assert entry.alive
    row, state = index.admit(entry)
    s.release_hit_pins(group)
    assert entry.pins == 0
    ts.decref_seq(row)
    ts.decref_state(state)
    assert index.evict_lru() and not entry.alive


def test_admission_ticket_lifecycle(dense):
    pe = _port(dense, paged(8), max_len=32, max_slots=4)
    t = pe.submit(_prompts(dense[0][0].vocab, [8])[0], 4)
    assert isinstance(t, AdmissionTicket)
    assert t.outcome == "queued" and not t.prefix_hit
    assert isinstance(t.rid, int)
    pe.step()
    assert t.outcome == "admitted"
    pe.run()
    with pytest.raises(AdmissionError) as exc:
        pe.submit(np.zeros(0, np.int32), 4)
    assert exc.value.ticket.outcome == "rejected"
    assert exc.value.ticket.rid is None


def test_dense_and_paged_cache_ops_share_the_facade(dense):
    """Both backends implement `CacheOps`; the dense one reads the batch
    size off the leaf the axes mark, as the reference's does."""
    from repro.serve import DenseCacheOps as JDenseOps
    from repro_torch.serve import CacheOps, DenseCacheOps

    (_, jm, _), (_, tm, _) = dense
    ops = DenseCacheOps(tm.cache_axes())
    assert isinstance(ops, CacheOps) and issubclass(PagedCacheOps, CacheOps)
    cache = tm.init_cache(3, 16, device="cpu")
    assert ops.batch_size(cache) == JDenseOps(jm.cache_axes()).batch_size(
        jm.init_cache(3, 16)) == 3
    assert ops.batch_size(ops.take(cache, [0, 2])) == 2
