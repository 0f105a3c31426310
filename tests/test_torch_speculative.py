"""The port's speculative decoding (`ExecutionPolicy.speculation`, the
executor's propose/verify round, `Engine.rewind_cache`) against the JAX
reference's, on the CPU at smoke size: the single-device cases of
`tests/test_speculative.py`.

Both packages get the reference's params (`repro_torch.bridge`).  Held:
* `acceptance_lengths`, `prune_to_density`, `derive_draft_params` and the
  window dispatch equal the reference's on the same numpy inputs (the
  acceptance properties on seeded draws instead of Hypothesis examples);
* every validation error of the axis, word for word;
* port speculative tokens == port non-speculative tokens, bit for bit,
  across {sync, pipelined} x {dense, paged}; a 0.2-density packed draft
  rejects some proposals and changes no token; rewound cache locals equal,
  bit for bit, those of a cohort that never speculated;
* port tokens == the reference engine's (speculative and not, which are
  equal), except at a near tie of the jitted reference: XLA keeps fused
  bf16 residual adds in f32, so its logits sit up to 0.25 from the port's
  op-by-op ones (`tests/test_torch_models.py`).  A request may then differ
  from its first differing token on, and only where the reference's top
  two logits there lie within 2 x 0.25 (this file's llama smoke at density
  0.5 has one: prompt 4 of the matrix, 3.110 vs 3.049 in the reference and
  3.052 vs 3.033 the other way in the port, which the reference run op by
  op under ``jax.disable_jit`` reproduces).

The ``mesh`` cells of ``test_speculative_token_identity_matrix`` are
``test_speculative_token_identity_matrix_mesh``, on a data=4 x model=2
mesh of logical CPU devices (`launch.mesh`): the draft and its target
share the mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.kernels import ops as j_ops
from repro.kernels.join_plan import _build_weight_plan_host
from repro.kernels.join_plan import prune_to_density as j_prune_to_density
from repro.models.layers import derive_draft_params as j_derive
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import acceptance_lengths as j_acceptance
from repro.serve import draft as j_draft
from repro.serve.policy import PACKED_DUAL as J_PACKED_DUAL
from repro.serve.policy import PACKED_DUAL_ADAPTIVE as J_PACKED_DUAL_ADAPTIVE
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels.join_plan import build_weight_plan, prune_to_density
from repro_torch.launch.serve import build_config
from repro_torch.models.layers import derive_draft_params
from repro_torch.models.registry import build_model as t_build
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.serve import (
    DenseCacheOps,
    Engine,
    EngineMetrics,
    ExecutionPolicy,
    Speculation,
    Placement,
    acceptance_lengths,
    adaptive_t,
    approximate,
    draft,
    make_serve_mesh,
    paged,
)
from repro_torch.serve.policy import PACKED_DUAL, PACKED_DUAL_ADAPTIVE

torch.set_num_threads(1)

# the port against the jitted reference's logits (tests/test_torch_models.py)
LOGIT_TOL = 0.25


@pytest.fixture(scope="module")
def models():
    """The reference file's model: llama3.2-1b smoke with spiking FFNs at
    T = 4 and weight density 0.5, in both packages (the reference's
    params bridged to the port)."""
    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               spiking_ffn=True, spiking_T=4,
                               spiking_weight_density=0.5)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        build_config("llama3_2_1b", smoke=True, spiking=True,
                     weight_density=0.5), spiking_T=4)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, vocab, size=(n,)), np.int32)
            for n in lens]


def _float_draft(cfg, policy_cls=ExecutionPolicy):
    return policy_cls.for_arch(cfg, spike_format="float",
                               weight_sparsity="dense")


def _hold_to_reference(got, ref_tokens, ref_logits):
    """Port tokens against the jitted reference's: equal, or equal up to a
    first differing position where the reference's top two logits lie
    within 2 x LOGIT_TOL (the contexts differ after it).  Returns the
    number of requests that differ."""
    n_differ = 0
    for g, r, lg in zip(got, ref_tokens, ref_logits):
        assert len(g) == len(r)
        diff = np.nonzero(np.asarray(g) != np.asarray(r))[0]
        if diff.size:
            top2 = np.sort(np.asarray(lg[diff[0]]))[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (g, r, top2)
            n_differ += 1
    return n_differ


# ---------------------------------------------------------------------------
# longest-accepted-prefix properties, against the reference's function
# ---------------------------------------------------------------------------

def _prefix(d_row, t_row):
    a = 0
    while a < len(d_row) and d_row[a] == t_row[a]:
        a += 1
    return a


@pytest.mark.parametrize("seed", range(4))
def test_acceptance_is_longest_matching_prefix(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        b, k = int(rng.integers(1, 6)), int(rng.integers(1, 9))
        vocab = int(rng.integers(1, 5))  # tiny: every prefix length occurs
        d = rng.integers(0, vocab, size=(b, k))
        t = rng.integers(0, vocab, size=(b, k + 1))
        acc = acceptance_lengths(d, t)
        np.testing.assert_array_equal(acc, j_acceptance(d, t))
        assert acc.shape == (b,) and acc.dtype == np.int64
        for i in range(b):
            a = int(acc[i])
            assert 0 <= a <= k and a == _prefix(d[i], t[i])
            assert a == k or d[i, a] != t[i, a]


@pytest.mark.parametrize("seed", range(2))
def test_acceptance_all_reject_and_all_accept(seed):
    rng = np.random.default_rng(seed + 10)
    for _ in range(10):
        b, k = int(rng.integers(1, 7)), int(rng.integers(1, 9))
        d = rng.integers(0, 100, size=(b, k))
        t = d.copy()
        t[:, 0] += 1  # first proposal wrong in every row
        assert np.all(acceptance_lengths(d, t) == 0)
        np.testing.assert_array_equal(acceptance_lengths(d, t),
                                      j_acceptance(d, t))
        assert np.all(acceptance_lengths(d, d) == k)


def test_acceptance_k0_degenerates_to_plain_decode():
    acc = acceptance_lengths(np.zeros((3, 0), np.int32),
                             np.zeros((3, 0), np.int32))
    assert acc.shape == (3,) and np.all(acc == 0)


def test_acceptance_shape_validation():
    for fn in (acceptance_lengths, j_acceptance):
        with pytest.raises(ValueError, match=r"\(B, k\)"):
            fn(np.zeros(4, np.int32), np.zeros((4, 4), np.int32))
        with pytest.raises(ValueError, match="cover every proposed"):
            fn(np.zeros((2, 4), np.int32), np.zeros((2, 3), np.int32))


# ---------------------------------------------------------------------------
# policy axis: construction + validation, the reference's errors
# ---------------------------------------------------------------------------

def test_speculation_axis_defaults_off(models):
    tcfg = models[1][0]
    pol = ExecutionPolicy.for_arch(tcfg)
    assert not pol.speculation.enabled
    assert "speculation=none" in pol.describe()
    assert "speculation=none" in JPolicy.for_arch(models[0][0]).describe()


def test_draft_helper_builds_validated_axis(models):
    tcfg = models[1][0]
    spec = draft(_float_draft(tcfg), k=3)
    assert spec.enabled and spec.k == 3
    pol = ExecutionPolicy.for_arch(tcfg, speculation=spec)
    want = j_draft(_float_draft(models[0][0], JPolicy), k=3).describe()
    assert spec.describe() == want
    assert "draft" in pol.describe() and "k=3" in pol.describe()


def _bad_constructions(cfg, cls, draft_fn, paged_fn):
    fd = _float_draft(cfg, cls)
    return [
        ("k >= 1", lambda: draft_fn(fd, k=0)),
        ("full draft ExecutionPolicy",
         lambda: type(draft_fn(fd, k=1))(mode="draft", draft="float", k=4)),
        ("cannot themselves speculate",
         lambda: draft_fn(cls.for_arch(cfg, speculation=draft_fn(fd, k=2)),
                          k=2)),
        ("execution axis must be 'sync'",
         lambda: draft_fn(cls.for_arch(cfg, execution="pipelined"), k=2)),
        ("owned by the ENGINE",
         lambda: draft_fn(cls.for_arch(cfg, paging=paged_fn(page_size=8)),
                          k=2)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_speculation_rejects_bad_construction(models, case):
    """The same error, word for word, from both packages."""
    from repro.serve import paged as j_paged

    msg, bad = _bad_constructions(models[1][0], ExecutionPolicy, draft,
                                  paged)[case]
    with pytest.raises(ValueError, match=msg) as got:
        bad()
    _, jbad = _bad_constructions(models[0][0], JPolicy, j_draft,
                                 j_paged)[case]
    with pytest.raises(ValueError, match=msg) as want:
        jbad()
    assert str(got.value) == str(want.value)
    assert Speculation is type(draft(_float_draft(models[1][0]), k=1))


def test_speculation_requires_bitwise_target(models):
    from repro.serve import adaptive_t as j_adaptive_t
    from repro.serve import approximate as j_approximate

    errors = []
    for cls, dfn, at, ap, cfg in (
            (ExecutionPolicy, draft, adaptive_t, approximate, models[1][0]),
            (JPolicy, j_draft, j_adaptive_t, j_approximate, models[0][0])):
        with pytest.raises(ValueError, match="bitwise target") as e:
            cls.for_arch(cfg, temporal=at(min_spikes=2),
                         exactness=ap(tol=0.5),
                         speculation=dfn(_float_draft(cfg, cls), k=4))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_draft_density_must_prune_at_least_as_hard(models):
    errors = []
    for cls, dfn, cfg in ((ExecutionPolicy, draft, models[1][0]),
                          (JPolicy, j_draft, models[0][0])):
        with pytest.raises(ValueError, match="prune AT LEAST as hard") as e:
            cls.for_arch(cfg, speculation=dfn(cls.for_arch(cfg), k=4,
                                              draft_weight_density=0.8))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="requires a dual-sparse draft"):
        draft(_float_draft(models[1][0]), k=2, draft_weight_density=0.2)


# ---------------------------------------------------------------------------
# kernel layer: draft weights and the decode window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.05, 0.2, 0.5])
@pytest.mark.parametrize("K,N", [(128, 256), (96, 160)])
def test_prune_to_density_bitwise(density, K, N):
    """The reference's block rule (block-aligned and element fallback)."""
    w = np.random.default_rng(K + N).normal(size=(K, N)).astype(np.float32)
    want = np.asarray(j_prune_to_density(w, density))
    got = prune_to_density(torch.from_numpy(w), density).numpy()
    np.testing.assert_array_equal(got, want)


def test_derive_draft_params_bitwise(models):
    (jcfg, _, jp), (tcfg, _, tp) = models
    jd = jax.tree.map(np.asarray, j_derive(jp, jcfg, 0.2))
    td = derive_draft_params(tp, tcfg, 0.2)
    for i, lp in enumerate(td["layers"]):
        for name in ("wu", "wd"):
            np.testing.assert_array_equal(lp["mlp"][name].numpy(),
                                          jd["layers"]["mlp"][name][i])
            assert float((lp["mlp"][name] != 0).float().mean()) <= 0.21
        # every other leaf is the target's own tensor
        assert lp["attn"]["wq"] is tp["layers"][i]["attn"]["wq"]
    assert td["embed"] is tp["embed"]
    with pytest.raises(ValueError, match="spiking-FFN"):
        derive_draft_params(tp, dataclasses.replace(tcfg, spiking_ffn=False),
                            0.2)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
def test_decode_window_matches_reference_and_positions(adaptive, fuse):
    """A (B, S, K) window through `dispatch_decode_window`: equal to the
    reference's window dispatch, and each position equal, bit for bit, to
    its own (B, 1) dispatch (every position holds a spike in every plane,
    so the adaptive gate keeps them all, alone or pooled)."""
    from _data import mk_packed_and_weights as _mk

    rng = np.random.default_rng(3 + fuse + 2 * adaptive)
    B, S, K, N, T = 2, 5, 128, 128, 4
    packed, w = _mk(rng, T, B * S, K, N, density=0.3, w_density=0.5)
    packed[:, 0] |= np.uint32((1 << T) - 1)
    plan = build_weight_plan(torch.from_numpy(w))
    pol, jpol = ((PACKED_DUAL_ADAPTIVE, J_PACKED_DUAL_ADAPTIVE) if adaptive
                 else (PACKED_DUAL, J_PACKED_DUAL))
    a = bridge.words_to_torch(packed).reshape(B, S, K)
    c, u = ops.dispatch_decode_window(a, plan, pol, T, n_out=N,
                                      fuse_lif=fuse)
    jc, ju = j_ops.dispatch_decode_window(
        jnp.asarray(packed.reshape(B, S, K)), _build_weight_plan_host(w),
        jpol, T, n_out=N, fuse_lif=fuse)
    if fuse:
        assert int((bridge.words_to_numpy(c) != np.asarray(jc)).sum()) == 0
    else:
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    for s in range(S):
        cs, us = ops.dispatch_decode_window(a[:, s:s + 1].contiguous(), plan,
                                            pol, T, n_out=N, fuse_lif=fuse)
        if fuse:
            assert torch.equal(cs[:, 0], c[:, s])
        else:
            assert torch.equal(cs[:, :, 0], c[:, :, s])
        assert torch.equal(us[:, 0], u[:, s])


@pytest.mark.parametrize("op", ["mean_square", "matmul"])
def test_row_blocks_give_each_row_one_value(op):
    """`layers.row_blocks`, the serving forward's rmsnorm mean and unembed:
    a row's result does not depend on how many rows share the call (one, a
    decode step, a verify window, more than one block), and is the plain
    op's value for that row (up to the plain op's own M-dependence)."""
    from repro_torch.models.layers import ROW_BLOCK, _mean_square, row_blocks

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * ROW_BLOCK + 3, 64, generator=g)
    args = (torch.randn(64, 96, generator=g),) if op == "matmul" else ()
    fn = torch.matmul if op == "matmul" else _mean_square
    full = row_blocks(fn, x, *args)
    assert full.shape[0] == x.shape[0]
    for n in (1, 4, 20, ROW_BLOCK, ROW_BLOCK + 1):
        assert torch.equal(row_blocks(fn, x[:n], *args), full[:n]), n
    torch.testing.assert_close(full, fn(x, *args), rtol=1e-5, atol=1e-5)


def test_row_invariant_rmsnorm_equals_plain():
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 50, 64, generator=g).to(torch.bfloat16)
    scale = torch.randn(64, generator=g) * 0.1
    assert torch.equal(rmsnorm(x, scale, row_invariant=True), rmsnorm(x, scale))


def test_decode_window_validation():
    plan = build_weight_plan(torch.ones((8, 128)))
    with pytest.raises(ValueError, match=r"packed \(B, S, K\) window"):
        ops.dispatch_decode_window(torch.zeros((4, 8), dtype=torch.int32),
                                   plan, PACKED_DUAL, 4)
    with pytest.raises(ValueError, match="packed-spike shaped"):
        ops.dispatch_decode_window(torch.zeros((1, 4, 8)),
                                   torch.ones((8, 8)), ExecutionPolicy(), 4)


# ---------------------------------------------------------------------------
# token-identity matrix: {sync, pipelined} x {dense, paged}
# ---------------------------------------------------------------------------

_LENS = (8, 12, 8, 8)
_GENS = (6, 5, 4, 7)
_ARRIVALS = (0, 0, 1, 2)


def _staggered(engine, prompts, gens, arrivals):
    reqs, i, step = [], 0, 0
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            reqs.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    return [np.asarray(engine.results[r.rid].generated, np.int32)
            for r in reqs]


def _run(models, policy, lens=_LENS, gens=_GENS, arrivals=_ARRIVALS, seed=3,
         **kw):
    tcfg, tm, tp = models[1]
    eng = Engine(tm, tp, max_len=48, max_slots=4, batch_align=2,
                 policy=policy, device="cpu", **kw)
    out = _staggered(eng, _prompts(tcfg.vocab, lens, seed), gens, arrivals)
    return out, eng.summary(), eng


@pytest.fixture(scope="module")
def reference_tokens(models):
    """The reference engine's tokens on the matrix schedule, its
    non-speculative and its speculative (float draft, k = 4) serve, which
    are equal; and the non-speculative serve's logit traces."""
    jcfg, jm, jp = models[0]
    out = {}
    for name, pol in (
            ("plain", JPolicy.for_arch(jcfg)),
            ("speculative", JPolicy.for_arch(
                jcfg, speculation=j_draft(_float_draft(jcfg, JPolicy), k=4)))):
        eng = JEngine(jm, jp, max_len=48, max_slots=4, batch_align=2,
                      policy=pol, capture_logits=name == "plain")
        out[name] = _staggered(eng, _prompts(jcfg.vocab, _LENS, 3), _GENS,
                               _ARRIVALS)
        if name == "plain":
            logits = eng.drain_logit_traces()
    for a, b in zip(out["plain"], out["speculative"]):
        np.testing.assert_array_equal(a, b)
    return out["plain"], logits


@pytest.fixture(scope="module")
def port_plain(models):
    return _run(models, ExecutionPolicy.for_arch(models[1][0]))[0]


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging_mode", ["dense", "paged"])
def test_speculative_token_identity_matrix(models, execution, paging_mode,
                                           port_plain, reference_tokens):
    tcfg = models[1][0]
    kw = {"speculation": draft(_float_draft(tcfg), k=4),
          "execution": execution}
    if paging_mode == "paged":
        kw["paging"] = paged(page_size=8)
    out, s, _ = _run(models, ExecutionPolicy.for_arch(tcfg, **kw))
    for plain, got in zip(port_plain, out):
        np.testing.assert_array_equal(got, plain)
    assert _hold_to_reference(out, *reference_tokens) <= 1
    # every proposal is adjudicated exactly once
    assert s["speculative_rounds"] > 0 and s["tokens_proposed"] > 0
    assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]
    assert s["acceptance_rate"] > 0
    assert s["draft_batches"] >= s["speculative_rounds"]
    assert "propose" in s["stage_s"]


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging_mode", ["dense", "paged"])
def test_speculative_token_identity_matrix_mesh(models, execution,
                                                paging_mode, port_plain,
                                                reference_tokens):
    """The matrix's ``mesh`` cells: target and float draft on one data=4 x
    model=2 mesh; the verified stream is the single-device plain serve's."""
    tcfg = models[1][0]
    mesh = make_serve_mesh("data=4,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(8)])
    kw = {"speculation": draft(_float_draft(tcfg), k=4),
          "execution": execution, "placement": Placement(mesh=mesh)}
    if paging_mode == "paged":
        kw["paging"] = paged(page_size=8)
    out, s, eng = _run(models, ExecutionPolicy.for_arch(tcfg, **kw))
    for plain, got in zip(port_plain, out):
        np.testing.assert_array_equal(got, plain)
    assert _hold_to_reference(out, *reference_tokens) <= 1
    assert s["speculative_rounds"] > 0 and s["tokens_proposed"] > 0
    assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]
    assert s["mesh"] == "data=4xmodel=2"


def test_draft_on_its_own_mesh_refused(models):
    """The draft inherits the target's placement: a draft policy with a
    mesh of its own is refused, as in the reference."""
    tcfg = models[1][0]
    mesh = make_serve_mesh("data=2,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(4)])
    d = ExecutionPolicy.for_arch(tcfg, spike_format="float",
                                 weight_sparsity="dense",
                                 placement=Placement(mesh=mesh))
    with pytest.raises(ValueError, match="inherited from the target"):
        ExecutionPolicy.for_arch(tcfg, speculation=draft(d, k=2))


def test_partial_acceptance_still_token_identical(models):
    """A harder-pruned packed draft (kernel 3 on its own plans) disagrees
    with the target on some proposals: the rewind path keeps every token."""
    tcfg = models[1][0]
    lens, gens, arrivals = (8, 8, 12, 8, 12, 8), (6, 6, 5, 4, 5, 8), \
        (0, 0, 0, 1, 2, 3)
    want, _, _ = _run(models, ExecutionPolicy.for_arch(tcfg), lens=lens,
                      gens=gens, arrivals=arrivals, seed=1)
    pol = ExecutionPolicy.for_arch(
        tcfg, speculation=draft(ExecutionPolicy.for_arch(tcfg), k=3,
                                draft_weight_density=0.2))
    out, s, eng = _run(models, pol, lens=lens, gens=gens, arrivals=arrivals,
                       seed=1)
    for a, b in zip(want, out):
        np.testing.assert_array_equal(b, a)
    assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]
    assert s["tokens_rejected"] > 0
    # the draft joins against its own, sparser plans
    d_mlp = eng.draft_params["layers"][0]["mlp"]
    t_mlp = eng.params["layers"][0]["mlp"]
    assert d_mlp["plan_in"] is not t_mlp["plan_in"]
    assert (int((d_mlp["plan_in"].payload != 0).sum())
            < int((t_mlp["plan_in"].payload != 0).sum()))


def test_adaptive_draft_carries_its_gate(models):
    """A draft with a lossy temporal axis runs its FFNs under that policy
    (kernel 4's gate on the card); the target's FFNs keep the full walk,
    and the tokens are the target's."""
    tcfg = models[1][0]
    d_pol = ExecutionPolicy.for_arch(tcfg, temporal=adaptive_t(2),
                                     exactness=approximate(0.5))
    want = _run(models, ExecutionPolicy.for_arch(tcfg))[0]
    out, s, eng = _run(models, ExecutionPolicy.for_arch(
        tcfg, speculation=draft(d_pol, k=3)))
    for a, b in zip(want, out):
        np.testing.assert_array_equal(b, a)
    assert eng.draft_params["layers"][0]["mlp"]["ffn_policy"] is d_pol
    assert "ffn_policy" not in eng.params["layers"][0]["mlp"]
    assert eng.draft_mode == "infer" and s["speculative_rounds"] > 0


# ---------------------------------------------------------------------------
# rewind exactness: the rollback is bitwise, not just length-correct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paging_mode", ["dense", "paged"])
def test_rewind_restores_exact_cache_locals(models, paging_mode):
    """A cohort that speculated (verify window + rewind) holds cache locals
    equal, bit for bit, to a cohort that never speculated at the same
    length, so the two still merge."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, (8, 8), seed=7)
    pg = {"paging": paged(page_size=8)} if paging_mode == "paged" else {}
    pol = ExecutionPolicy.for_arch(
        tcfg, speculation=draft(ExecutionPolicy.for_arch(tcfg), k=4,
                                draft_weight_density=0.2), **pg)
    eng = Engine(tm, tp, max_len=48, max_slots=2, policy=pol, device="cpu")
    for p in prompts:
        eng.submit(p, 12)
    eng.step()
    eng.step()
    cohort = eng.cohorts[0]
    ref_eng = Engine(tm, tp, max_len=48, max_slots=2, device="cpu",
                     policy=ExecutionPolicy.for_arch(tcfg, **pg))
    for p in prompts:
        ref_eng.submit(p, 12)
    ref_eng.step()
    ref = ref_eng.cohorts[0]
    while ref.length < cohort.length:
        ref_eng.step()
    assert cohort.length == ref.length
    assert eng.metrics.n_tokens_rejected > 0  # a round did roll back
    if paging_mode == "paged":
        got, want = cohort.cache.locals, ref.cache.locals
    else:
        got = {k: cohort.cache[k] for k in ("kv_pos", "pos")}
        want = {k: ref.cache[k] for k in ("kv_pos", "pos")}
        DenseCacheOps(tm.cache_axes()).concat([cohort.cache, ref.cache])
    assert got["pos"] == want["pos"] == cohort.length
    assert torch.equal(got["kv_pos"], want["kv_pos"])


def test_rewind_is_position_arithmetic(models):
    """`rewind_cache`: the host position goes back, kv_pos slots at or
    past it return to -1; k/v and smaller slots are untouched."""
    tcfg, tm, tp = models[1]
    eng = Engine(tm, tp, max_len=16, device="cpu", policy=ExecutionPolicy.for_arch(
        tcfg, speculation=draft(_float_draft(tcfg), k=2)))
    cache = tm.init_cache(1, 16, device="cpu")
    cache["pos"] = 7
    cache["kv_pos"][:7] = torch.arange(7, dtype=torch.int32)
    out = eng.rewind_cache(cache, 3)
    assert out["pos"] == 4 and out["k"] is cache["k"]
    assert out["kv_pos"].tolist() == [0, 1, 2, 3] + [-1] * 12
    assert eng.rewind_cache(cache, 0) is cache


# ---------------------------------------------------------------------------
# metrics window and generate_batch
# ---------------------------------------------------------------------------

def test_metrics_reset_covers_speculation_counters():
    m = EngineMetrics()
    m.n_speculative_rounds = 3
    m.n_draft_batches = 4
    m.n_draft_prefills = 2
    m.n_tokens_proposed = 12
    m.n_tokens_accepted = 9
    m.n_tokens_rejected = 3
    assert m.summary()["acceptance_rate"] == 0.75
    m.reset()
    s = m.summary()
    for key in ("speculative_rounds", "draft_batches", "draft_prefills",
                "tokens_proposed", "tokens_accepted", "tokens_rejected",
                "acceptance_rate"):
        assert s[key] == 0, key


def test_generate_batch_speculative_identity_and_counters(models):
    (jcfg, jm, jp), (tcfg, tm, tp) = models
    prompts = _prompts(tcfg.vocab, (12, 12, 12), seed=11)
    base = Engine(tm, tp, max_len=40, max_slots=4, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg))
    want = base.generate_batch(prompts, 8)
    jeng = JEngine(jm, jp, max_len=40, max_slots=4, capture_logits=True,
                   policy=JPolicy.for_arch(jcfg))
    jwant = jeng.generate_batch(prompts, 8)
    pol = ExecutionPolicy.for_arch(tcfg,
                                   speculation=draft(_float_draft(tcfg), k=4))
    eng = Engine(tm, tp, max_len=40, max_slots=4, policy=pol, device="cpu")
    assert eng.speculative and eng.scheduler.speculation_slack == 4
    got = eng.generate_batch(prompts, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert _hold_to_reference(got, jwant, jeng.drain_logit_traces()) == 0
    s = eng.summary()
    assert s["tokens_proposed"] == s["tokens_accepted"] + s["tokens_rejected"]
    # the float draft shares the target's weights: near-perfect acceptance,
    # and far fewer target decode dispatches
    assert s["acceptance_rate"] > 0.5
    assert s["decode_batches"] < base.summary()["decode_batches"]
    assert "speculation=draft(k=4" in s["policy"]


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_drain_discards_half_verified_speculative_progress(models, execution):
    """Preempting a speculative engine mid-serve hands off only verified
    tokens: every in-flight request's progress is a prefix of the
    non-speculative stream, and the successor's replay reproduces it
    (`Engine.resume` holds the handed-off progress against the replay), so
    every request ends equal to the non-speculative serve."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, (8, 12, 8, 8), seed=3)
    base = Engine(tm, tp, max_len=48, max_slots=4, batch_align=2,
                  device="cpu", policy=ExecutionPolicy.for_arch(tcfg))
    reference = base.generate_batch(prompts, 12)
    pol = ExecutionPolicy.for_arch(tcfg, execution=execution,
                                   speculation=draft(_float_draft(tcfg), k=4))
    eng = Engine(tm, tp, max_len=48, max_slots=4, batch_align=2,
                 device="cpu", policy=pol)
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.step()
    eng.step()
    assert eng.metrics.n_speculative_rounds > 0
    handoff = eng.drain(step_budget=0)
    inflight = [hr for hr in handoff.requests if hr.state == "inflight"]
    assert inflight, "expected live requests at preemption"
    assert any(hr.generated.size > 1 for hr in inflight)
    by_rid = {r.rid: i for i, r in enumerate(reqs)}
    for hr in inflight:
        want = reference[by_rid[hr.rid]]
        got = np.asarray(hr.generated, np.int32)
        # no half-verified overhang: the handoff carries a verified prefix
        np.testing.assert_array_equal(got, want[: len(got)])
    successor = Engine.resume(tm, tp, handoff, policy=pol, device="cpu")
    assert successor._resume_expect
    out = successor.run()
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], reference[by_rid[r.rid]])


def test_admission_reserves_speculation_slack(models):
    from repro_torch.serve import AdmissionError

    tcfg, tm, tp = models[1]
    eng = Engine(tm, tp, max_len=20, device="cpu", policy=ExecutionPolicy.for_arch(
        tcfg, speculation=draft(_float_draft(tcfg), k=4)))
    eng.submit(np.arange(8, dtype=np.int32), 8)  # 8 + 8 + 4 = 20: fits
    with pytest.raises(AdmissionError, match="speculation_slack=4"):
        eng.submit(np.arange(9, dtype=np.int32), 8)


def test_captured_logits_one_row_per_token(models):
    """With logits captured, a round lands one trace row per emitted token
    (token-major), as the step-at-a-time path does, and the rows equal the
    non-speculative serve's bit for bit (on the CPU the window's products
    give each row the values it gets alone)."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, (10, 10), seed=5)
    base = Engine(tm, tp, max_len=32, device="cpu", capture_logits=True,
                  policy=ExecutionPolicy.for_arch(tcfg))
    want = base.generate_batch(prompts, 7)
    eng = Engine(tm, tp, max_len=32, device="cpu", capture_logits=True,
                 policy=ExecutionPolicy.for_arch(
                     tcfg, speculation=draft(_float_draft(tcfg), k=3)))
    got = eng.generate_batch(prompts, 7)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    for tw, tg in zip(base.drain_logit_traces(), eng.drain_logit_traces()):
        assert len(tw) == len(tg) == 7
        for x, y in zip(tw, tg):
            np.testing.assert_array_equal(y, x)
