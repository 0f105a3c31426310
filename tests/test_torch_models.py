"""The port's main path as a whole against the JAX reference, on the CPU:
the spiking FFN, the llama3.2-1b smoke transformer with dual-sparse spiking
FFNs (``--smoke --spiking --weight-density 0.3``), and the serving engine.

Both packages get the reference's params (`repro_torch.bridge`).

Tolerances:
* against the reference run op by op (``jax.disable_jit``): logits within
  1e-5 — same ops in the same dtypes and order, only the order of f32
  accumulation inside a contraction differs;
* against the jitted reference (what the reference engine runs): logits
  within 0.25.  XLA fuses the bf16 residual adds into the next f32 norm
  without rounding them to bf16 (excess precision), which moves hidden
  states by a bf16 ulp and flips a few FFN spikes; the reference's own jit
  and op-by-op runs differ by the same ~0.1 at this size;
* greedy tokens: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.core import snn_layers as j_snn
from repro.models import layers as j_layers
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.core import snn_layers as t_snn
from repro_torch.launch.serve import build_config, generate
from repro_torch.models.layers import attach_spiking_ffn_plans
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    AdmissionError,
    DenseCacheOps,
    Engine,
    ExecutionPolicy,
    PackedSpikeCache,
    Scheduler,
)

# The suite runs in parallel worker processes that share the cores; these
# tests are small, so one intra-op thread keeps torch from oversubscribing
# them.
torch.set_num_threads(1)

B, P, GEN = 2, 8, 4


@pytest.fixture(scope="module")
def slice_models():
    """(reference cfg, model, params) and (port cfg, model, bridged params)
    of the smoke slice."""
    jcfg = dataclasses.replace(
        smoke_variant(get_config("llama3_2_1b")), spiking_ffn=True,
        spiking_weight_density=0.3,
    )
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                        weight_density=0.3)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


def _tokens(vocab, *shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _reference_forward(jm, jpp, toks, steps):
    """Reference prefill + ``steps`` greedy decodes in packed-infer mode;
    returns the list of logits and the fed decode tokens."""
    j_layers.set_spiking_ffn_mode("infer")
    try:
        cache = jm.init_cache(toks.shape[0], toks.shape[1] + steps + 1)
        logits, cache = jm.prefill(jpp, {"tokens": jnp.asarray(toks)}, cache)
        out, fed = [np.asarray(logits)], []
        for _ in range(steps):
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
            fed.append(np.array(tok))
            logits, cache = jm.decode(jpp, tok, cache)
            out.append(np.asarray(logits))
        return out, fed
    finally:
        j_layers.set_spiking_ffn_mode("train")


def _port_forward(tm, tpp, toks, fed):
    cache = tm.init_cache(toks.shape[0], toks.shape[1] + len(fed) + 1,
                          device="cpu")
    with torch.no_grad():
        logits, cache = tm.prefill(tpp, {"tokens": torch.from_numpy(toks).long()},
                                   cache, spiking_mode="infer")
        out = [logits.numpy()]
        for tok in fed:
            logits, cache = tm.decode(tpp, torch.from_numpy(tok).long(), cache,
                                      spiking_mode="infer")
            out.append(logits.numpy())
    return out


@pytest.fixture(scope="module")
def port_params(slice_models):
    _, (tcfg, tm, tp) = slice_models
    return tm.prepare(attach_spiking_ffn_plans(tp, tcfg))


def test_bridge_keeps_values_and_layout(slice_models):
    (jcfg, _, jp), (_, _, tp) = slice_models
    assert len(tp["layers"]) == jcfg.n_layers
    for i in range(jcfg.n_layers):
        np.testing.assert_array_equal(
            tp["layers"][i]["mlp"]["wu"].numpy(),
            np.asarray(jp["layers"]["mlp"]["wu"][i]))
    x = np.arange(-8, 8, dtype=np.float32).astype(ml_dtypes.bfloat16)
    t = bridge.to_torch(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


def test_port_init_shapes_and_prune_once(slice_models):
    """Port init draws its own numbers but has the reference's shapes and
    prune-once rule: FFN weights at the configured density, in whole
    zero blocks of the plan's grid."""
    (_, _, jp), (tcfg, tm, _) = slice_models
    tp = tm.init(0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: a.shape[1:], jp["layers"])
    for lp in tp["layers"]:
        got = {k: {n: tuple(w.shape) for n, w in v.items()} if isinstance(v, dict)
               else tuple(v.shape) for k, v in lp.items()}
        assert got == jax.tree.map(tuple, ref_shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
        for name in ("wu", "wd"):
            w = lp["mlp"][name]
            assert abs(float((w != 0).float().mean()) - 0.3) < 0.01
    assert tp["embed"].shape == jp["embed"].shape


def test_spiking_ffn_infer_with_plans_matches_reference():
    """`spiking_ffn_apply(mode='infer')` through attached f32 plans: hidden
    spike words bit-equal (0 flips) and outputs within 1e-5; train mode
    within 1e-5."""
    key = jax.random.PRNGKey(3)
    jparams = j_snn.init_spiking_ffn(key, 64, 256, weight_density=0.3,
                                     prune_block=(32, 64))
    cfg_j = j_snn.SpikingConfig(T=4, weight_density=0.3)
    jpl = j_snn.attach_join_plans(jparams, cfg_j)
    tparams = {k: bridge.to_torch(np.asarray(v)) for k, v in jparams.items()}
    cfg_t = t_snn.SpikingConfig(T=4, weight_density=0.3)
    tpl = t_snn.attach_join_plans(tparams, cfg_t)
    x = (np.random.default_rng(5).normal(size=(3, 7, 64)) * 2).astype(np.float32)
    want = np.asarray(j_snn.spiking_ffn_apply(jpl, jnp.asarray(x), cfg_j,
                                              mode="infer"))
    got = t_snn.spiking_ffn_apply(tpl, torch.from_numpy(x), cfg_t, mode="infer")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    from repro.core.lif import direct_encode
    from repro.core.packing import pack_spikes

    words = np.asarray(pack_spikes(direct_encode(jnp.asarray(x.reshape(-1, 64)), 4)))
    jh, _ = j_snn._ffn_dual_sparse(jnp.asarray(words), jpl["plan_in"],
                                   jpl["plan_out"], jpl["w_in"], jpl["w_out"], cfg_j)
    th, _ = t_snn._ffn_dual_sparse(bridge.words_to_torch(words), tpl["plan_in"],
                                   tpl["plan_out"], tpl["w_in"], tpl["w_out"], cfg_t)
    assert int((bridge.words_to_numpy(th) != np.asarray(jh)).sum()) == 0
    want = np.asarray(j_snn.spiking_ffn_apply(jparams, jnp.asarray(x), cfg_j))
    got = t_snn.spiking_ffn_apply(tparams, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_slice_logits_match_op_by_op_reference(slice_models, port_params):
    """Prefill, then from the prefilled cache a one-token decode and a
    two-position window: within 1e-5 of the reference run without jit."""
    (jcfg, jm, jp), (_, tm, _) = slice_models
    jpp = j_layers.attach_spiking_ffn_plans(jp, jcfg)
    toks = _tokens(jcfg.vocab, B, P, seed=1)
    j_layers.set_spiking_ffn_mode("infer")
    try:
        with jax.disable_jit():
            logits, cache = jm.prefill(jpp, {"tokens": jnp.asarray(toks)},
                                       jm.init_cache(B, P + 2))
            tok = np.array(jnp.argmax(logits[:, -1], axis=-1))[:, None]
            steps = [tok, np.concatenate([tok, tok], axis=1)]
            want = [logits] + [jm.decode(jpp, jnp.asarray(s), cache)[0]
                               for s in steps]
    finally:
        j_layers.set_spiking_ffn_mode("train")
    got = []
    with torch.no_grad():
        logits, cache = tm.prefill(port_params,
                                   {"tokens": torch.from_numpy(toks).long()},
                                   tm.init_cache(B, P + 2, device="cpu"),
                                   spiking_mode="infer")
        got.append(logits.numpy())
        for s in steps:
            fork = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
            got.append(tm.decode(port_params, torch.from_numpy(s).long(), fork,
                                 spiking_mode="infer")[0].numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=1e-5,
                                   atol=1e-5)


def test_slice_logits_near_jitted_reference(slice_models, port_params):
    """Prefill and three decode steps within 0.25 of the jitted reference
    (see the module docstring), with the same greedy tokens."""
    (jcfg, jm, jp), (_, tm, _) = slice_models
    jpp = j_layers.attach_spiking_ffn_plans(jp, jcfg)
    toks = _tokens(jcfg.vocab, B, P, seed=2)
    jm_jit = dataclasses.replace(jm, prefill=jax.jit(jm.prefill),
                                 decode=jax.jit(jm.decode))
    want, fed = _reference_forward(jm_jit, jpp, toks, 3)
    got = _port_forward(tm, port_params, toks, fed)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=0.25)
        np.testing.assert_array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))


def test_engine_tokens_match_reference_engine(slice_models):
    """B=2, P=8, gen=4 under PACKED_DUAL: the port engine emits the
    reference engine's greedy tokens."""
    (jcfg, jm, jp), (tcfg, tm, tp) = slice_models
    prompts = list(_tokens(jcfg.vocab, B, P, seed=3))
    want = JEngine(jm, jp, max_len=P + GEN, max_slots=B,
                   policy=JPolicy.for_arch(jcfg)).generate_batch(prompts, GEN)
    engine = Engine(tm, tp, max_len=P + GEN, max_slots=B,
                    policy=ExecutionPolicy.for_arch(tcfg), device="cpu")
    got = engine.generate_batch(prompts, GEN)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    s = engine.summary()
    assert s["dual_sparse"] is True and s["total_tokens"] == B * GEN


def test_engine_matches_own_generate_loop(slice_models):
    _, (tcfg, tm, tp) = slice_models
    prompts = _tokens(tcfg.vocab, 3, P, seed=4)
    engine = Engine(tm, tp, max_len=P + GEN, max_slots=3,
                    policy=ExecutionPolicy.for_arch(tcfg), device="cpu")
    got = engine.generate_batch(list(prompts), GEN)
    want = generate(tm, engine.params, torch.from_numpy(prompts).long(),
                    tm.init_cache(3, P + GEN, device="cpu"), GEN,
                    spiking_mode="infer")
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i].numpy())
    assert engine.summary()["mean_decode_batch"] == 3


def test_engine_continuous_batching_matches_isolated_runs(slice_models):
    """Staggered arrivals, mixed prompt lengths, few slots, batch padding
    and cohort merges: every request's tokens equal its solo run."""
    _, (tcfg, tm, tp) = slice_models
    max_len = 24
    lens, gens, arrivals = [8, 8, 12, 8, 12], [5, 4, 5, 3, 4], [0, 0, 0, 1, 2]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    engine = Engine(tm, tp, max_len=max_len, max_slots=3, batch_align=2,
                    policy=ExecutionPolicy.for_arch(tcfg), device="cpu")
    refs = [generate(tm, engine.params, torch.from_numpy(p).long()[None],
                     tm.init_cache(1, max_len, device="cpu"), g,
                     spiking_mode="infer")[0].numpy()
            for p, g in zip(prompts, gens)]
    tickets, i, step = [], 0, 0
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            tickets.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    for ref_tokens, t in zip(refs, tickets):
        np.testing.assert_array_equal(engine.results[t.rid].generated, ref_tokens)
    s = engine.summary()
    assert s["n_requests"] == len(prompts)
    assert s["padded_rows"] >= 1 and s["max_queue_depth"] >= 1


def test_scheduler_decisions_match_reference():
    """Same submissions and releases -> the same prefill groups."""
    lens = [8, 8, 12, 8, 12, 16, 8]
    ref = JScheduler(max_slots=3, max_queue=16, max_len=64)
    port = Scheduler(max_slots=3, max_queue=16, max_len=64)
    for n in lens:
        ref.submit(np.zeros(n, np.int32), 4)
        port.submit(np.zeros(n, np.int32), 4)
    for release in (0, 2, 1, 3):
        ref.release(release)
        port.release(release)
        want = [[r.rid for r in g] for g in ref.schedule()]
        assert [[r.rid for r in g] for g in port.schedule()] == want
    with pytest.raises(AdmissionError):
        port.submit(np.zeros(70, np.int32), 4)
    with pytest.raises(AdmissionError):
        port.submit(np.zeros(0, np.int32), 4)
    assert port.n_rejected == 2


def test_dense_cache_ops_roundtrip(slice_models):
    _, (tcfg, tm, _) = slice_models
    ops = DenseCacheOps(tm.cache_axes())
    a, b = (tm.init_cache(n, 8, device="cpu") for n in (2, 3))
    a["k"].normal_()
    b["k"].normal_()
    merged = ops.concat([a, b])
    assert merged["k"].shape[1] == merged["v"].shape[1] == 5
    back = ops.take(merged, [0, 1])
    assert torch.equal(back["k"], a["k"]) and back["pos"] == a["pos"]
    b["pos"] = 3
    with pytest.raises(ValueError, match="position-like"):
        ops.concat([a, b])


def test_packed_spike_cache_matches_reference_stats():
    from repro.serve import PackedSpikeCache as JCache

    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint64).astype(np.uint32)
    words[1, ::2] = 0
    ref, port = JCache(4, 64), PackedSpikeCache(4, 64, device="cpu")
    ref.append(words)
    port.append(torch.from_numpy(words.view(np.int32)))
    assert port.spike_sparsity() == ref.spike_sparsity()
    port.take([2, 0])
    np.testing.assert_array_equal(port.words.numpy().view(np.uint32),
                                  words[[2, 0]])


def test_engine_eos_matches_reference_engine(slice_models):
    """A request whose greedy stream hits ``eos_id`` finishes early, in
    both engines alike."""
    (jcfg, jm, jp), (tcfg, tm, tp) = slice_models
    prompts = list(_tokens(jcfg.vocab, B, P, seed=3))
    plain = Engine(tm, tp, max_len=P + GEN, max_slots=B, device="cpu",
                   policy=ExecutionPolicy.for_arch(tcfg)).generate_batch(prompts, GEN)
    eos = int(plain[0][1])
    want = JEngine(jm, jp, max_len=P + GEN, max_slots=B, eos_id=eos,
                   policy=JPolicy.for_arch(jcfg)).generate_batch(prompts, GEN)
    engine = Engine(tm, tp, max_len=P + GEN, max_slots=B, eos_id=eos,
                    policy=ExecutionPolicy.for_arch(tcfg), device="cpu")
    got = engine.generate_batch(prompts, GEN)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert len(got[0]) <= 2 and got[0][-1] == eos
    assert engine.results[0].finish_reason == "eos"


def test_attention_query_chunks_match_reference():
    """Queries in chunks of ``attn_chunk`` (64 queries, chunk 32) against
    the reference's chunked attention over a cache with empty slots: equal
    up to one bf16 rounding of the output (2**-7 relative)."""
    from repro.models.layers import multihead_attention as j_mha
    from repro_torch.models.layers import multihead_attention as t_mha

    cfg = smoke_variant(get_config("llama3_2_1b"))
    assert cfg.attn_chunk == 32
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=s).astype(ml_dtypes.bfloat16)
               for s in ((2, 64, 4, 16), (2, 72, 2, 16), (2, 72, 2, 16)))
    kv_pos = np.arange(72, dtype=np.int32)
    kv_pos[68:] = -1
    with jax.disable_jit():
        want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                     q_offset=4, kv_positions=jnp.asarray(kv_pos))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=False,
                        weight_density=1.0)
    got = t_mha(bridge.to_torch(q), bridge.to_torch(k), bridge.to_torch(v), tcfg,
                q_offset=4, kv_positions=torch.from_numpy(kv_pos))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2**-7, atol=2**-7)


def test_policy_refuses_unported_axes_and_bad_combinations(slice_models):
    """Pipelined execution constructs (ported); later-slice axes raise
    NotImplementedError pointing at the queue; arch-dependent misuse raises
    ValueError, as in the reference."""
    from repro_torch.serve import approximate

    _, (tcfg, _, _) = slice_models
    pol = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse",
                          execution="pipelined")
    assert pol.execution == "pipelined" and pol.token_identical
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        # approximate without lossy temporal skipping needs a model axis
        ExecutionPolicy(spike_format="packed", exactness=approximate(0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExecutionPolicy.for_arch(tcfg, exactness=approximate(0.1))
    with pytest.raises(ValueError, match="packed"):
        ExecutionPolicy(weight_sparsity="dual_sparse")
    dense = dataclasses.replace(tcfg, spiking_weight_density=1.0)
    with pytest.raises(ValueError, match="unpruned"):
        ExecutionPolicy.for_arch(dense, weight_sparsity="dual_sparse")
    assert ExecutionPolicy.for_arch(tcfg) == ExecutionPolicy(
        spike_format="packed", weight_sparsity="dual_sparse")
