"""The MoE family in the port (ROADMAP item 10d): phi3.5-moe (16 experts,
causal attention) and mixtral-8x22b (8 experts, sliding-window attention
over a ring cache of ``window`` slots), at smoke size on the CPU (4 experts
top-2, window 16), against the JAX reference.

Both packages get the reference's params (`repro_torch.bridge`).  Held, and
why each bound:
* `moe_apply` against the reference run op by op: outputs and the
  load-balancing term within 1e-5 (the routing is f32, the dispatch and
  combine move and scale bf16 values the same way, and the expert products
  are one bf16 ``torch.bmm`` each, the call the card makes too; torch's
  CPU bf16 ``bmm`` can round an isolated output one bf16 ulp apart from
  the reference's dot at larger shapes, but at none of these inputs), and the
  expert ids, capacity positions and kept mask equal exactly, also where
  probabilities tie (the lower expert index first, as ``jax.lax.top_k``
  returns it) and in a decode-shaped call of 4 rows at capacity 1, where
  (token, k) pairs are dropped;
* the sliding-window and bidirectional masks equal the reference's, and a
  ring write lands in the slot ``dynamic_update_slice`` writes (its start
  clamped so the rows fit); one layer's attention over the ring, across a
  wrap, within 1e-5 and the same cache;
* prefill and teacher-forced decodes (phi3.5-moe; mixtral with a prompt of
  two windows, which takes the temporary full-length cache, and with a
  prompt inside the window, whose decodes wrap the ring): logits within
  1e-5 of the reference op by op with the same greedy tokens; against the
  jitted reference within 0.25 or the reference's own op-by-op vs jitted
  distance where larger, and the same greedy tokens but at a near tie (the
  rule of `tests/test_torch_archs.py`);
* loss with the load-balancing term, and gradients: the bounds of
  `tests/test_torch_train.py` (loss 1e-4 / 1e-3 relative of the op-by-op /
  jitted reference, gradients 1e-2 / 5e-2 of the norm), or the reference's
  own jitted vs op-by-op gradient distance where larger;
* `prepare` keeps the router f32, casts the experts, and changes no logit;
* serving: the float cells of `tests/test_arch_parity_matrix.py` (MoE
  prompts of distinct lengths; sync and pipelined): tokens equal the port's
  own solo loop and the reference's solo loop (its jitted run's, or where a
  request differs from that, its run op by op); the reference's
  ``test_pipelined_moe_clamps_window_and_keeps_identity``; paged == dense
  bit for bit through a ring wrap; speculation refused with the reference
  engine's message; the reference's serve command (``--batch-align 4``
  forced to 1: ``padded_rows`` 0); a few adafactor steps of phi3.5-moe
  lower the loss (the reference's
  ``test_train_integration.py::test_adafactor_arch_trains``).
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.launch.serve import generate as j_generate
from repro.models import layers as j_layers
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import draft as j_draft
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticLMData, batch_to_torch
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_transformer
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim import get_optimizer
from repro_torch.optim.schedules import constant
from repro_torch.serve import Engine, ExecutionPolicy, paged
from repro_torch.serve import draft as t_draft
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ("phi3_5_moe", "mixtral_8x22b")
TOL = 1e-5
LOGIT_TOL = 0.25
SCENARIOS = ("batch1", "staggered")
EXECUTIONS = ("sync", "pipelined")

_MODELS: dict = {}
_REF: dict = {}


def _models(arch: str, **over):
    """((reference cfg, model, params), (port cfg, model, bridged params))
    of one arch's smoke variant."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), **over)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
        tm = t_build(tcfg)
        tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
        _MODELS[key] = (jcfg, jm, jp), (tcfg, tm, tp)
    return _MODELS[key]


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


def _bf16(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(ml_dtypes.bfloat16)


# ---------------------------------------------------------------------------
# moe_apply and its routing
# ---------------------------------------------------------------------------

def _ref_route(router, xt, cfg):
    """The reference's routing (`repro.models.layers.moe_apply`, its lines
    from the capacity to the kept mask), run op by op: (expert ids, capacity
    positions, kept mask, capacity)."""
    with jax.disable_jit():
        T = xt.shape[0]
        E, K = cfg.n_experts, cfg.top_k
        C = max(1, int(T * K * cfg.capacity_factor / E))
        logits = (jnp.asarray(xt).astype(jnp.float32) @ jnp.asarray(router)
                  ).astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, eidx = jax.lax.top_k(probs, K)
        onehot = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
        flat = onehot.reshape(T * K, E)
        pos_flat = jnp.cumsum(flat, axis=0) - flat
        pos = jnp.sum(pos_flat.reshape(T, K, E) * onehot, axis=-1)
        return np.asarray(eidx), np.asarray(pos), np.asarray(pos < C), C


def _moe_params(jcfg, tie: str, seed: int = 0):
    """One layer's MoE params of the reference's `moe_init` (numpy), with
    router columns tied: ``pair`` sets expert 1's column to expert 0's,
    ``all`` sets every column to expert 0's."""
    p = jax.tree.map(np.asarray, j_layers.moe_init(jax.random.PRNGKey(seed), jcfg))
    router = p["router"].copy()
    if tie == "pair":
        router[:, 1] = router[:, 0]
    elif tie == "all":
        router[:] = router[:, :1]
    return dict(p, router=router)


MOE_CASES = {
    # (experts, B, S, router tie): a prefill-shaped call; a decode of 4
    # rows over 16 experts (phi3.5-moe's count), capacity 1, with drops;
    # tied probabilities, pairwise and across every expert (all tokens on
    # experts 0 and 1, most pairs dropped)
    "prefill": (4, 2, 16, None),
    "decode_c1": (16, 4, 1, None),
    "tie_pair": (4, 2, 8, "pair"),
    "tie_all": (4, 2, 8, "all"),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, case):
    """Outputs and the load-balancing term within 1e-5 of the reference op
    by op; expert ids, capacity positions and the kept mask equal."""
    E, B, S, tie = MOE_CASES[case]
    jcfg = dataclasses.replace(j_smoke(j_get_config(arch)), n_experts=E)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), n_experts=E)
    p = _moe_params(jcfg, tie, seed=len(case))
    x = _bf16(np.random.default_rng(len(case) + E), (B, S, jcfg.d_model))
    with jax.disable_jit():
        want, want_aux = j_layers.moe_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    tp = {k: bridge.to_torch(v) for k, v in p.items()}
    got, aux = t_layers.moe_apply(tp, bridge.to_torch(x), tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL, atol=TOL)
    xt = x.reshape(B * S, -1)
    eidx, pos, keep, C = _ref_route(p["router"], xt, jcfg)
    probs, _, t_eidx, t_pos, t_keep, t_C = t_layers.moe_route(
        tp["router"], bridge.to_torch(xt), tcfg)
    assert t_C == C
    np.testing.assert_array_equal(t_eidx.numpy(), eidx)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if case == "decode_c1":
        assert C == 1 and not keep.all()        # capacity drops pairs
    if tie:
        assert torch.equal(probs[:, 0], probs[:, 1])
        assert (t_eidx[:, 0] < t_eidx[:, 1]).any()
    if tie == "all":
        assert (t_eidx.numpy() == [0, 1]).all() and not keep.all()


def test_moe_init_shapes_and_order():
    """`moe_init`: the f32 router (D, E), then wu, wd, wg (E, ., .) in the
    reference's order and fan-ins (a non-gated activation draws no wg)."""
    _, (tcfg, _, _) = _models("mixtral_8x22b")
    g = torch.Generator().manual_seed(0)
    p = t_layers.moe_init(g, tcfg)
    D, F, E = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    assert list(p) == ["router", "wu", "wd", "wg"]
    assert p["router"].dtype == torch.float32 and p["router"].shape == (D, E)
    assert p["wu"].shape == p["wg"].shape == (E, D, F)
    assert p["wd"].shape == (E, F, D)
    for name, fan_in in (("wu", D), ("wd", F), ("wg", D)):
        assert abs(float(p[name].std()) * fan_in ** 0.5 - 1) < 0.05, name
    gelu = dataclasses.replace(tcfg, act="gelu")
    assert list(t_layers.moe_init(torch.Generator().manual_seed(0), gelu)) == [
        "router", "wu", "wd"]


# ---------------------------------------------------------------------------
# the sliding window and the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", t_layers.ATTN_MODES)
def test_attention_masks_match_reference(mode):
    """Causal, sliding-window (window 4) and bidirectional masks over a
    ring's stored positions (empty slots -1) equal the reference's."""
    iq = np.arange(9, 13)
    jk = np.asarray([8, 9, 10, 11, 12, 5, 6, 7, -1, -1], np.int32)
    want = np.asarray(j_layers._attn_mask(jnp.asarray(iq), jnp.asarray(jk),
                                          mode, 4))
    got = t_layers._attn_mask(torch.from_numpy(iq), torch.from_numpy(jk),
                              mode, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        t_layers._attn_mask(torch.from_numpy(iq), torch.from_numpy(jk), "x", 4)


@pytest.mark.parametrize("S", [1, 3, 16])
def test_ring_slot_is_dynamic_update_slice_start(S):
    """A ring write of S positions from ``pos`` lands where the reference's
    ``dynamic_update_slice`` writes it: ``pos % s_cache``, clamped so the
    rows fit; a full-length cache refuses positions past its end."""
    s_cache = 16
    for pos in range(0, 40):
        buf = jax.lax.dynamic_update_slice(jnp.zeros(s_cache, jnp.int32),
                                           jnp.ones(S, jnp.int32),
                                           (pos % s_cache,))
        want = int(np.argmax(np.asarray(buf)))
        assert t_layers.cache_slot(pos, S, s_cache, "swa") == want, pos
        if pos + S <= s_cache:
            assert t_layers.cache_slot(pos, S, s_cache, "causal") == pos
        else:
            with pytest.raises(ValueError, match="cannot take"):
                t_layers.cache_slot(pos, S, s_cache, "causal")
    with pytest.raises(ValueError, match="cannot take"):
        t_layers.cache_slot(0, s_cache + 1, s_cache, "swa")


@pytest.mark.parametrize("pos,S", [(14, 3), (17, 1), (30, 2)])
def test_ring_attention_layer_matches_reference(pos, S):
    """One mixtral layer's attention with a ring cache of 16 slots holding
    positions pos-16 .. pos-1, writing S new ones (wrapping, or clamped):
    output within 1e-5 of the reference op by op, the same cache."""
    (jcfg, _, jp), (tcfg, _, tp) = _models("mixtral_8x22b")
    rng = np.random.default_rng(pos)
    B, W, KV, dh = 2, tcfg.window, tcfg.n_kv, tcfg.head_dim
    k, v = _bf16(rng, (B, W, KV, dh)), _bf16(rng, (B, W, KV, dh))
    kv_pos = np.full(W, -1, np.int32)
    for p in range(max(0, pos - W), pos):
        kv_pos[p % W] = p
    x = _bf16(rng, (B, S, tcfg.d_model))
    positions = np.broadcast_to(pos + np.arange(S), (B, S))
    lp = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    with jax.disable_jit():
        want, wc = j_layers.attn_apply(
            lp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
            cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                   "kv_pos": jnp.asarray(kv_pos), "pos": jnp.asarray(pos)})
    slot = t_layers.cache_slot(pos, S, W, "swa")
    t_pos = torch.from_numpy(kv_pos.copy())
    t_pos[slot:slot + S] = pos + torch.arange(S, dtype=torch.int32)
    cache = {"k": bridge.to_torch(k), "v": bridge.to_torch(v), "kv_pos": t_pos,
             "pos": pos}
    got = t_layers.attn_apply(tp["layers"][0]["attn"], bridge.to_torch(x), tcfg,
                              positions=torch.from_numpy(positions.copy()),
                              cache=cache)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(wc["kv_pos"]))
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(cache[name]), _np(wc[name]))


def test_swa_init_cache_is_a_ring_unless_full():
    """A sliding-window cache holds min(max_len, window) slots, or max_len
    with ``full=True``; a causal arch's holds max_len either way."""
    (_, jm, _), (tcfg, tm, _) = _models("mixtral_8x22b")
    for max_len in (8, 40):
        want = jm.init_cache(2, max_len)
        got = tm.init_cache(2, max_len, device="cpu")
        assert tuple(got["k"].shape) == tuple(want["k"].shape)
        assert got["kv_pos"].shape[0] == min(max_len, tcfg.window)
        assert tm.init_cache(2, max_len, device="cpu", full=True)["k"].shape[2] == max_len
    _, (_, pm, _) = _models("phi3_5_moe")
    assert pm.init_cache(2, 40, device="cpu")["k"].shape[2] == 40


# ---------------------------------------------------------------------------
# the model: prefill and decodes, loss and gradients
# ---------------------------------------------------------------------------

def _reference_logits(jm, jp, toks, max_len, fed=None, jit=False, n_dec=0):
    """The reference's prefill logits and one decode's per fed token (the
    greedy tokens of this run when ``fed`` is None, ``n_dec`` of them)."""
    prefill, decode = jm.prefill, jm.decode
    if jit:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    with contextlib.nullcontext() if jit else jax.disable_jit():
        cache = jm.init_cache(toks.shape[0], max_len)
        logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)}, cache)
        out, greedy = [np.asarray(logits, np.float32)], []
        for i in range(n_dec if fed is None else len(fed)):
            tok = (np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
                   if fed is None else fed[i])
            greedy.append(tok)
            logits, cache = decode(jp, jnp.asarray(tok), cache)
            out.append(np.asarray(logits, np.float32))
    return out, greedy


def _port_logits(tm, tpp, toks, max_len, fed):
    with torch.no_grad():
        cache = tm.init_cache(toks.shape[0], max_len, device="cpu")
        logits, cache = tm.prefill(tpp, {"tokens": torch.from_numpy(toks).long()},
                                   cache)
        out = [logits.numpy()]
        for tok in fed:
            logits, cache = tm.decode(tpp, torch.from_numpy(tok).long(), cache)
            out.append(logits.numpy())
    return out, cache


def _hold_logits(got, eager, jitted):
    """Op by op within 1e-5 and the same greedy tokens; jitted within 0.25
    or the reference's own distance, greedy tokens equal but at near ties."""
    for g, e in zip(got, eager):
        assert g.shape == e.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(g[:, -1].argmax(-1), e[:, -1].argmax(-1))
    for g, w, e in zip(got, jitted, eager):
        bound = max(LOGIT_TOL, float(np.abs(e - w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=bound + TOL)
        top2 = np.sort(w[:, -1], axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= 2 * bound
        assert ((g[:, -1].argmax(-1) == w[:, -1].argmax(-1)) | tie).all()


# (arch, prompt length, decodes): mixtral's window is 16 at smoke size, so
# its 32-token prompt takes the temporary full-length cache and its
# 12-token one wraps the ring at the 5th decode
LOGIT_CASES = [("phi3_5_moe", 12, 6), ("mixtral_8x22b", 32, 6),
               ("mixtral_8x22b", 12, 8)]


@pytest.mark.parametrize("arch,S,n_dec", LOGIT_CASES)
def test_prefill_and_decodes_match_reference(arch, S, n_dec):
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, size=(2, S)
                                             ).astype(np.int32)
    max_len = S + n_dec + 4
    eager, fed = _reference_logits(jm, jp, toks, max_len, n_dec=n_dec)
    got, cache = _port_logits(tm, tm.prepare(tp), toks, max_len, fed)
    jitted, _ = _reference_logits(jm, jp, toks, max_len, fed=fed, jit=True)
    _hold_logits(got, eager, jitted)
    ring = arch == "mixtral_8x22b"
    assert cache["k"].shape[2] == (tcfg.window if ring else max_len)
    assert cache["pos"] == S + n_dec
    held = sorted(int(p) for p in cache["kv_pos"] if p >= 0)
    assert held == list(range(max(0, S + n_dec - cache["k"].shape[2]), S + n_dec))


def test_swa_prefill_needs_window_to_divide_prompt():
    """The reference asserts window | S for a prompt longer than the ring;
    the port refuses with the reason."""
    _, (tcfg, tm, tp) = _models("mixtral_8x22b")
    toks = torch.zeros((1, tcfg.window + 4), dtype=torch.long)
    with pytest.raises(ValueError, match="window \\| seq_len"):
        tm.prefill(tm.prepare(tp), {"tokens": toks},
                   tm.init_cache(1, 64, device="cpu"))


def _rel_norm(got, want) -> float:
    num = sum(float(np.sum((np.float64(g) - np.float64(w)) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.float64(w) ** 2)) for w in want)
    return (num / den) ** 0.5


def _ref_grads(tree) -> list:
    """Reference grads (stacked layers) in the port's leaf order."""
    port = bridge.params_from_reference(jax.tree.map(np.asarray, tree))
    return [_np(g) for g in tree_leaves(port)]


def _loss_and_grads_hold(jm, jp, tm, tp, batch):
    """Loss within 1e-4 / 1e-3 relative of the reference op by op / jitted;
    gradients within 1e-2 / 5e-2 relative norm, or the reference's own
    jitted vs op-by-op distance where larger.  Returns the port's loss."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ps = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tm.loss(ps, batch_to_torch(batch, "cpu"))
    grads = [g.float().numpy() for g in torch.autograd.grad(loss, tree_leaves(ps))]
    loss = float(loss.detach())
    with jax.disable_jit():
        want_loss, want_g = jax.value_and_grad(jm.loss)(jp, jb)
    jit_loss, jit_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(loss, float(jit_loss), rtol=1e-3)
    assert all(np.isfinite(g).all() for g in grads)
    eager, jitted = _ref_grads(want_g), _ref_grads(jit_g)
    own = _rel_norm(jitted, eager)
    assert _rel_norm(grads, eager) <= max(1e-2, own)
    assert _rel_norm(grads, jitted) <= max(5e-2, own)
    return loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The training forward at S 32 (mixtral's window of 16 masks), with
    the load-balancing term 0.01 aux / n_layers, and its gradients (the
    router's included) against `jax.value_and_grad`."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    batch = SyntheticLMData(tcfg, seq_len=32, global_batch=2).batch(0)
    loss = _loss_and_grads_hold(jm, jp, tm, tp, batch)
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        x, aux = t_transformer.forward(tp, tcfg, tb)
        ce = float(t_transformer.ce_loss(tp, tcfg, x, tb["labels"]))
    assert float(aux) > 0
    np.testing.assert_allclose(loss, ce + 0.01 * float(aux) / tcfg.n_layers,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_keeps_router_f32_and_casts_experts(arch):
    """`prepare` casts the 3-D expert weights and the attention matrices to
    the compute dtype, keeps the router f32, and changes no logit."""
    _, (tcfg, tm, tp) = _models(arch)
    pp = tm.prepare(tp)
    moe = pp["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert torch.equal(moe["router"], tp["layers"][0]["moe"]["router"])
    assert all(moe[k].dtype == torch.bfloat16 for k in ("wu", "wg", "wd"))
    assert pp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, size=(2, 8)
                                             ).astype(np.int32)
    fed = [toks[:, :1], toks[:, 1:2]]
    for a, b in zip(_port_logits(tm, tp, toks, 16, fed)[0],
                    _port_logits(tm, pp, toks, 16, fed)[0]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _scenario(scenario: str):
    """(prompt lens, gen lens, arrival steps): the reference matrix's, MoE
    prompts of distinct lengths (capacity routing couples a cohort's rows)."""
    if scenario == "batch1":
        return [10], [4], [0]
    return [8, 10, 12], [4, 5, 4], [0, 1, 1]


def _prompts(vocab, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, vocab, size=(n,)), np.int32) for n in lens]


def _staggered(engine, prompts, gens, arrivals):
    tickets, i, step = [], 0, 0
    while not (engine.idle and i == len(prompts)):
        while i < len(prompts) and arrivals[i] <= step:
            tickets.append(engine.submit(prompts[i], gens[i]))
            i += 1
        engine.step()
        step += 1
    return [np.asarray(engine.results[t.rid].generated, np.int32)
            for t in tickets]


def _reference_solo(arch, prompts, gens, max_len, jit=True):
    """The reference matrix's oracle: `repro.launch.serve.generate` per
    request, alone, jitted or op by op."""
    key = (arch, tuple(p.tobytes() for p in prompts), tuple(gens), max_len, jit)
    if key not in _REF:
        (_, jm, jp), _ = _models(arch)
        with contextlib.nullcontext() if jit else jax.disable_jit():
            _REF[key] = [np.asarray(j_generate(jm, jp, jnp.asarray(p)[None],
                                               jm.init_cache(1, max_len), g))[0]
                         for p, g in zip(prompts, gens)]
    return _REF[key]


@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_parity_matrix_float_cells(arch, scenario, execution):
    """The MoE float cells of the reference's matrix: the engine's tokens
    equal the port's solo greedy loop per request and the reference's solo
    loop; no cohort merges and no batch is padded."""
    _, (tcfg, tm, tp) = _models(arch)
    lens, gens, arrivals = _scenario(scenario)
    prompts = _prompts(tcfg.vocab, lens)
    max_len = max(n + g for n, g in zip(lens, gens)) + 2
    policy = ExecutionPolicy.for_arch(tcfg, execution=execution)
    engine = Engine(tm, tp, max_len=max_len, max_slots=2, policy=policy,
                    batch_align=4, device="cpu")
    assert not engine.merge_cohorts and engine.batch_align == 1
    got = _staggered(engine, prompts, gens, arrivals)
    for p, g, out in zip(prompts, gens, got):
        solo = generate(tm, engine.params, torch.from_numpy(p).long()[None],
                        tm.init_cache(1, max_len, device="cpu"), g)[0].numpy()
        np.testing.assert_array_equal(out, solo)
    want = _reference_solo(arch, prompts, gens, max_len)
    if any(not np.array_equal(a, b) for a, b in zip(got, want)):
        want = _reference_solo(arch, prompts, gens, max_len, jit=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    s = engine.summary()
    assert s["n_requests"] == len(prompts) and s["padded_rows"] == 0
    assert engine.metrics.n_merges == 0


def test_pipelined_moe_clamps_window_and_keeps_identity():
    """The reference's test: same-length prompts (one batched MoE cohort)
    with uneven budgets; the pipelined executor asked for depth 4 runs at
    1, and its tokens equal sync's."""
    _, (tcfg, tm, tp) = _models("mixtral_8x22b")
    prompts, gens = _prompts(tcfg.vocab, [10, 10], seed=14), [2, 5]
    engine = Engine(tm, tp, max_len=24, max_slots=2, device="cpu",
                    policy=ExecutionPolicy.for_arch(tcfg, execution="pipelined"),
                    pipeline_depth=4)
    assert engine.executor.depth == 1
    sync = Engine(tm, tp, max_len=24, max_slots=2, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg))
    want = [sync.submit(p, g) for p, g in zip(prompts, gens)]
    sync.run()
    got = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    engine.run()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(sync.results[a.rid].generated,
                                      engine.results[b.rid].generated)


@pytest.mark.parametrize("execution", EXECUTIONS)
def test_mixtral_paged_equals_dense_through_the_ring(execution):
    """mixtral's ring (16 slots) in pages of 8: a prompt of two windows
    (the temporary full-length prefill) and one of 12 that wraps, 8 new
    tokens each, staggered; tokens and captured logits equal the dense
    sync serve's bit for bit."""
    _, (tcfg, tm, tp) = _models("mixtral_8x22b")
    prompts, gens, arrivals = _prompts(tcfg.vocab, [32, 12], seed=5), [8, 8], [0, 1]

    def serve(execution, paging):
        eng = Engine(tm, tp, max_len=40, max_slots=2, capture_logits=True,
                     device="cpu", policy=ExecutionPolicy.for_arch(
                         tcfg, execution=execution,
                         paging=paged(8) if paging else None))
        got = _staggered(eng, prompts, gens, arrivals)
        return got, eng.drain_logit_traces()

    want, want_logits = serve("sync", False)
    got, logits = serve(execution, True)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want_logits, logits):
        assert np.array_equal(np.stack(a), np.stack(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_refused_with_reference_message(arch):
    """Capacity routing couples a verify window's rows: the engine refuses
    ``speculation=draft`` with the reference engine's message."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    with pytest.raises(ValueError) as want:
        JEngine(jm, jp, max_len=16, policy=JPolicy.for_arch(
            jcfg, speculation=j_draft(JPolicy.for_arch(jcfg), 2)))
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, max_len=16, device="cpu", policy=ExecutionPolicy.for_arch(
            tcfg, speculation=t_draft(ExecutionPolicy.for_arch(tcfg), 2)))
    assert str(got.value) == str(want.value)
    assert "experts" in str(got.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs(arch, capsys):
    """The reference's MoE probe on the port's CLI on the CPU: 4 requests,
    2 slots, ``--batch-align 4`` forced to 1 (no padded rows)."""
    assert serve_main(["--arch", arch, "--smoke", "--batch", "4", "--gen", "4",
                       "--prompt-len", "8", "--max-slots", "2",
                       "--batch-align", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests / 16 tokens" in out
    summary = json.loads(out.split("summary: ", 1)[1].splitlines()[0])
    assert summary["padded_rows"] == 0


def test_adafactor_arch_trains():
    """The reference's `test_adafactor_arch_trains`: phi3.5-moe (2 layers,
    d_model 64, d_ff 128), its adafactor at a constant 1e-2, 20 steps of
    4 x 32 tokens lower the loss."""
    cfg = dataclasses.replace(smoke_variant(get_config("phi3_5_moe")),
                              n_layers=2, d_model=64, d_ff=128)
    assert cfg.optimizer == "adafactor"
    model = t_build(cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4)
    opt = get_optimizer(cfg.optimizer, constant(1e-2))
    state = init_train_state(model, 0, optimizer=opt, device="cpu")
    step_fn = make_train_step(model, optimizer=opt)
    losses = []
    for s in range(20):
        state, m = step_fn(state, batch_to_torch(data.batch(s), "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses[::5]
