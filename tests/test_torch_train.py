"""The port's training path against the JAX reference, on the CPU, at the
reference integration tests' size (2 layers, d_model 64, d_ff 128, seq 32,
batch 4): the data pipeline, the optimizers and schedules, the loss and its
gradients on bridged params (dense and spiking), 5-step trajectories, the
reference's learns tests re-run in the port, checkpoint restart, the LTH
prune-once contract under training, and the train CLI.

Tolerances, and why:
* data batches, and spike words where compared: equal;
* optimizers, schedules, clipping and EF-int8 on one small tree: 1e-6
  relative (the same f32 formulas in the same order; only `pow` and the
  reductions are other implementations);
* loss against the reference run op by op (``jax.disable_jit``): 1e-5
  relative for the spiking model, whose forward here is the op-by-op
  reference's bit for bit; 1e-4 for the dense model: bf16 reductions in
  another order round a few outputs the other way (at layer 0 one
  attention output and two rmsnorm outputs of 8192), and the dense MLP
  carries those ulps into the loss where the spiking FFN's threshold
  absorbs them;
* gradients: the norm of the difference over all leaves within 1e-2 of the
  reference's gradient norm (every bf16 product's gradient is rounded to
  bf16 after an f32 sum in another order; measured 3.5e-3 spiking, 5.6e-3
  dense, while the reference's own jitted and op-by-op gradients differ by
  1.8e-2 and 9.3e-3);
* against the jitted reference (XLA keeps fused bf16 adds in f32, ROADMAP
  §3): loss 1e-3 relative, gradients 5e-2 of the norm;
* 5-step trajectories against the jitted reference: per-step loss 2e-3
  relative, grad norm 5e-2, final params within 0.15 of the norm of their
  change: Adam turns gradient differences that are tiny in size into
  full-size steps; the reference's own jitted and op-by-op trajectories
  differ by 8.4e-2 (spiking) and 3.8e-2 (dense) of the change after 5
  steps, and their losses by up to 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.data.pipeline import SyntheticLMData as JData
from repro.models import layers as j_layers
from repro.models.registry import build_model as j_build
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import get_optimizer as j_get_optimizer
from repro.optim import global_norm as j_global_norm
from repro.optim.compress import ErrorFeedbackInt8 as JEF
from repro.optim.schedules import constant as j_constant
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticLMData, batch_to_torch
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as t_layers
from repro_torch.models.registry import build_model
from repro_torch.optim import (
    ErrorFeedbackInt8,
    adafactor,
    adamw,
    clip_by_global_norm,
    constant,
    get_optimizer,
    global_norm,
    warmup_cosine,
)
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)

KINDS = {"dense": {},
         "spiking": dict(spiking_ffn=True, spiking_T=4, spiking_weight_density=0.3)}


def _port_setup(kind="dense"):
    cfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                              n_layers=2, d_model=64, d_ff=128, **KINDS[kind])
    return cfg, build_model(cfg), SyntheticLMData(cfg, seq_len=32, global_batch=4)


def _ref_setup(kind="dense"):
    cfg = dataclasses.replace(j_smoke_variant(j_get_config("llama3_2_1b")),
                              n_layers=2, d_model=64, d_ff=128, **KINDS[kind])
    return cfg, j_build(cfg), JData(cfg, seq_len=32, global_batch=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_norm(got: list, want: list, base: list | None = None) -> float:
    """|got - want| / |base| over all leaves (base defaults to want)."""
    base = want if base is None else base
    num = sum(float(np.sum((np.float64(g) - np.float64(w)) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.float64(b) ** 2)) for b in base)
    return (num / den) ** 0.5


def _port_leaves(tree) -> list:
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def _ref_leaves(tree) -> list:
    """Reference leaves in the port's walk order: each stacked layer leaf
    split into its layers."""
    return _port_leaves(bridge.params_from_reference(_np(tree)))


# ---------------------------------------------------------------------------
# data, schedules, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (3, 7)])
def test_synthetic_batches_equal_reference(seed, step):
    jcfg, _, _ = _ref_setup()
    cfg, _, _ = _port_setup()
    want = JData(jcfg, seq_len=32, global_batch=4, seed=seed).batch(step)
    got = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=seed).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tb = batch_to_torch(got, "cpu")
    assert tb["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(tb["labels"].numpy(), want["labels"])


def test_schedules_match_reference():
    steps = [0, 1, 5, 199, 200, 201, 5000, 10000, 20000]
    for js, ts in ((j_warmup_cosine(3e-4, 200, 10000), warmup_cosine(3e-4, 200, 10000)),
                   (j_warmup_cosine(1e-3, 0, 50, floor=0.0),
                    warmup_cosine(1e-3, 0, 50, floor=0.0)),
                   (j_constant(3e-3), constant(3e-3))):
        for s in steps:
            want = float(js(jnp.asarray(s, jnp.int32)))
            got = ts(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 40)).astype(np.float32),
            "b": rng.normal(size=(40,)).astype(np.float32),
            "c": {"d": rng.normal(size=(2, 36, 33)).astype(np.float32)}}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


OPTIMIZERS = {
    "adamw": (lambda s: j_adamw(s), lambda s: adamw(s)),
    "adamw_decay": (lambda s: j_adamw(s, weight_decay=0.1),
                    lambda s: adamw(s, weight_decay=0.1)),
    "adamw_bf16_moments": (lambda s: j_adamw(s, moment_dtype=jnp.bfloat16),
                           lambda s: adamw(s, moment_dtype=torch.bfloat16)),
    "adafactor": (lambda s: j_adafactor(s), lambda s: adafactor(s)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    """Three updates of one small tree with the same grads: the updates and
    every state leaf within 1e-6."""
    j_opt = OPTIMIZERS[name][0](j_warmup_cosine(1e-2, 2, 10))
    t_opt = OPTIMIZERS[name][1](warmup_cosine(1e-2, 2, 10))
    params = _small_tree(0)
    js, ts = j_opt.init(jax.tree.map(jnp.asarray, params)), t_opt.init(_t(params))
    for i in range(3):
        grads = _small_tree(i + 1)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, grads), js,
                              jax.tree.map(jnp.asarray, params))
        tu, ts = t_opt.update(_t(grads), ts, _t(params))
        for (p, got), want in zip(tree_paths(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} step {i}: {p}")
        for (p, got), want in zip(tree_paths(ts), jax.tree.leaves(js)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want).astype(np.float32),
                                       rtol=1e-6, atol=1e-12, err_msg=f"{name}: {p}")
        params = jax.tree.map(lambda p, u: p + np.asarray(u), params, _np(ju))
    assert get_optimizer("adamw", constant(1.0)).init(_t(params))["count"] == 0
    with pytest.raises(ValueError):
        get_optimizer("sgd", constant(1.0))


def test_clip_and_global_norm_match_reference():
    tree = _small_tree(5)
    jt = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(global_norm(_t(tree))), float(j_global_norm(jt)),
                               rtol=1e-6)
    for max_norm in (1.0, 1e3):
        (got, gn), (want, wn) = clip_by_global_norm(_t(tree), max_norm), j_clip(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


def test_error_feedback_matches_reference():
    """Three compress rounds carrying the error: dequantised grads, error,
    int8 payload and scales."""
    params = _small_tree(0)
    je, te = JEF(), ErrorFeedbackInt8()
    jerr, terr = je.init(jax.tree.map(jnp.asarray, params)), te.init(_t(params))
    for i in range(3):
        grads = _small_tree(10 + i)
        jg, jerr, jpay = je.compress(jax.tree.map(jnp.asarray, grads), jerr)
        tg, terr, tpay = te.compress(_t(grads), terr)
        for got, want in zip(_port_leaves(tg) + _port_leaves(terr),
                             [np.asarray(a) for a in jax.tree.leaves(jg)
                              + jax.tree.leaves(jerr)]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        flat = tree_leaves(tpay)  # (int8, scale) pairs, flattened
        for q, s, want in zip(flat[::2], flat[1::2], jax.tree.leaves(
                jpay, is_leaf=lambda x: isinstance(x, tuple))):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(float(s), float(want[1]), rtol=1e-6)


# ---------------------------------------------------------------------------
# layers, loss and gradients on bridged params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_dense_mlp_matches_reference(act):
    """The dense MLPs on the same bf16 input: one bf16 step at most (torch's
    CPU bf16 GEMM rounds a few outputs the other way)."""
    jcfg, _, _ = _ref_setup()
    jcfg = dataclasses.replace(jcfg, act=act)
    cfg = dataclasses.replace(_port_setup()[0], act=act)
    jp = j_layers.mlp_init(jax.random.PRNGKey(1), jcfg)
    tp = tree_map(lambda a: bridge.to_torch(a), _np(jp))
    assert sorted(tp) == (["wd", "wg", "wu"] if act in ("swiglu", "geglu")
                          else ["wd", "wu"])
    assert sorted(t_layers.mlp_init(torch.Generator().manual_seed(0), cfg)) == sorted(tp)
    x = np.random.default_rng(2).normal(size=(4, 32, 64)).astype(np.float32)
    with jax.disable_jit():
        want = j_layers.mlp_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    got = t_layers.mlp_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_cache_free_attention_matches_reference():
    jcfg, _, _ = _ref_setup()
    cfg, _, _ = _port_setup()
    jp = j_layers.attn_init(jax.random.PRNGKey(3), jcfg)
    tp = tree_map(lambda a: bridge.to_torch(a), _np(jp))
    x = np.random.default_rng(4).normal(size=(4, 32, 64)).astype(np.float32)
    with jax.disable_jit():
        want, cache = j_layers.attn_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    assert cache is None
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    got = t_layers.attn_apply(tp, xt, cfg,
                              positions=torch.arange(32)[None].expand(4, 32))
    got.float().sum().backward()  # differentiable: nothing written in place
    assert xt.grad is not None and torch.isfinite(xt.grad.float()).all()
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _bridged(kind):
    """(kind, reference cfg/model/data/params, port model/bridged params)."""
    jcfg, jm, jdata = _ref_setup(kind)
    _, tm, _ = _port_setup(kind)
    jp = jm.init(jax.random.PRNGKey(0))
    return kind, jcfg, jm, jdata, jp, tm, bridge.params_from_reference(_np(jp))


@pytest.fixture(scope="module", params=sorted(KINDS))
def bridged(request):
    return _bridged(request.param)


def _port_loss_and_grads(tm, tp, batch):
    ps = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tm.loss(ps, batch_to_torch(batch, "cpu"))
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    return float(loss.detach()), [g.float().numpy() for g in grads]


def test_loss_and_grads_match_reference(bridged):
    kind, jcfg, jm, jdata, jp, tm, tp = bridged
    batch = jdata.batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = _port_loss_and_grads(tm, tp, batch)
    with jax.disable_jit():
        want_loss, want_g = jax.value_and_grad(jm.loss)(jp, jb)
    jit_loss, jit_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    np.testing.assert_allclose(loss, float(want_loss),
                               rtol=1e-5 if kind == "spiking" else 1e-4)
    np.testing.assert_allclose(loss, float(jit_loss), rtol=1e-3)
    want_g, jit_g = _ref_leaves(want_g), _ref_leaves(jit_g)
    assert _rel_norm(grads, want_g) <= 1e-2
    assert _rel_norm(grads, jit_g) <= 5e-2
    if kind == "spiking":  # pruned weights get exactly zero gradient
        for (path, w), g in zip(tree_paths(tp), grads):
            if path.endswith(("mlp/wu", "mlp/wd")):
                assert not np.any(g[w.numpy() == 0]), path


def test_chunked_loss_matches_reference():
    """``cfg.loss_chunk`` bounds the live logits, each chunk recomputed in
    the backward, as the reference's remat'd map does: the loss equals the
    unchunked one, and loss and gradients hold to the op-by-op reference
    run with the same chunks at the tolerances above (each chunk's
    gradient of the tied embedding is rounded to bf16 on its own, in both
    packages, so chunked gradients differ from unchunked ones)."""
    _, jcfg, jm, jdata, jp, tm, tp = _bridged("spiking")
    jcfg = dataclasses.replace(jcfg, loss_chunk=32)
    cfg = dataclasses.replace(tm.cfg, loss_chunk=32)
    batch = jdata.batch(0)
    batch["labels"][0, :5] = -1  # masked labels
    unchunked, _ = _port_loss_and_grads(tm, tp, batch)
    loss, grads = _port_loss_and_grads(build_model(cfg), tp, batch)
    assert loss == unchunked
    with jax.disable_jit():
        want_loss, want_g = jax.value_and_grad(j_build(jcfg).loss)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert _rel_norm(grads, _ref_leaves(want_g)) <= 1e-2


def _reference_hidden_spikes(jcfg, jp, tokens):
    """Each layer's FFN hidden spikes (T, B*S, F) of the reference's
    training forward, written out layer by layer (jit it, or run it op by
    op)."""
    from repro.core import lif as j_lif
    from repro.core import snn_layers as j_snn
    from repro.models import transformer as j_tf

    scfg = j_snn.SpikingConfig(T=jcfg.spiking_T,
                               weight_density=jcfg.spiking_weight_density)
    x = j_tf.embed_tokens(jp, jcfg, tokens)
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out = []
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], jp["layers"])
        h, _ = j_layers.attn_apply(lp["attn"], j_layers.rmsnorm(
            x, lp["ln1"], jcfg.norm_eps), jcfg, positions=pos)
        x = x + h
        n2 = j_layers.rmsnorm(x, lp["ln2"], jcfg.norm_eps)
        xm = n2.astype(jnp.bfloat16).reshape(-1, jcfg.d_model)
        w = j_snn.freeze_pruned(lp["mlp"]["wu"].astype(jnp.bfloat16))
        out.append(j_snn.spiking_linear_train(
            j_lif.direct_encode(xm, jcfg.spiking_T), w, scfg))
        x = x + j_layers.mlp_apply(lp["mlp"], n2, jcfg)
    return out


def test_spiking_hidden_spikes_match_reference(monkeypatch):
    """Every layer's FFN hidden spikes in the training forward: equal to the
    op-by-op reference's; against the jitted reference, whose fused bf16
    residual adds keep excess precision, the flips are counted (measured:
    45 and 341 of 65536 positions at layers 0 and 1, against 2155 and 2742
    spikes) and bounded by 2%."""
    from repro_torch.core import snn_layers as t_snn

    _, jcfg, jm, jdata, jp, tm, tp = _bridged("spiking")
    batch = jdata.batch(0)
    tokens = jnp.asarray(batch["tokens"])
    with jax.disable_jit():
        want = [np.asarray(a) for a in _reference_hidden_spikes(jcfg, jp, tokens)]
    jitted = [np.asarray(a) for a in
              jax.jit(lambda p, t: _reference_hidden_spikes(jcfg, p, t))(jp, tokens)]
    got, lif = [], t_snn.lif_forward

    def recorded(o, **kw):
        spikes, u = lif(o, **kw)
        got.append(spikes.detach().float().numpy())
        return spikes, u

    monkeypatch.setattr(t_snn, "lif_forward", recorded)
    with torch.no_grad():
        tm.loss(tp, batch_to_torch(batch, "cpu"))
    assert len(got) == len(want) == jcfg.n_layers
    for layer, (g, w, j) in enumerate(zip(got, want, jitted)):
        assert g.shape == w.shape and g.sum() > 0
        np.testing.assert_array_equal(g, w, err_msg=f"layer {layer}")
        assert (g != j).sum() <= 0.02 * g.size, (layer, int((g != j).sum()))


def test_train_trajectory_matches_reference(bridged):
    """5 steps from the same state (constant lr 3e-3, as the reference's
    integration tests train) against the jitted reference step."""
    kind, jcfg, jm, jdata, jp, tm, tp = bridged
    jopt = j_get_optimizer("adamw", j_constant(3e-3))
    topt = get_optimizer("adamw", constant(3e-3))
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), optimizer=jopt)
    state = bridge.train_state_from_reference(_np(jstate))
    jstep = jax.jit(j_make_train_step(jm, optimizer=jopt))
    step = make_train_step(tm, optimizer=topt)
    for s in range(5):
        batch = jdata.batch(s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, batch_to_torch(batch, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=2e-3, err_msg=f"step {s}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=5e-2)
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert int(state["opt"]["count"]) == 5
    start = _port_leaves(tp)
    moved = [w - s0 for w, s0 in zip(_ref_leaves(jstate["params"]), start)]
    assert _rel_norm(_port_leaves(state["params"]), _ref_leaves(jstate["params"]),
                     base=moved) <= 0.15


# ---------------------------------------------------------------------------
# the reference's integration tests, in the port
# ---------------------------------------------------------------------------

def _run(model, data, state, steps, start=0, optimizer=None, grad_compress=False):
    step_fn = make_train_step(model, optimizer=optimizer, grad_compress=grad_compress)
    losses = []
    for s in range(start, start + steps):
        state, m = step_fn(state, batch_to_torch(data.batch(s), "cpu"))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("kind,steps,drop", [("dense", 30, 0.2), ("spiking", 25, 0.1)])
def test_training_learns(kind, steps, drop):
    """The reference's test_training_learns and test_spiking_ffn_lm_trains:
    the constant-lr smoke optimizer lowers the loss."""
    cfg, model, data = _port_setup(kind)
    opt = get_optimizer(cfg.optimizer, constant(3e-3))
    state = init_train_state(model, 0, optimizer=opt, device="cpu")
    _, losses = _run(model, data, state, steps, optimizer=opt)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - drop, losses[::5]


def test_grad_compression_trains():
    cfg, model, data = _port_setup()
    state = init_train_state(model, 0, grad_compress=True, device="cpu")
    assert set(state) == {"params", "opt", "step", "ef_err"}
    state, losses = _run(model, data, state, 20, grad_compress=True)
    assert losses[-1] < losses[0]
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state["ef_err"]))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_restart_is_bit_exact(tmp_path, async_save):
    cfg, model, data = _port_setup("spiking")
    state = init_train_state(model, 0, device="cpu")
    state_a, _ = _run(model, data, state, 6)
    state_b, _ = _run(model, data, state, 3)
    mgr = CheckpointManager(str(tmp_path), interval=1, async_save=async_save, keep=2)
    for s in (1, 2, 3):
        mgr.maybe_save(s, state_b, force=True)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    restored, step = mgr.restore_latest(init_train_state(model, 1, device="cpu"))
    assert step == 3
    state_b2, _ = _run(model, data, restored, 3, start=3)
    assert [p for p, _ in tree_paths(state_a)] == [p for p, _ in tree_paths(state_b2)]
    for a, b in zip(tree_leaves(state_a), tree_leaves(state_b2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(state) == (None, None)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_pruned_weights_stay_zero(weight_decay):
    """The LTH prune-once contract under training: every pruned entry of
    every wu/wd is exactly 0 after the steps, and the survivors moved."""
    cfg, model, data = _port_setup("spiking")
    opt = get_optimizer("adamw", constant(3e-3), weight_decay=weight_decay)
    state = init_train_state(model, 0, optimizer=opt, device="cpu")
    before = {p: t.clone() for p, t in tree_paths(state["params"])
              if p.endswith(("mlp/wu", "mlp/wd"))}
    state, _ = _run(model, data, state, 5, optimizer=opt)
    after = dict(tree_paths(state["params"]))
    for p, w0 in before.items():
        pruned = w0 == 0
        assert 0.6 < float(pruned.float().mean()) < 0.8, p
        assert torch.equal(after[p][pruned], torch.zeros_like(after[p][pruned])), p
        # survivors move, except where every step's gradient was 0 (a wd row
        # of a hidden neuron that never fired) and nothing decays them
        moved = float((after[p][~pruned] != w0[~pruned]).float().mean())
        assert moved == 1.0 if weight_decay else moved > 0.5, (p, moved)


def test_preemption_handler_and_straggler_timer():
    """A real SIGTERM sets `should_stop` and `restore` reinstates the old
    handler (twice is a no-op); `StepTimer` flags a step over twice the
    running median once it has five."""
    import os
    import signal

    from repro_torch.ft import PreemptionHandler, StepTimer

    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler()
    try:
        assert not h.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop
    finally:
        h.restore()
        h.restore()
    assert signal.getsignal(signal.SIGTERM) == before
    seen = []
    timer = StepTimer(window=10, threshold=2.0, on_straggler=seen.append)
    for dt in (1.0, 1.1, 0.9, 1.0, 1.05, 3.5, 1.0):
        timer.observe(dt)
    assert [e["step_time"] for e in seen] == [3.5] == [e["step_time"] for e in timer.events]
    with timer:
        pass
    assert len(timer.window) == 8


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "llama3_2_1b", "--smoke", "--device", "cpu", "--log-every", "1",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert "step     2 loss" in first and "final loss" in first
    assert (tmp_path / "step_3" / "manifest.json").exists()
    assert train_cli.main(args + ["--steps", "5"]) == 0
    second = capsys.readouterr().out
    assert "[restore] resumed from step 3" in second
    assert "step     3 loss" in second and "step     2 loss" not in second


def test_train_cli_refuses_without_a_card_and_on_a_mesh(monkeypatch, capsys):
    """Without a card and without --device the CLI raises; ``--mesh host``
    trains as the reference's does (it parses the flag and never reads
    it): the same losses as ``--mesh none``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "llama3_2_1b", "--smoke", "--steps", "1"])
    args = ["--arch", "llama3_2_1b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    capsys.readouterr()
    assert train_cli.main(args + ["--mesh", "host"]) == 0
    host = capsys.readouterr().out
    assert train_cli.main(args + ["--mesh", "none"]) == 0
    assert "step     1 loss" in host and capsys.readouterr().out == host


def test_bridge_train_state_keeps_values():
    jcfg, jm, _ = _ref_setup()
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), grad_compress=True)
    state = bridge.train_state_from_reference(_np(jstate))
    assert set(state) == {"params", "opt", "step", "ef_err"}
    assert state["opt"]["count"].dtype == torch.int32
    for got, want in zip(_port_leaves(state["params"]), _ref_leaves(jstate["params"])):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="AdamW"):
        bridge.train_state_from_reference(
            {"params": {}, "opt": {"v": {}, "count": 0}, "step": 0})
