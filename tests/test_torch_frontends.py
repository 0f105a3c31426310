"""The stub front ends in the port (ROADMAP item 10e): llava-next-mistral-7b
(``vlm``: a mistral backbone whose first ``n_img_tokens`` positions carry
projected image embeddings) and hubert-xlarge (``audio``: a bidirectional
encoder over frame embeddings, no RoPE, a classifier ``head`` and no
decode), at smoke size on the CPU (8 image tokens), against the JAX
reference.  The reference tests these cover are `tests/test_arch_smoke.py`
(one train step and a prefill / decode of each of the four archs this slice
adds, finite and of the right shape) and `tests/test_system.py`'s config
shapes (`tests/test_torch_archs.py` holds every field of the configs).

Both packages get the reference's params (`repro_torch.bridge`).  Held:
* llava's prefill with ``img_embed`` and teacher-forced decodes after it:
  logits within 1e-5 of the reference run op by op with the same greedy
  tokens; within 0.25 of the jitted reference or its own op-by-op vs
  jitted distance where larger (the rule of `tests/test_torch_archs.py`);
  the image overwrites the first n_img positions, the prompt's first S -
  n_img token embeddings shift right behind it and its last n_img tokens
  are cut (they change no logit); token-only requests are refused;
* hubert's encoder prefill (the last frame's logits, the cache handed back
  untouched) within 1e-5 of the reference op by op; its attention sees
  later frames and applies no RoPE;
* loss and gradients of both against `jax.value_and_grad`: the bounds of
  `tests/test_torch_train.py` (loss 1e-4 / 1e-3, gradients 1e-2 / 5e-2 of
  the norm, or the reference's own jit-vs-op-by-op distance where larger);
* `data/pipeline.py`'s frames, labels and image embeddings equal the
  reference's; the bridge carries ``mm_proj``, ``in_norm`` and ``head``
  and the port's own init draws the same leaves; the engine and the serve
  CLI refuse hubert (the CLI with the reference's message); every new arch
  takes a smoke train step (finite loss and gradients, the
  `tests/test_arch_smoke.py` check) and runs on the train CLI.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.registry import build_model as j_build
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticLMData, batch_to_torch
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_transformer
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import Engine
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)

ARCHS = ("llava_next_mistral_7b", "hubert_xlarge")
NEW_ARCHS = ARCHS + ("phi3_5_moe", "mixtral_8x22b")
TOL = 1e-5
LOGIT_TOL = 0.25

_MODELS: dict = {}


def _models(arch: str):
    """((reference cfg, model, params), (port cfg, model, bridged params))
    of one arch's smoke variant."""
    if arch not in _MODELS:
        jcfg = j_smoke(j_get_config(arch))
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = smoke_variant(get_config(arch))
        tm = t_build(tcfg)
        tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
        _MODELS[arch] = (jcfg, jm, jp), (tcfg, tm, tp)
    return _MODELS[arch]


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


def _batch(cfg, B=2, S=24, seed=0):
    """The model inputs of a data-pipeline batch (no labels)."""
    b = SyntheticLMData(cfg, seq_len=S, global_batch=B, seed=seed).batch(0)
    return {k: v for k, v in b.items() if k != "labels"}


# ---------------------------------------------------------------------------
# llava: prefill with image embeddings, decodes
# ---------------------------------------------------------------------------

def _llava_reference(jm, jp, batch, max_len, fed=None, n_dec=0, jit=False):
    prefill, decode = jm.prefill, jm.decode
    if jit:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    with contextlib.nullcontext() if jit else jax.disable_jit():
        cache = jm.init_cache(batch["tokens"].shape[0], max_len)
        logits, cache = prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                cache)
        out, greedy = [np.asarray(logits, np.float32)], []
        for i in range(n_dec if fed is None else len(fed)):
            tok = (np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
                   if fed is None else fed[i])
            greedy.append(tok)
            logits, cache = decode(jp, jnp.asarray(tok), cache)
            out.append(np.asarray(logits, np.float32))
    return out, greedy


def _llava_port(tm, tpp, batch, max_len, fed):
    with torch.no_grad():
        cache = tm.init_cache(batch["tokens"].shape[0], max_len, device="cpu")
        logits, cache = tm.prefill(tpp, batch_to_torch(batch, "cpu"), cache)
        out = [logits.numpy()]
        for tok in fed:
            logits, cache = tm.decode(tpp, torch.from_numpy(tok).long(), cache)
            out.append(logits.numpy())
    return out


def test_llava_prefill_and_decodes_match_reference():
    """A prompt of 24 positions (8 image + 16 text), then 6 decodes."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models("llava_next_mistral_7b")
    batch = _batch(tcfg)
    eager, fed = _llava_reference(jm, jp, batch, 32, n_dec=6)
    got = _llava_port(tm, tm.prepare(tp), batch, 32, fed)
    jitted, _ = _llava_reference(jm, jp, batch, 32, fed=fed, jit=True)
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


def test_llava_image_overwrites_first_positions():
    """The first residual stream: img_embed @ mm_proj at positions 0 ..
    n_img - 1, then the embeddings of the prompt's first S - n_img tokens;
    its last n_img tokens are cut, so changing them changes no logit."""
    _, (tcfg, tm, tp) = _models("llava_next_mistral_7b")
    n, batch = tcfg.n_img_tokens, batch_to_torch(_batch(tcfg), "cpu")
    x = t_transformer.embed_batch(tp, tcfg, batch)
    S = batch["tokens"].shape[1]
    img = batch["img_embed"].bfloat16() @ tp["mm_proj"].bfloat16()
    assert torch.equal(x[:, :n], img)
    assert torch.equal(x[:, n:], t_transformer.embed_tokens(
        tp, tcfg, batch["tokens"][:, :S - n]))
    tpp = tm.prepare(tp)
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, S - n:] = (other["tokens"][:, S - n:] + 1) % tcfg.vocab
    with torch.no_grad():
        a, _ = tm.prefill(tpp, batch, tm.init_cache(2, S, device="cpu"))
        b, _ = tm.prefill(tpp, other, tm.init_cache(2, S, device="cpu"))
    assert torch.equal(a, b)


def test_llava_token_only_prefill_refused():
    """Without image embeddings the stub front end has nothing for its
    first positions: the prefill refuses (the reference fails on the
    missing key), so the engine serves no token-only llava request."""
    _, (tcfg, tm, tp) = _models("llava_next_mistral_7b")
    batch = {"tokens": torch.zeros((1, 12), dtype=torch.long)}
    with pytest.raises(ValueError, match="img_embed"):
        tm.prefill(tm.prepare(tp), batch, tm.init_cache(1, 16, device="cpu"))
    eng = Engine(tm, tp, max_len=16, device="cpu")
    eng.submit(np.zeros(12, np.int32), 2)
    with pytest.raises(ValueError, match="img_embed"):
        eng.run()


# ---------------------------------------------------------------------------
# hubert: the bidirectional encoder
# ---------------------------------------------------------------------------

def test_hubert_prefill_matches_reference_and_keeps_cache():
    """The encoder prefill of 2 x 24 frames: the last frame's logits within
    1e-5 of the reference op by op; the cache is handed back untouched."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models("hubert_xlarge")
    batch = _batch(tcfg)
    with jax.disable_jit():
        want, _ = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                             None)
    cache = tm.init_cache(2, 24, device="cpu")
    with torch.no_grad():
        got, back = tm.prefill(tm.prepare(tp), batch_to_torch(batch, "cpu"), cache)
    assert back is cache and cache["pos"] == 0
    assert not cache["k"].any() and (cache["kv_pos"] == -1).all()
    assert got.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)
    with torch.no_grad():
        _, none = tm.prefill(tm.prepare(tp), batch_to_torch(batch, "cpu"), None)
    assert none is None
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode(tp, torch.zeros((2, 1), dtype=torch.long), cache)


def test_hubert_attention_is_bidirectional_without_rope(monkeypatch):
    """A change to the last frame reaches the first position's hidden state
    (a causal mask would hide it), and the forward never calls RoPE."""
    _, (tcfg, tm, tp) = _models("hubert_xlarge")
    batch = batch_to_torch(_batch(tcfg), "cpu")

    def no_rope(*a, **k):
        raise AssertionError("bidirectional attention applied RoPE")

    monkeypatch.setattr(t_layers, "rope_apply", no_rope)
    other = dict(batch, frames=batch["frames"].clone())
    other["frames"][:, -1] += 1.0
    with torch.no_grad():
        a, _ = t_transformer.forward(tp, tcfg, batch)
        b, _ = t_transformer.forward(tp, tcfg, other)
    assert not torch.equal(a[:, 0], b[:, 0])


# ---------------------------------------------------------------------------
# training, data, bridge, refusals
# ---------------------------------------------------------------------------

def _rel_norm(got, want) -> float:
    num = sum(float(np.sum((np.float64(g) - np.float64(w)) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.float64(w) ** 2)) for w in want)
    return (num / den) ** 0.5


def _ref_grads(tree) -> list:
    port = bridge.params_from_reference(jax.tree.map(np.asarray, tree))
    return [_np(g) for g in tree_leaves(port)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Loss within 1e-4 / 1e-3 relative of the reference op by op / jitted;
    gradients (mm_proj's, in_norm's and head's included) within 1e-2 /
    5e-2 relative norm, or the reference's own distance where larger."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    batch = SyntheticLMData(tcfg, seq_len=24, global_batch=2).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ps = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tm.loss(ps, batch_to_torch(batch, "cpu"))
    grads = [g.float().numpy() for g in torch.autograd.grad(loss, tree_leaves(ps))]
    with jax.disable_jit():
        want_loss, want_g = jax.value_and_grad(jm.loss)(jp, jb)
    jit_loss, jit_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jit_loss), rtol=1e-3)
    assert all(np.isfinite(g).all() for g in grads)
    eager, jitted = _ref_grads(want_g), _ref_grads(jit_g)
    own = _rel_norm(jitted, eager)
    assert _rel_norm(grads, eager) <= max(1e-2, own)
    assert _rel_norm(grads, jitted) <= max(5e-2, own)
    named = dict(zip((p for p, _ in tree_paths(tp)), grads))
    for name in ("mm_proj",) if arch.startswith("llava") else ("in_norm", "head"):
        assert np.abs(named[name]).max() > 0, name


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_reference(arch, seed, step):
    """Frames and random labels (hubert), tokens and image embeddings
    (llava): the reference's arrays, from the same seeded numpy stream."""
    jcfg, tcfg = j_smoke(j_get_config(arch)), smoke_variant(get_config(arch))
    want = JData(jcfg, seq_len=16, global_batch=3, seed=seed).batch(step)
    got = SyntheticLMData(tcfg, seq_len=16, global_batch=3, seed=seed).batch(step)
    assert got.keys() == want.keys()
    assert ("frames" in got) == (arch == "hubert_xlarge")
    assert ("img_embed" in got) == (arch != "hubert_xlarge")
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tb = batch_to_torch(got, "cpu")
    assert tb["labels"].dtype == torch.int64
    for k in ("frames", "img_embed"):
        if k in tb:
            assert tb[k].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_own_init(arch):
    """The bridge carries every reference leaf (``mm_proj``, ``in_norm``
    and ``head`` unstacked, the layers split) with its values, and stacking
    back gives the reference's arrays; the port's own init draws the same
    leaves and shapes (no token ``embed`` for hubert, no ``lm_head`` either)."""
    (jcfg, _, jp), (tcfg, tm, tp) = _models(arch)
    extra = {"mm_proj"} if arch.startswith("llava") else {"in_norm", "head"}
    assert extra <= set(tp) and not extra & {"layers"}
    ref = jax.tree.map(np.asarray, jp)
    back = {k: (v if k != "layers" else
                {n: ({m: np.stack([_np(lp[n][m]) for lp in v]) for m in v[0][n]}
                     if isinstance(v[0][n], dict)
                     else np.stack([_np(lp[n]) for lp in v])) for n in v[0]})
            for k, v in tp.items()}
    for path, leaf in tree_paths(ref):
        node = back
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_array_equal(_np(node), leaf.astype(np.float32))
    own = tm.init(0, device="cpu")
    assert [p for p, _ in tree_paths(own)] == [p for p, _ in tree_paths(tp)]
    for (_, a), (_, b) in zip(tree_paths(own), tree_paths(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if arch == "hubert_xlarge":
        assert "embed" not in own and "lm_head" not in own
        assert torch.equal(own["in_norm"], torch.zeros(tcfg.d_model))
    pp = tm.prepare(tp)
    head = "mm_proj" if arch.startswith("llava") else "head"
    want = (np.asarray(jp[head]).astype(jnp.bfloat16).astype(np.float32))
    got = (pp["mm_proj"] if head == "mm_proj"
           else torch.cat(list(pp["unembed"]), dim=1))  # its column blocks
    np.testing.assert_array_equal(_np(got), want)


def test_engine_and_cli_refuse_hubert():
    """Encoder-only: the engine refuses to serve hubert, and the serve CLI
    exits with the reference CLI's message."""
    _, (tcfg, tm, tp) = _models("hubert_xlarge")
    with pytest.raises(ValueError, match="no decode path"):
        Engine(tm, tp, max_len=16, device="cpu")
    with pytest.raises(SystemExit) as e:
        serve_main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    assert str(e.value) == f"{tcfg.name} is encoder-only; no decode path"


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_train_step_and_prefill(arch):
    """The reference's `tests/test_arch_smoke.py` on the port: one loss and
    gradient of the smoke variant (B 2, S 64), finite with a positive
    gradient norm; a prefill (and a decode where the arch has one) with
    finite logits of shape (B, 1, V)."""
    tcfg = smoke_variant(get_config(arch))
    tm = t_build(tcfg)
    tp = tm.init(0, device="cpu")
    b = SyntheticLMData(tcfg, seq_len=64, global_batch=2).batch(1)
    ps = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tm.loss(ps, batch_to_torch(b, "cpu"))
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    gnorm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    assert np.isfinite(float(loss)) and np.isfinite(gnorm) and gnorm > 0
    inputs = batch_to_torch({k: v for k, v in b.items() if k != "labels"}, "cpu")
    tpp = tm.prepare(tp)
    with torch.no_grad():
        logits, cache = tm.prefill(tpp, inputs, tm.init_cache(2, 128, device="cpu"))
        assert logits.shape == (2, 1, tcfg.vocab) and torch.isfinite(logits).all()
        if tcfg.supports_decode:
            logits, _ = tm.decode(tpp, logits[:, -1].argmax(-1)[:, None], cache)
            assert logits.shape == (2, 1, tcfg.vocab) and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_cli_runs(arch, capsys):
    """The train CLI takes every new arch at smoke size on the CPU."""
    assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "final loss" in out
