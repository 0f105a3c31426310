"""The recurrent families in the port (ROADMAP items 10b and 10c): RWKV6
(rwkv6-1.6b, the ``ssm`` family) and Zamba2 (zamba2-7b, the ``hybrid``
family: Mamba2 layers and a weight-shared attention block) at smoke size on
the CPU, against the JAX reference.

Both packages get the reference's params (`repro_torch.bridge`).  Held:
* every module (`token_shift`, `chunked_seq_scan`, the WKV recurrence and
  the RWKV6 block, the causal conv, the SSD chunked form, the Mamba2 block
  in both branches, the shared block) within 1e-5 of the reference run op
  by op (``jax.disable_jit``), each on the training path and on the serving
  path (fixed row blocks) where it has both;
* the models' prefill and teacher-forced decode logits against the
  reference op by op: every block call of the stack, given the reference's
  inputs, within 1e-5 of the reference's outputs and new state, the logits
  within 1e-5 given the last block's (`_force_port_blocks`).  The f32
  rsqrt, row means and transcendentals of XLA and of torch on the CPU
  round differently in their last bit
  (`test_rmsnorm_rounding_differs_only_at_bf16_boundaries`); where that
  lands on a bf16 rounding boundary an element moves by a bf16 ulp, so a
  bf16 result may differ in isolated elements (at most 0.5% of them) by one
  ulp of its own (`_close_bf16`) or, carried through a product or sum in
  the block, of the tensor's largest magnitude (`_close_block`).  Free
  running, the recurrences carry such flips on (1.0e-2 zamba2, 2.6e-2
  rwkv6 at some of these inputs): the logits within 0.25 of the reference
  op by op, and of the jitted one or the reference's own op-by-op vs
  jitted distance where larger (the rule of `tests/test_torch_archs.py`),
  with the same greedy tokens but at a near tie;
* loss and gradients against `jax.value_and_grad` (the bounds of
  `tests/test_torch_train.py`, or the reference's own jit-vs-op-by-op
  gradient distance where larger, 1.8e-2 / 2.2e-2 here), decode ==
  prefill (the reference's 2e-2), the serving state's shapes and dtypes,
  the bridge both ways;
* serving: zamba2 with a spiking shared MLP under `for_arch`'s packed
  policy against the reference engine; the float cells of
  `tests/test_arch_parity_matrix.py` (tokens
  equal to the port's solo loop and to the reference engine's), the cache
  concat / take round trip and engine-vs-loop of `tests/test_serve_engine.py`,
  drain -> resume == undisturbed, speculation refused with the reference's
  message, a lone request == the same request in a cohort bit for bit (the
  serving forward's row blocks), and the serve CLI.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import layers as j_layers
from repro.models import mamba2 as j_mamba2
from repro.models import rwkv6 as j_rwkv6
from repro.models import scan_utils as j_scan
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_variant
from repro_torch.ft import PreemptionHandler
from repro_torch.launch.serve import generate
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as t_layers
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models import scan_utils as t_scan
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import DenseCacheOps, Engine, ExecutionPolicy, Handoff
from repro_torch.serve import draft as t_draft
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)

ARCHS = ("rwkv6_1_6b", "zamba2_7b")
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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_bf16(got, want, tol=TOL, share=5e-3):
    """bf16 results: within ``tol`` but for isolated elements (at most
    ``share`` of them) off by one bf16 ulp, where the two libraries' f32
    intermediates round to either side of a bf16 boundary."""
    g, w = _np(got), _np(want)
    off = np.abs(g - w) > tol + tol * np.abs(w)
    assert off.sum() <= share * off.size, (int(off.sum()), off.size)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w[off]), 1e-30))) - 7)
    assert (np.abs(g - w)[off] <= ulp).all()


def _bf16(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(ml_dtypes.bfloat16)


def _f32(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _layer(jp, key, i=0):
    return jax.tree.map(lambda a: a[i], jp[key])


# ---------------------------------------------------------------------------
# scan utilities
# ---------------------------------------------------------------------------

def test_token_shift_matches_reference():
    rng = np.random.default_rng(0)
    x, prev = _bf16(rng, (2, 5, 8)), _bf16(rng, (2, 8))
    js, jp_ = j_scan.token_shift(jnp.asarray(x), jnp.asarray(prev))
    ts, tp_ = t_scan.token_shift(bridge.to_torch(x), bridge.to_torch(prev))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(_np(tp_), _np(jp_))


@pytest.mark.parametrize("chunk", [4, 3, 0, 8], ids=["chunked", "indivisible",
                                                      "off", "one-chunk"])
def test_chunked_seq_scan_matches_reference(chunk):
    """Values equal the reference's scan whether the branch chunks (S 8,
    chunk 4) or not (3 does not divide 8; 0 is off; S <= chunk); under
    autograd the checkpointed chunks give the plain loop's gradients."""
    rng = np.random.default_rng(1)
    xs = (_f32(rng, (8, 2, 3)), _f32(rng, (8, 2, 3)))
    s0 = _f32(rng, (2, 3))

    def jstep(s, inp):
        a, b = inp
        s = 0.9 * s + a * b
        return s, jnp.tanh(s) + b

    def tstep(s, inp):
        a, b = inp
        s = 0.9 * s + a * b
        return s, torch.tanh(s) + b

    with jax.disable_jit():
        js, jy = j_scan.chunked_seq_scan(jstep, jnp.asarray(s0),
                                         tuple(map(jnp.asarray, xs)), chunk)
    ts, ty = t_scan.chunked_seq_scan(tstep, torch.from_numpy(s0),
                                     tuple(map(torch.from_numpy, xs)), chunk)
    _close(ts, js)
    _close(ty, jy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in xs]
    grads = []
    for remat in (True, False):
        s, y = t_scan.chunked_seq_scan(tstep, torch.from_numpy(s0),
                                       tuple(leaves), chunk, remat=remat)
        grads.append(torch.autograd.grad((s.sum() + (y * y).sum()), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_invariant", [False, True], ids=["plain", "blocks"])
def test_wkv_matches_reference(row_invariant):
    """The WKV recurrence (S 8, chunk 4; 5 rows, so the serving path pads
    a second block of 4)."""
    rng = np.random.default_rng(2)
    B, S, H, dh = 5, 8, 4, 16
    r, k, v = (_f32(rng, (B, S, H, dh)) for _ in range(3))
    w = np.exp(-np.exp(_f32(rng, (B, S, H, dh)) - 1)).astype(np.float32)
    u, st = _f32(rng, (H, dh), 0.1), _f32(rng, (B, H, dh, dh))
    with jax.disable_jit():
        jo, js = j_rwkv6._wkv(*map(jnp.asarray, (r, k, v, w, u, st)), 4)
    to, ts = t_rwkv6._wkv(*map(torch.from_numpy, (r, k, v, w, u, st)), 4,
                          row_invariant=row_invariant)
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("state", ["zero", "threaded"])
def test_rwkv_block_matches_reference(state):
    """One RWKV6 block: the training forward (zero state) and a serving
    forward from a random state (row blocks), output and new state."""
    (jcfg, _, jp), (tcfg, _, tp) = _models("rwkv6_1_6b")
    rng = np.random.default_rng(3)
    x = _bf16(rng, (3, 8, tcfg.d_model))
    H, dh, D = tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.d_model
    st = None if state == "zero" else {
        "tm_prev": _bf16(rng, (3, D)), "cm_prev": _bf16(rng, (3, D)),
        "wkv": _f32(rng, (3, H, dh, dh), 0.3)}
    with jax.disable_jit():
        jx, jst = j_rwkv6.block_apply(
            _layer(jp, "layers"), jnp.asarray(x), jcfg,
            state=None if st is None else jax.tree.map(jnp.asarray, st))
    tx, tst = t_rwkv6.block_apply(
        tp["layers"][0], bridge.to_torch(x), tcfg,
        state=None if st is None else {k: bridge.to_torch(v) for k, v in st.items()})
    assert tx.dtype == torch.bfloat16
    _close_bf16(tx, jx)
    for key in ("tm_prev", "cm_prev", "wkv"):
        assert str(tst[key].dtype).endswith(str(jst[key].dtype)), key
        _close(tst[key], jst[key])


# ---------------------------------------------------------------------------
# Mamba2 and the shared block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prev", [False, True], ids=["zeros", "carry"])
def test_causal_conv_matches_reference(prev):
    rng = np.random.default_rng(4)
    x, w = _bf16(rng, (2, 6, 16)), _bf16(rng, (4, 16))
    p = _bf16(rng, (2, 3, 16)) if prev else None
    jy, jn = j_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if p is None else jnp.asarray(p))
    ty, tn = t_mamba2._causal_conv(bridge.to_torch(x), bridge.to_torch(w),
                                   None if p is None else bridge.to_torch(p))
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tn), _np(jn))


def _ssm_inputs(rng, B=5, S=16, H=4, dh=8, St=8):
    xh = _f32(rng, (B, S, H, dh))
    b_t, c_t = _f32(rng, (B, S, St)), _f32(rng, (B, S, St))
    dt = np.log1p(np.exp(_f32(rng, (B, S, H)))).astype(np.float32)
    decay = np.exp(-dt * np.float32(0.7)).astype(np.float32)
    return xh, b_t, c_t, decay, dt, _f32(rng, (B, H, dh, St), 0.3)


def test_ssd_chunked_matches_reference():
    """The SSD chunked form over two chunks of 8 from a random state."""
    args = _ssm_inputs(np.random.default_rng(5))
    with jax.disable_jit():
        jh, jy = j_mamba2._ssd_chunked(*map(jnp.asarray, args), 8)
    th, ty = t_mamba2._ssd_chunked(*map(torch.from_numpy, args), 8)
    _close(th, jh)
    _close(ty, jy)


@pytest.mark.parametrize("state", ["train", "serving"])
@pytest.mark.parametrize("S", [8, 6], ids=["chunked", "steps"])
def test_mamba_block_matches_reference(S, state):
    """One Mamba2 block: S 8 (= ssm_chunk) takes the SSD chunked form, S 6
    the per-step scan; the training forward and a serving forward from a
    random conv / ssm state (5 rows: two blocks of 4, the second padded)."""
    (jcfg, _, jp), (tcfg, _, tp) = _models("zamba2_7b")
    assert tcfg.ssm_chunk == 8
    rng = np.random.default_rng(6)
    d_in = tcfg.ssm_expand * tcfg.d_model
    x = _bf16(rng, (5, S, tcfg.d_model))
    st = None if state == "train" else {
        "conv": _bf16(rng, (5, tcfg.conv_width - 1, d_in)),
        "ssm": _f32(rng, (5, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state),
                    0.3)}
    with jax.disable_jit():
        jx, jst = j_mamba2.mamba_apply(
            _layer(jp, "mamba"), jnp.asarray(x), jcfg,
            state=None if st is None else jax.tree.map(jnp.asarray, st))
    tx, tst = t_mamba2.mamba_apply(
        tp["mamba"][0], bridge.to_torch(x), tcfg,
        state=None if st is None else {k: bridge.to_torch(v) for k, v in st.items()})
    _close_bf16(tx, jx)
    assert (tst is None) == (jst is None)
    if st is not None:
        np.testing.assert_array_equal(_np(tst["conv"]), _np(jst["conv"]))
        _close(tst["ssm"], jst["ssm"])


@pytest.mark.parametrize("cache", [False, True], ids=["train", "cache"])
def test_shared_block_matches_reference(cache):
    """Zamba2's shared block on concat(hidden, embedding): without a cache
    and over a cache at position 3 (k / v written in place)."""
    (jcfg, _, jp), (tcfg, _, tp) = _models("zamba2_7b")
    rng = np.random.default_rng(7)
    B, S, D = 2, 5, tcfg.d_model
    x, x0 = _bf16(rng, (B, S, D)), _bf16(rng, (B, S, D))
    if not cache:
        with jax.disable_jit():
            jy, _ = j_mamba2.shared_block_apply(jp["shared"], jnp.asarray(x),
                                                jnp.asarray(x0), jcfg)
        ty = t_mamba2.shared_block_apply(
            tp["shared"], bridge.to_torch(x), bridge.to_torch(x0), tcfg,
            positions=torch.arange(S)[None].expand(B, S))
        _close_bf16(ty, jy)
        return
    pos, s_cache, KV, dh = 3, 12, tcfg.n_kv, tcfg.head_dim
    k, v = _bf16(rng, (B, s_cache, KV, dh)), _bf16(rng, (B, s_cache, KV, dh))
    kv_pos = np.where(np.arange(s_cache) < pos, np.arange(s_cache), -1
                      ).astype(np.int32)
    positions = pos + np.arange(S)[None].repeat(B, 0)
    with jax.disable_jit():
        jy, jc = j_mamba2.shared_block_apply(
            jp["shared"], jnp.asarray(x), jnp.asarray(x0), jcfg,
            cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                   "kv_pos": jnp.asarray(kv_pos), "pos": jnp.int32(pos)},
            positions=jnp.asarray(positions))
    t_kv_pos = torch.from_numpy(kv_pos)
    t_kv_pos[pos:pos + S] = torch.arange(pos, pos + S, dtype=torch.int32)
    tc = {"k": bridge.to_torch(k), "v": bridge.to_torch(v), "kv_pos": t_kv_pos,
          "pos": pos}
    ty = t_mamba2.shared_block_apply(
        tp["shared"], bridge.to_torch(x), bridge.to_torch(x0), tcfg,
        positions=torch.from_numpy(positions), cache=tc)
    _close_bf16(ty, jy)
    np.testing.assert_array_equal(_np(tc["k"]), _np(jc["k"]))
    np.testing.assert_array_equal(_np(tc["v"]), _np(jc["v"]))
    np.testing.assert_array_equal(t_kv_pos.numpy(), np.asarray(jc["kv_pos"]))


def test_rmsnorm_rounding_differs_only_at_bf16_boundaries():
    """Why the op-by-op bounds follow the reference's own noise: on f32
    inputs the reference's
    op-by-op rsqrt and row mean differ from torch's in the last bit for many
    rows, so the port's RMS norm of bf16 inputs equals the reference's
    except for single elements that sit on a bf16 rounding boundary, each
    off by one bf16 ulp."""
    rng = np.random.default_rng(8)
    v = rng.uniform(0.01, 100, size=(4096,)).astype(np.float32)
    with jax.disable_jit():
        jr = np.asarray(jax.lax.rsqrt(jnp.asarray(v)))
    assert (torch.rsqrt(torch.from_numpy(v)).numpy() != jr).sum() > 100
    x = _bf16(rng, (512, 64), 3.0)
    scale = _f32(rng, (64,), 0.1)
    with jax.disable_jit():
        want = np.asarray(j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
                          np.float32)
    got = _np(t_layers.rmsnorm(bridge.to_torch(x), torch.from_numpy(scale)))
    differ = got != want
    assert differ.sum() <= 0.001 * differ.size
    ulp = np.abs(want[differ]) * 2.0 ** -7
    assert (np.abs(got - want)[differ] <= ulp * 1.01).all()


# ---------------------------------------------------------------------------
# models: logits, loss and grads, decode == prefill, state, bridge
# ---------------------------------------------------------------------------

def _reference_logits(jm, jp, toks, fed, jit):
    """Reference prefill logits and one teacher-forced decode per ``fed``
    token column."""
    prefill, decode = jm.prefill, jm.decode
    if jit:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    with contextlib.nullcontext() if jit else jax.disable_jit():
        cache = jm.init_cache(toks.shape[0], toks.shape[1] + len(fed) + 1)
        logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)}, cache)
        out = [np.asarray(logits, np.float32)]
        for tok in fed:
            logits, cache = decode(jp, jnp.asarray(tok), cache)
            out.append(np.asarray(logits, np.float32))
    return out


def _port_logits(tm, tpp, toks, fed):
    cache = tm.init_cache(toks.shape[0], toks.shape[1] + len(fed) + 1,
                          device="cpu")
    with torch.no_grad():
        logits, cache = tm.prefill(tpp, {"tokens": torch.from_numpy(toks).long()},
                                   cache)
        out = [logits.numpy()]
        for tok in fed:
            logits, cache = tm.decode(tpp, torch.from_numpy(tok).long(), cache)
            out.append(logits.numpy())
    return out, cache


# the block functions each stack calls, by the module both packages hold
# them in: (reference module, port module, function)
_BLOCKS = {"rwkv": (j_rwkv6, t_rwkv6, "block_apply"),
           "mamba": (j_mamba2, t_mamba2, "mamba_apply"),
           "shared": (j_mamba2, t_mamba2, "shared_block_apply")}


def _near(got, want):
    """A free-running input against the reference's: the same tensor but
    for the bf16 flips the earlier blocks carried on (within LOGIT_TOL)."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=LOGIT_TOL)


def _close_block(got, want, tol=TOL, share=5e-3):
    """A block's output or state given the reference's inputs: f32 within
    ``tol``; bf16 within ``tol`` but for isolated elements (at most
    ``share`` of them) where an intermediate's bf16 rounding went the other
    way (`_close_bf16`) and a product or sum carried it on, each within one
    bf16 ulp of the tensor's largest magnitude."""
    if got.dtype != torch.bfloat16:
        return _close(got, want, tol)
    g, w = _np(got), _np(want)
    off = np.abs(g - w) > tol + tol * np.abs(w)
    assert off.sum() <= share * off.size, (int(off.sum()), off.size)
    ulp = np.exp2(np.floor(np.log2(max(np.abs(w).max(), 1e-30))) - 7)
    assert (np.abs(g - w)[off] <= ulp).all(), (np.abs(g - w).max(), ulp)


def _record_reference_blocks(monkeypatch) -> list:
    """Record every reference block call (name, args, kwargs, result) of
    the forwards run until ``monkeypatch.undo()``."""
    calls = []
    for name, (jmod, _, fn) in _BLOCKS.items():
        def recorded(*a, _real=getattr(jmod, fn), _name=name, **k):
            out = _real(*a, **k)
            calls.append((_name, a, k, out))
            return out
        monkeypatch.setattr(jmod, fn, recorded)
    return calls


def _force_port_blocks(monkeypatch, calls: list) -> list:
    """Teacher-force the port's stacks with the recorded reference calls:
    the n-th block call of the port's forwards holds its own inputs near
    the n-th recorded call's, then runs on that call's inputs (its cache
    slabs overwritten with the reference's), its outputs and new state are
    held to the recorded ones within 1e-5 (bf16 values but for isolated
    elements, `_close_block`), and the recorded outputs go on.
    Every block of the stack is so held op by op without the flips of
    earlier blocks; returns the calls left (none once the forwards ran)."""
    left = list(calls)

    def ref(name):
        got = left.pop(0)
        assert got[0] == name, (got[0], name)
        return got[1:]

    def recurrent(name, real):
        def forced(lp, x, cfg, state=None):
            (_, jx, _), jk, (jout, jst) = ref(name)
            _near(x, jx)
            for key, leaf in state.items():
                _near(leaf, jk["state"][key])
            out, st = real(lp, bridge.to_torch(np.asarray(jx)), cfg, state={
                key: bridge.to_torch(np.asarray(v)) for key, v in jk["state"].items()})
            _close_block(out, jout)
            for key, leaf in st.items():
                _close_block(leaf, jst[key])
            return (bridge.to_torch(np.asarray(jout)),
                    {key: bridge.to_torch(np.asarray(v)) for key, v in jst.items()})
        return forced

    def shared(real):
        def forced(p, x, x0, cfg, *, positions, cache=None, spiking_mode="train"):
            (_, jx, jx0, _), jk, (jout, jcache) = ref("shared")
            _near(x, jx)
            np.testing.assert_array_equal(_np(x0), _np(jx0))
            np.testing.assert_array_equal(positions.numpy(),
                                          np.asarray(jk["positions"]))
            assert cache["pos"] == int(jk["cache"]["pos"])
            for key in ("k", "v"):
                _near(cache[key], jk["cache"][key])
                cache[key].copy_(bridge.to_torch(np.asarray(jk["cache"][key])))
            out = real(p, bridge.to_torch(np.asarray(jx)), x0, cfg,
                       positions=positions, cache=cache, spiking_mode=spiking_mode)
            _close_block(out, jout)
            for key in ("k", "v"):
                _close_block(cache[key], jcache[key])
            return bridge.to_torch(np.asarray(jout))
        return forced

    for name, (_, tmod, fn) in _BLOCKS.items():
        real = getattr(tmod, fn)
        monkeypatch.setattr(tmod, fn, shared(real) if name == "shared"
                            else recurrent(name, real))
    return left


def _hold_logits(arch, toks, fed, monkeypatch, **over):
    """The port's prefill and teacher-forced decodes (prepared params)
    against the reference's.  Op by op: every block of the stack
    teacher-forced (`_force_port_blocks`), and the logits then within 1e-5.
    Free-running: within LOGIT_TOL of the reference op by op, and of the
    jitted reference or its own op-by-op vs jitted distance where larger
    (the rule of `tests/test_torch_archs.py`); greedy tokens equal but at a
    near tie.  Returns the free-running logits and cache."""
    (_, jm, jp), (tcfg, tm, tp) = _models(arch, **over)
    tpp = tm.prepare(tp)
    got, cache = _port_logits(tm, tpp, toks, fed)
    calls = _record_reference_blocks(monkeypatch)
    eager = _reference_logits(jm, jp, toks, fed, jit=False)
    monkeypatch.undo()
    assert {c[0] for c in calls} == ({"rwkv"} if tcfg.family == "ssm"
                                     else {"mamba", "shared"})
    left = _force_port_blocks(monkeypatch, calls)
    forced, _ = _port_logits(tm, tpp, toks, fed)
    monkeypatch.undo()
    assert not left, f"{len(left)} reference block calls not met"
    for f, e in zip(forced, eager):
        _close(f, e)
    jitted = _reference_logits(jm, jp, toks, fed, jit=True)
    for g, e, j in zip(got, eager, jitted):
        assert g.shape == e.shape and np.isfinite(g).all()
        own = float(np.abs(e - j).max())
        for want, bound in ((e, LOGIT_TOL), (j, max(LOGIT_TOL, own))):
            np.testing.assert_allclose(g, want, rtol=0, atol=bound)
            top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
            tie = top2[:, 1] - top2[:, 0] <= 2 * bound
            assert ((g[:, -1].argmax(-1) == want[:, -1].argmax(-1)) | tie).all()
    return got, cache


@pytest.mark.parametrize("S", [8, 6], ids=["chunked", "steps"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_reference(arch, S, monkeypatch):
    """Prefill (S 8 takes zamba2's SSD chunked form, S 6 its per-step scan)
    and two teacher-forced decodes, on the prepared params: every block of
    the stack within 1e-5 of the reference op by op given its inputs, the
    logits within 1e-5 given the last block's; free-running within 0.25 of
    both runs of the reference (`_hold_logits`)."""
    _, (tcfg, _, _) = _models(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tcfg.vocab, size=(2, S)).astype(np.int32)
    fed = [rng.integers(0, tcfg.vocab, size=(2, 1)).astype(np.int32)
           for _ in range(2)]
    _, cache = _hold_logits(arch, toks, fed, monkeypatch)
    assert cache["pos"] == S + 2


def test_zamba_spiking_shared_mlp_matches_reference(monkeypatch):
    """zamba2 with ``spiking_ffn``: the shared block's MLP is the spiking
    FFN; its float path (the training forward and a float-policy serve)
    equals the reference's as the float model's does (`_hold_logits`), and
    at weight density 0.3 the dual-sparse route's join plans attach to it
    (the reference's counts)."""
    _, (tcfg, _, tp) = _models("zamba2_7b", spiking_ffn=True)
    assert set(tp["shared"]["mlp"]) == {"wu", "wd"}
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tcfg.vocab, size=(2, 6)).astype(np.int32)
    fed = [rng.integers(0, tcfg.vocab, size=(2, 1)).astype(np.int32)]
    _hold_logits("zamba2_7b", toks, fed, monkeypatch, spiking_ffn=True)
    (jcfg, _, jp), (tcfg, _, tp) = _models("zamba2_7b", spiking_ffn=True,
                                           spiking_weight_density=0.3)
    planned = t_layers.attach_spiking_ffn_plans(tp, tcfg)
    assert {"plan_in", "plan_out"} <= set(planned["shared"]["mlp"])
    want = j_layers.attach_spiking_ffn_plans(jp, jcfg)["shared"]["mlp"]
    np.testing.assert_array_equal(
        planned["shared"]["mlp"]["plan_in"].cnt.numpy(), np.asarray(want["plan_in"].cnt))


def _rel_norm(got, want) -> float:
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum(w ** 2)) for w in want)
    return (num / den) ** 0.5


def _ref_grads(tree) -> list:
    """Reference grads (stacked layers) in the port's leaf order."""
    port = bridge.params_from_reference(jax.tree.map(np.asarray, tree))
    return [_np(g) for g in tree_leaves(port)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The training forward (S 16: rwkv6's WKV scan checkpointed per chunk
    of 8, zamba2's SSD over two chunks) and its gradients: loss within 1e-4
    of the reference op by op and 1e-3 of the jitted one; gradients within
    1e-2 / 5e-2 relative norm (`tests/test_torch_train.py`'s bounds), or the
    reference's own jitted vs op-by-op distance where larger."""
    (_, jm, jp), (tcfg, tm, tp) = _models(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab, size=(2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ps = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = tm.loss(ps, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = [g.float().numpy() for g in
             torch.autograd.grad(loss, tree_leaves(ps))]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode reproduces the prefill's logits (the
    reference's `test_decode_matches_prefill`, its 2e-2 bound): prefill of
    S tokens against prefill of S - 1 and a decode of the last."""
    _, (tcfg, tm, tp) = _models(arch)
    tpp = tm.prepare(tp)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab, size=(2, 16))).long()
    with torch.no_grad():
        full, _ = tm.prefill(tpp, {"tokens": toks},
                             tm.init_cache(2, 24, device="cpu"))
        _, cache = tm.prefill(tpp, {"tokens": toks[:, :-1]},
                              tm.init_cache(2, 24, device="cpu"))
        dec, _ = tm.decode(tpp, toks[:, -1:], cache)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=2e-2, atol=2e-2)


def _ref_state_leaves(arch, state):
    """The reference's serving state under the port's flat keys."""
    if arch == "zamba2_7b":
        a = state["attn"]
        state = dict(conv=state["conv"], ssm=state["ssm"], attn_k=a["k"],
                     attn_v=a["v"], kv_pos=a["kv_pos"], pos=a["pos"])
    return state


@pytest.mark.parametrize("arch", ARCHS)
def test_state_init_matches_reference(arch):
    """The serving state's leaves, shapes and dtypes equal the
    reference's (zamba2's nested attention cache under flat keys), ``pos``
    a host int, and the axes the engine reads name the batch axis."""
    (_, jm, _), (_, tm, _) = _models(arch)
    want = _ref_state_leaves(arch, jm.init_cache(3, 16))
    got = tm.init_cache(3, 16, device="cpu")
    assert sorted(got) == sorted(want) == sorted(tm.cache_axes())
    for k, w in want.items():
        if k == "pos":
            assert got[k] == 0 and tm.cache_axes()[k] == ()
            continue
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_array_equal(_np(got[k]), _np(w))
        assert len(tm.cache_axes()[k]) == got[k].ndim


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_own_init(arch):
    """Every reference leaf lands in the port's tree (each stacked layer
    key split per layer, zamba2's ``shared`` carried as it is) with its
    values, and stacking back gives the reference's arrays; the port's own
    init has the same leaves and shapes."""
    (jcfg, _, jp), (tcfg, tm, tp) = _models(arch)
    stacked = "layers" if arch == "rwkv6_1_6b" else "mamba"
    assert isinstance(tp[stacked], list) and len(tp[stacked]) == jcfg.n_layers
    ref = jax.tree.map(np.asarray, jp)
    back = {k: (v if k != stacked else
                {n: np.stack([_np(lp[n]) for lp in v]) for n in v[0]})
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_keeps_every_forward_value(arch):
    """`prepare`'s load-time casts change no value a forward sees: the
    prepared and the raw params give the same logits bit for bit, and only
    matrices the forward casts to the compute dtype were cast."""
    _, (tcfg, tm, tp) = _models(arch)
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, size=(2, 6)
                                              ).astype(np.int32)
    fed = [toks[:, :1]]
    raw, _ = _port_logits(tm, tp, toks, fed)
    prepped, _ = _port_logits(tm, tm.prepare(tp), toks, fed)
    for a, b in zip(raw, prepped):
        np.testing.assert_array_equal(a, b)
    pp = tm.prepare(tp)
    lp = pp["layers"][0] if arch == "rwkv6_1_6b" else pp["mamba"][0]
    kept = ("u", "w0", "ln1") if arch == "rwkv6_1_6b" else ("a_log", "dt_bias",
                                                             "d_skip", "ln")
    assert all(lp[k].dtype == torch.float32 for k in kept)
    assert pp["unembed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _scenario(scenario: str):
    """(prompt lens, gen lens, arrival steps), the reference matrix's."""
    if scenario == "batch1":
        return [10], [4], [0]
    return [8, 8, 12], [4, 5, 4], [0, 1, 1]


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


def _reference_tokens(arch, scenario, jit=True):
    """The reference engine's tokens for a scenario's requests (both
    scenarios in one sync serve per arch, the batch1 request first and
    alone), from its jitted run or its run op by op."""
    key = (arch, jit)
    if key not in _REF:
        (jcfg, jm, jp), _ = _models(arch)
        (l1, g1, _), (ls, gs, arr) = map(_scenario, SCENARIOS)
        max_len = max(n + g for n, g in zip(l1 + ls, g1 + gs)) + 2
        with contextlib.nullcontext() if jit else jax.disable_jit():
            eng = JEngine(jm, jp, max_len=max_len, max_slots=2,
                          policy=JPolicy.for_arch(jcfg))
            prompts = _prompts(jcfg.vocab, l1) + _prompts(jcfg.vocab, ls)
            tokens = _staggered(eng, prompts, g1 + gs, [0] + [a + 1 for a in arr])
        _REF[key] = {"batch1": tokens[:1], "staggered": tokens[1:]}
    return _REF[key][scenario]


@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_parity_matrix_float_cells(arch, scenario, execution):
    """The float cells of the reference's matrix: the engine's tokens equal
    the port's solo greedy loop per request and the reference engine's for
    the same schedule (its jitted run's, or where a request differs from
    that run, its run op by op)."""
    _, (tcfg, tm, tp) = _models(arch)
    lens, gens, arrivals = _scenario(scenario)
    prompts = _prompts(tcfg.vocab, lens)
    max_len = max(n + g for n, g in zip(lens, gens)) + 2
    policy = ExecutionPolicy.for_arch(tcfg, execution=execution)
    assert policy.spike_format == "float"
    engine = Engine(tm, tp, max_len=max_len, max_slots=2, policy=policy,
                    device="cpu")
    got = _staggered(engine, prompts, gens, arrivals)
    for p, g, out in zip(prompts, gens, got):
        solo = generate(tm, engine.params, torch.from_numpy(p).long()[None],
                        tm.init_cache(1, max_len, device="cpu"), g)[0].numpy()
        np.testing.assert_array_equal(out, solo)
    want = _reference_tokens(arch, scenario)
    if any(not np.array_equal(a, b) for a, b in zip(got, want)):
        want = _reference_tokens(arch, scenario, jit=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert engine.summary()["n_requests"] == len(prompts)


def test_zamba_spiking_serve_matches_reference_engine():
    """zamba2 with ``spiking_ffn`` served under `for_arch`'s policy (packed
    spikes, dense weights: the path `chip_smoke.py`'s phase 13c serves on
    the card, here through the kernels' plain versions) against the
    reference engine under its own `for_arch` policy: the same tokens, every
    step's logits within LOGIT_TOL; and bit for bit the port's float-policy
    serve (the packed path's forward values are the float path's)."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models("zamba2_7b", spiking_ffn=True)
    prompts = _prompts(tcfg.vocab, [8, 8, 8], seed=1)
    jpol, pol = JPolicy.for_arch(jcfg), ExecutionPolicy.for_arch(tcfg)
    assert ((jpol.spike_format, jpol.weight_sparsity)
            == (pol.spike_format, pol.weight_sparsity) == ("packed", "dense"))
    ref = JEngine(jm, jp, max_len=16, max_slots=3, policy=jpol, capture_logits=True)
    want = ref.generate_batch(prompts, 6)
    want_logits = ref.drain_logit_traces()
    got = {}
    for name, policy in (("packed", pol),
                         ("float", ExecutionPolicy.for_arch(tcfg, spike_format="float"))):
        eng = Engine(tm, tp, max_len=16, max_slots=3, policy=policy,
                     capture_logits=True, device="cpu")
        got[name] = eng.generate_batch(prompts, 6), eng.drain_logit_traces()
    toks, logits = got["packed"]
    for a, b in zip(toks, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(logits, want_logits):
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=0, atol=LOGIT_TOL)
    for a, b in zip(toks, got["float"][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(logits, got["float"][1]):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_concat_take_roundtrip(arch):
    """The reference's `test_cache_concat_take_roundtrip`: merge a 2-row and
    a 3-row state, keep rows 0-1, get the first state back."""
    _, (tcfg, tm, _) = _models(arch)
    ops = DenseCacheOps(tm.cache_axes())
    a = tm.init_cache(2, 16, device="cpu")
    a = {k: (v + torch.rand(v.shape).to(v.dtype) if isinstance(v, torch.Tensor)
             and v.is_floating_point() else v) for k, v in a.items()}
    b = tm.init_cache(3, 16, device="cpu")
    merged = ops.concat([a, b])
    assert ops.batch_size(merged) == 5
    back = ops.take(merged, [0, 1])
    for (pa, la), (pb, lb) in zip(tree_paths(a), tree_paths(back)):
        assert pa == pb
        if isinstance(la, torch.Tensor):
            torch.testing.assert_close(la, lb, rtol=0, atol=0)
        else:
            assert la == lb


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_loop(arch):
    """The reference's `test_engine_matches_reference_loop`: 4 prompts of
    16, 8 new tokens, one fully batched cohort; tokens equal the port's own
    greedy loop.  Against the reference, teacher-forced with the served
    tokens: every step's logits within 0.25 of its run op by op (or its own
    op-by-op vs jitted distance over the serve, where larger), and each
    served token its greedy token but at a near tie (zamba2 meets one at
    these prompts, a top-two gap of 3e-3)."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    B, P, G = 4, 16, 8
    prompts = _prompts(tcfg.vocab, [P] * B, seed=0)
    engine = Engine(tm, tp, max_len=P + G, max_slots=B, device="cpu")
    got = np.stack(engine.generate_batch(prompts, G))
    loop = generate(tm, engine.params, torch.from_numpy(np.stack(prompts)).long(),
                    tm.init_cache(B, P + G, device="cpu"), G).numpy()
    np.testing.assert_array_equal(got, loop)
    s = engine.summary()
    assert s["n_requests"] == B and s["total_tokens"] == B * G
    assert s["mean_decode_batch"] == B
    toks = np.stack(prompts)
    fed = [got[:, i:i + 1] for i in range(G - 1)]
    mine, _ = _port_logits(tm, engine.params, toks, fed)
    eager = _reference_logits(jm, jp, toks, fed, jit=False)
    jitted = _reference_logits(jm, jp, toks, fed, jit=True)
    bound = max([LOGIT_TOL] + [float(np.abs(e - j).max())
                               for e, j in zip(eager, jitted)])
    for step, (g, e) in enumerate(zip(mine, eager)):
        np.testing.assert_allclose(g, e, rtol=0, atol=bound)
        np.testing.assert_array_equal(g[:, -1].argmax(-1), got[:, step])
        top2 = np.sort(e[:, -1], axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= 2 * bound
        assert ((got[:, step] == e[:, -1].argmax(-1)) | tie).all(), step


@pytest.mark.parametrize("arch", ARCHS)
def test_lone_request_equals_cohort_bit_for_bit(arch):
    """Row invariance of the serving forward: a request served alone emits
    the tokens and logits it emits among three others (one cohort), bit for
    bit."""
    _, (tcfg, tm, tp) = _models(arch)
    prompts = _prompts(tcfg.vocab, [8] * 4, seed=3)
    kw = dict(max_len=16, max_slots=4, capture_logits=True, device="cpu")
    cohort = Engine(tm, tp, **kw)
    outs = cohort.generate_batch(prompts, 6)
    lone = Engine(tm, tp, **kw)
    one = lone.generate_batch(prompts[2:3], 6)
    np.testing.assert_array_equal(one[0], outs[2])
    for a, b in zip(lone.drain_logit_traces()[0],
                    cohort.drain_logit_traces()[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_drain_resume_equals_undisturbed(arch, tmp_path):
    """Preempt after 2 steps, drain within 2 more, save, load, resume: the
    successor's tokens equal an undisturbed serve's, and every in-flight
    request rode the resume ledger."""
    _, (tcfg, tm, tp) = _models(arch)
    prompts = _prompts(tcfg.vocab, [8] * 5, seed=0)
    kw = dict(max_len=16, max_slots=2, device="cpu")
    want = Engine(tm, tp, **kw).generate_batch(prompts, 8)
    handler = PreemptionHandler(signals=())
    victim = Engine(tm, tp, preemption=handler, **kw)
    tickets = [victim.submit(p, 8) for p in prompts]
    for _ in range(2):
        victim.step()
    handler.trigger()
    handoff = victim.drain(step_budget=2)
    c = handoff.counts()
    assert c["inflight"] > 0 and c["tokens_in_flight"] > 0
    handoff.save(str(tmp_path))
    successor = Engine.resume(tm, tp, Handoff.load(str(tmp_path)), device="cpu")
    assert successor._resume_expect
    out = successor.run()
    assert successor._resume_expect == {}
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(out[t.rid], w)


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_refused_with_reference_message(arch):
    """A recurrent state cannot be rewound: the engine refuses
    ``speculation=draft`` with the reference engine's message."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _models(arch)
    from repro.serve import draft as j_draft

    with pytest.raises(ValueError) as want:
        JEngine(jm, jp, max_len=16, policy=JPolicy.for_arch(
            jcfg, speculation=j_draft(JPolicy.for_arch(jcfg), 2)))
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, max_len=16, device="cpu", policy=ExecutionPolicy.for_arch(
            tcfg, speculation=t_draft(ExecutionPolicy.for_arch(tcfg), 2)))
    assert str(got.value) == str(want.value)
    assert "non-rewindable" in str(got.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs(arch, capsys):
    """The reference's serve command from SKILL.md, on the port's CLI on
    the CPU: 4 requests through 2 slots, batches aligned to 2."""
    assert serve_main(["--arch", arch, "--smoke", "--batch", "4", "--gen", "4",
                       "--prompt-len", "8", "--max-slots", "2",
                       "--batch-align", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests / 16 tokens" in out
