"""The port's serve and training examples (`examples/serve_llm_torch.py`,
`serve_dvs_torch.py`, `spiking_ffn_llm_torch.py`) against the JAX
reference on the CPU, each at its own smoke size, from the reference's
params bridged to the port (`repro_torch/bridge.py`).

Held:
* serve_llm_torch: each of its three archs' requests (the same arrivals,
  the same late merge) give the reference engine's tokens, equal: its
  jitted run's, or where a request differs from that run, its run op by op
  (XLA's fused numerics move rwkv6's third request off the op-by-op
  trajectory there; the port follows the op-by-op one, as
  `tests/test_torch_recurrent.py` holds it);
* serve_dvs_torch: the frame tokens of both streams equal the reference's,
  the served tokens equal the reference engine's (jitted, or op by op as
  above: the jitted run flips one token of the second stream), and
  incremental ingestion
  equals the one-shot prompt (the example asserts it);
* spiking_ffn_llm_torch: the first step's loss within 1e-3 relative of the
  jitted reference's (`tests/test_torch_train.py`'s bound against the
  jitted reference: XLA keeps fused bf16 adds in f32), and the loss drops
  over 8 steps.
The reference examples run their work at import, so their calls are
replayed here through `repro`.
"""
import contextlib
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.data.events import moving_blob_events, split_into_windows
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import EventStream as JEventStream
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import StreamSession as JStreamSession
from repro.serve import adaptive_t as j_adaptive_t
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-3


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "rwkv6_1_6b", "zamba2_7b"])
def test_serve_llm_example_matches_reference_engine(arch):
    ex = _example("serve_llm_torch")
    jcfg = smoke_variant(get_config(arch))
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    got = ex.serve(arch, "cpu", params=bridge.params_from_reference(_np(jp)),
                   log=lambda _: None)

    def replay(jit):
        """The reference example's calls on its engine."""
        with contextlib.nullcontext() if jit else jax.disable_jit():
            rng = np.random.default_rng(0)
            ref = JEngine(jm, jp, max_len=ex.P + 1 + ex.G, max_slots=4,
                          batch_align=2, policy=JPolicy.for_arch(jcfg))
            reqs = [ref.submit(rng.integers(0, jcfg.vocab, size=(ex.P,)), ex.G)
                    for _ in range(3)]
            ref.step()
            late = rng.integers(0, jcfg.vocab, size=(ex.P + 1,))
            reqs.append(ref.submit(late, ex.G))
            out = ref.run()
        np.testing.assert_array_equal(got["prompts"][-1], late)
        return [np.asarray(out[r.rid]) for r in reqs], ref.summary()

    want, js = replay(jit=True)
    if any(not np.array_equal(g, w) for g, w in zip(got["tokens"], want)):
        want, js = replay(jit=False)
    for g, w in zip(got["tokens"], want):
        np.testing.assert_array_equal(g, w)
    s = got["summary"]
    assert s["cohort_merges"] == js["cohort_merges"] >= 1
    assert s["total_tokens"] == js["total_tokens"] == 4 * ex.G


def _reference_dvs(ex, jm, jp, jcfg, jit=True):
    """The reference example's streams on its engine: (frame tokens,
    served tokens), jitted or op by op."""
    with contextlib.nullcontext() if jit else jax.disable_jit():
        return _reference_streams(ex, jm, jp, jcfg)


def _reference_streams(ex, jm, jp, jcfg):
    policy = JPolicy.for_arch(jcfg, temporal=j_adaptive_t(1))
    engine = JEngine(jm, jp, max_len=ex.N_WIN + ex.GEN, max_slots=2, policy=policy)
    sessions, tickets, feeds = [], [], []
    for i, silent in enumerate(ex.SILENT):
        events = moving_blob_events(ex.N_WIN, height=16, width=16,
                                    window_us=ex.WINDOW_US, seed=i, silent=silent)
        session = JStreamSession(JEventStream(ex.WINDOW_US), height=16, width=16,
                                 T=jcfg.spiking_T, vocab=jcfg.vocab)
        tickets.append(engine.submit_stream(session, ex.GEN))
        sessions.append(session)
        feeds.append(split_into_windows(events, ex.N_WIN, ex.WINDOW_US))
    for w in range(ex.N_WIN):
        for session, chunks in zip(sessions, feeds):
            session.stream.push(chunks[w])
        engine.step()
    for session in sessions:
        session.stream.close()
    out = engine.run()
    return ([np.asarray(s.prompt_tokens()) for s in sessions],
            [np.asarray(out[t.rid]) for t in tickets])


def test_serve_dvs_example_matches_reference():
    ex = _example("serve_dvs_torch")
    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               spiking_ffn=True, spiking_weight_density=0.3)
    assert dataclasses.asdict(ex.example_config()).items() >= {
        "spiking_ffn": True, "spiking_weight_density": 0.3,
        "spiking_T": jcfg.spiking_T}.items()
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    got = ex.run("cpu", params=bridge.params_from_reference(_np(jp)),
                 log=lambda _: None)
    want_frames, want_tokens = _reference_dvs(ex, jm, jp, jcfg)
    if any(not np.array_equal(g, w) for g, w in zip(got["tokens"], want_tokens)):
        want_frames, want_tokens = _reference_dvs(ex, jm, jp, jcfg, jit=False)
    for g, w in zip(got["frame_tokens"], want_frames):
        np.testing.assert_array_equal(np.asarray(g), w)
    for g, o, w in zip(got["tokens"], got["one_shot"], want_tokens):
        np.testing.assert_array_equal(g, o)   # incremental == one-shot
        np.testing.assert_array_equal(g, w)   # == the reference engine
    s = got["summary"]
    assert s["stream_sessions"] == 2 and s["stream_windows"] == 2 * ex.N_WIN
    assert s["timesteps_skipped"] > 0  # the silent window's planes


def test_spiking_ffn_llm_example_learns_from_the_reference_state():
    ex = _example("spiking_ffn_llm_torch")
    cfg = ex.example_config()
    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               n_layers=3, d_model=128, d_ff=256,
                               spiking_ffn=True, spiking_T=4,
                               spiking_weight_density=0.2)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.spiking_T,
            cfg.spiking_weight_density) == (3, 128, 256, 4, 0.2)
    jm = j_build(jcfg)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0))
    state = bridge.train_state_from_reference(_np(jstate))
    batch = {k: jnp.asarray(v) for k, v in JData(jcfg, 64, 8).batch(0).items()}
    _, jmetrics = jax.jit(j_make_train_step(jm))(jstate, batch)
    want = float(jmetrics["loss"])

    out = ex.run(steps=8, device="cpu", state=state, log=lambda _: None)
    losses = out["losses"]
    assert all(np.isfinite(losses))
    assert abs(losses[0] - want) <= LOSS_RTOL * abs(want), (losses[0], want)
    assert losses[-1] < losses[0], losses
