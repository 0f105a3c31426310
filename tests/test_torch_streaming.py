"""The port's event-stream front end (`repro_torch.serve.streaming`, the
scheduler's stream lane, the executor's ingest) against the JAX
reference's, on the CPU at smoke size: the single-device cases of
`tests/test_serve_streaming.py`.

Held:
* `EventStream` (watermarks, gap windows, ordering, close, backpressure,
  idle timeout, validation), `StreamSession` (frames, crc32 frame tokens,
  frame budget), the event generators and `encode_event_window` give the
  reference's values on the same events, bit for bit (the encoder through
  direct calls: the reference's Hypothesis tests of it fail on this host,
  ROADMAP §3);
* the scheduler lane: admission on the first window, one session per
  free slot, terminal rejection of a stream that closed with no frame;
* frame-by-frame ingestion gives the tokens of submitting the same frame
  tokens as one prompt, bit for bit, across {sync, pipelined} x {dense,
  paged} x {full, adaptive}, and the reference engine's tokens for that
  prompt (this model has no near tie there; the rule that would admit one
  is `test_torch_speculative._hold_to_reference`'s);
* streams interleaved with plain requests, the T check, the frame budget,
  a flush that must not land the go-live candidate, and the idle step.

The reference's zero-retrace check becomes: after the first session, a
second one builds no join plan and no kernel (the port does not trace).
The ``mesh`` cells of ``test_stream_token_identity_matrix`` are
``test_stream_token_identity_matrix_mesh``, on a data=4 x model=2 mesh of
logical CPU devices (`launch.mesh`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.core.packing import encode_event_window as j_encode
from repro.data import events as j_events
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import streaming as j_streaming
from repro_torch import bridge
from repro_torch.core.packing import encode_event_window, timestep_popcount
from repro_torch.data import events as t_events
from repro_torch.data.events import moving_blob_events, split_into_windows
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.launch.serve import build_config
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    AdmissionError,
    Backpressure,
    Engine,
    EventStream,
    ExecutionPolicy,
    Placement,
    StreamSession,
    adaptive_t,
    make_serve_mesh,
    paged,
)
from repro_torch.serve import streaming as t_streaming
from repro_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

H, W = 8, 8            # sensor extent: only the frame TOKEN enters the model
WINDOW_US = 1000
N_WIN = 4
MAX_NEW = 6


def _ev(x, y, p, t):
    return np.asarray([[x, y, p, t]], np.int64)


def _both(fn):
    """Run ``fn(streaming_module)`` on the port and on the reference."""
    return fn(t_streaming), fn(j_streaming)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


# ---------------------------------------------------------------------------
# EventStream: watermarks, ordering, backpressure, idle timeout
# ---------------------------------------------------------------------------

def test_eventstream_watermark_semantics():
    def run(m):
        s, seen = m.EventStream(WINDOW_US), []
        s.push(_ev(1, 1, 0, 10))
        # window 0 is still open: an event at t=999 could still arrive
        seen += [s.n_complete, s.pop_window()]
        s.push(_ev(2, 2, 1, WINDOW_US + 5))  # a later-window event seals 0
        seen += [s.n_complete, s.pop_window(), s.pop_window()]
        s.close()                            # end of stream: all complete
        seen += [s.n_complete, s.pop_window(), s.exhausted]
        return seen

    got, want = _both(run)
    _same(got, want)
    assert got[0] == 0 and got[1] is None and got[2] == 1
    assert got[3].shape == (1, 4) and int(got[3][0, 3]) == 10
    assert got[4] is None and got[5] == 2 and got[7] is True
    assert int(got[6][0, 3]) == WINDOW_US + 5


def test_eventstream_gap_windows_come_back_empty():
    def run(m):
        s = m.EventStream(WINDOW_US)
        s.push(_ev(0, 0, 0, 50))
        s.push(_ev(3, 3, 1, 3 * WINDOW_US + 1))  # windows 0..2 complete
        return [s.n_complete] + [s.pop_window() for _ in range(4)]

    got, want = _both(run)
    _same(got, want)
    assert got[0] == 3 and got[1].shape == (1, 4)
    assert got[2].shape == got[3].shape == (0, 4) and got[4] is None


def test_eventstream_rejects_out_of_order_push_and_push_after_close():
    for m in (t_streaming, j_streaming):
        s = m.EventStream(WINDOW_US)
        s.push(_ev(0, 0, 0, 5000))
        with pytest.raises(ValueError, match="out-of-order"):
            s.push(_ev(0, 0, 0, 100))
        with pytest.raises(ValueError, match="negative"):
            m.EventStream(WINDOW_US).push(_ev(0, 0, 0, -1))
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            s.push(_ev(0, 0, 0, 6000))


def test_eventstream_backpressure_on_buffered_windows():
    def run(m):
        s = m.EventStream(WINDOW_US, max_buffered_windows=2)
        s.push(_ev(0, 0, 0, 10))
        before = s.n_events
        with pytest.raises(m.Backpressure) as e:
            s.push(_ev(0, 0, 0, 10 * WINDOW_US))  # would buffer 10 windows
        assert s.n_events == before  # a rejected push leaves no state
        while s.pop_window() is not None:  # consuming relieves the pressure
            pass
        s.push(_ev(0, 0, 0, 2 * WINDOW_US + 1))  # now only 2 complete: fine
        return [str(e.value), s.n_events, s.n_complete, s.consumed]

    got, want = _both(run)
    _same(got, want)
    assert issubclass(Backpressure, RuntimeError)


def test_eventstream_idle_timeout_tick_is_deterministic():
    def run(m):
        s, seen = m.EventStream(WINDOW_US, idle_timeout_us=500), []
        s.push(_ev(0, 0, 0, 100))
        s.tick(400)                  # 300 us of silence: still open
        seen.append(s.closed)
        s.tick(600)                  # 500 us past the last event: closes
        seen += [s.closed, s.n_complete]
        empty = m.EventStream(WINDOW_US, idle_timeout_us=500)
        empty.tick(499)              # an event-less stream times out
        seen.append(empty.closed)    # against creation time 0
        empty.tick(500)
        seen += [empty.closed, empty.n_complete]
        return seen

    got, want = _both(run)
    _same(got, want)
    assert got == [False, True, 1, False, True, 0]


@pytest.mark.parametrize("kw", [{"window_us": 0},
                                {"window_us": 100, "idle_timeout_us": 0},
                                {"window_us": 100, "max_buffered_windows": 0}])
def test_eventstream_validation(kw):
    for m in (t_streaming, j_streaming):
        with pytest.raises(ValueError):
            m.EventStream(**kw)


# ---------------------------------------------------------------------------
# event generators and the window encoder, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_event_generators_match_reference(seed):
    for name, kw in (("moving_blob_events", {"silent": (1, 4)}),
                     ("rate_coded_events", {"rate": 0.2})):
        got = getattr(t_events, name)(6, height=H, width=W, seed=seed, **kw)
        want = getattr(j_events, name)(6, height=H, width=W, seed=seed, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64 and got.shape[1] == 4
        for a, b in zip(split_into_windows(got, 6, WINDOW_US),
                        j_events.split_into_windows(want, 6, WINDOW_US)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        moving_blob_events(0)


def _encode_cases():
    rng = np.random.default_rng(5)
    n = 200
    ev = np.stack([rng.integers(-2, W + 2, n), rng.integers(-2, H + 2, n),
                   rng.integers(0, 2, n), rng.integers(-50, 2 * WINDOW_US, n)],
                  axis=1).astype(np.int64)
    edges = np.asarray([[0, 0, 0, 1000], [1, 0, 1, 1999], [2, 0, 0, 1250],
                        [2, 0, 0, 1250], [7, 7, 1, 1749], [3, 3, 0, 999]],
                       np.int64)
    return [(ev, 4, 0), (ev, 4, 1000), (ev, 16, 1000), (edges, 4, 1000),
            (edges, 32, 1000), (np.zeros((0, 4), np.int64), 4, 0)]


@pytest.mark.parametrize("case", range(6))
def test_encode_event_window_bitwise(case):
    """Out-of-window and off-sensor events ignored, boundary times binned
    as the reference bins them, duplicates idempotent, T up to 32, the
    empty window all silent."""
    ev, T, t0 = _encode_cases()[case]
    got = encode_event_window(ev, H, W, T, WINDOW_US, t0=t0)
    want = np.asarray(j_encode(jnp.asarray(ev), H, W, T, WINDOW_US, t0=t0))
    assert got.dtype == torch.int32 and got.shape == (H * W,)
    np.testing.assert_array_equal(bridge.words_to_numpy(got), want)
    if ev.shape[0] == 0:
        assert int(got.abs().sum()) == 0


def test_encode_event_window_validation():
    for fn in (encode_event_window, j_encode):
        for args in ((H, W, 33, WINDOW_US), (0, W, 4, WINDOW_US),
                     (H, W, 4, 0)):
            with pytest.raises(ValueError):
                fn(np.zeros((0, 4), np.int64), *args)


# ---------------------------------------------------------------------------
# StreamSession: encoding, determinism, frame budget
# ---------------------------------------------------------------------------

def _session_run(m, chunks, vocab=997):
    s = m.EventStream(WINDOW_US)
    sess = m.StreamSession(s, height=H, width=W, T=4, vocab=vocab)
    for c in chunks:
        s.push(c)
        sess.poll()
    s.close()
    sess.poll()
    return sess


def test_stream_session_frames_and_tokens_match_reference():
    events = moving_blob_events(N_WIN, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=32, seed=3, silent=(1,))
    chunks = split_into_windows(events, N_WIN, WINDOW_US)
    a, b = _session_run(t_streaming, chunks), _session_run(t_streaming, chunks)
    ref = _session_run(j_streaming, chunks)
    assert len(a.frames) == N_WIN and a.delivered
    np.testing.assert_array_equal(a.prompt_tokens(), b.prompt_tokens())
    # crc32 frame tokens of the same bytes as the reference's uint32 words
    np.testing.assert_array_equal(a.prompt_tokens(), ref.prompt_tokens())
    for f, g in zip(a.frames, ref.frames):
        assert f.words.dtype == np.int32
        np.testing.assert_array_equal(f.words.view(np.uint32), g.words)
        assert (f.index, f.token, f.n_events) == (g.index, g.token, g.n_events)
    # the silent window's frame: zero events, all-silent words
    gap = a.frames[1]
    assert gap.n_events == 0 and (gap.words == 0).all()
    assert (timestep_popcount(torch.from_numpy(gap.words), 4) == 0).all()
    assert all(0 <= f.token < 997 for f in a.frames)


def test_stream_session_frame_budget_backpressure():
    events = moving_blob_events(4, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=8, seed=5)

    def run(m):
        s = m.EventStream(WINDOW_US)
        sess = m.StreamSession(s, height=H, width=W, T=4, vocab=97)
        sess.max_frames = 2
        s.push(events)
        s.close()
        with pytest.raises(m.Backpressure, match="frame budget"):
            sess.poll()
        return [len(sess.frames), list(sess.prompt_tokens())]

    got, want = _both(run)
    _same(got, want)
    assert got[0] == 2  # the frames up to the budget stand


@pytest.mark.parametrize("kw", [dict(height=0, width=4, T=4, vocab=10),
                                dict(height=4, width=4, T=0, vocab=10),
                                dict(height=4, width=4, T=4, vocab=0)])
def test_stream_session_validation(kw):
    for m in (t_streaming, j_streaming):
        with pytest.raises(ValueError):
            m.StreamSession(m.EventStream(WINDOW_US), **kw)


# ---------------------------------------------------------------------------
# scheduler stream lane
# ---------------------------------------------------------------------------

def _session(window_us=WINDOW_US, **kw):
    stream = EventStream(window_us, **kw)
    return stream, StreamSession(stream, height=H, width=W, T=4, vocab=97)


def test_scheduler_stream_lane_admits_on_first_window():
    sch = Scheduler(max_slots=1, max_queue=4, max_len=32)
    stream, sess = _session()
    ticket = sch.submit_stream(sess, 4)
    assert ticket.outcome == "queued" and sch.queue_depth == 1
    assert sch.schedule_streams() == []      # no complete window yet
    stream.push(_ev(1, 1, 0, WINDOW_US + 1))  # seals window 0
    sch.active_slots = 1                      # no free slot: stays queued
    assert sch.schedule_streams() == []
    sch.release(1)
    admitted = sch.schedule_streams()
    assert len(admitted) == 1 and admitted[0][0] is sess
    assert ticket.outcome == "admitted"
    assert sch.queue_depth == 0 and sch.active_slots == 1


def test_scheduler_rejects_stream_closed_with_no_frames():
    sch = Scheduler(max_slots=2, max_queue=4, max_len=32)
    stream, sess = _session()
    ticket = sch.submit_stream(sess, 4)
    stream.close()
    assert sch.schedule_streams() == []
    assert ticket.outcome == "rejected"
    assert "no frames" in ticket.reason
    assert sch.n_rejected == 1 and sch.queue_depth == 0


def test_submit_stream_admission_checks():
    sch = Scheduler(max_slots=2, max_queue=1, max_len=8)
    _, sess = _session()
    with pytest.raises(AdmissionError, match="max_len"):
        sch.submit_stream(sess, 8)           # 1 frame + 8 generated > 8
    with pytest.raises(AdmissionError):
        sch.submit_stream(sess, 0)
    sch.submit_stream(sess, 4)
    with pytest.raises(AdmissionError, match="queue full"):
        sch.submit_stream(_session()[1], 4)


# ---------------------------------------------------------------------------
# engine: the reference test file's model, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """llama3.2-1b smoke with spiking FFNs at T = 4 and weight density 0.3,
    the reference's params bridged to the port."""
    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               spiking_ffn=True, spiking_T=4,
                               spiking_weight_density=0.3)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                        weight_density=0.3)
    assert tcfg.spiking_T == 4
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


_REF: dict = {}


def _monolithic(models, prompt, max_new=MAX_NEW, policy=None):
    """Tokens of the one-prompt submission of ``prompt``: the port's plain
    sync/dense/full engine (every matrix cell is bitwise, so one reference
    serves them all) and the reference engine's, which must agree."""
    key = (tuple(int(t) for t in prompt), max_new)
    if key not in _REF:
        (jcfg, jm, jp), (tcfg, tm, tp) = models
        port = Engine(tm, tp, max_len=24, max_slots=4, device="cpu",
                      policy=ExecutionPolicy.for_arch(tcfg))
        want = port.generate_batch([np.asarray(prompt, np.int32)], max_new)[0]
        ref = JEngine(jm, jp, max_len=24, max_slots=4,
                      policy=JPolicy.for_arch(jcfg))
        jwant = ref.generate_batch([np.asarray(prompt, np.int32)], max_new)[0]
        np.testing.assert_array_equal(want, np.asarray(jwant))
        _REF[key] = want
    return _REF[key]


def _engine(models, max_len=24, **kw):
    tcfg, tm, tp = models[1]
    return Engine(tm, tp, max_len=max_len, max_slots=4, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg, **kw))


def _drive_stream(engine, *, seed, silent=(), n_win=N_WIN, max_new=MAX_NEW):
    """Submit a session and feed it one window per `step()` (the streaming
    driver's shape), then close it and drain."""
    cfg = engine.cfg
    events = moving_blob_events(n_win, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=32, seed=seed, silent=silent)
    stream = EventStream(WINDOW_US)
    session = StreamSession(stream, height=H, width=W, T=cfg.spiking_T,
                            vocab=cfg.vocab)
    ticket = engine.submit_stream(session, max_new)
    for chunk in split_into_windows(events, n_win, WINDOW_US):
        stream.push(chunk)
        engine.step()
    stream.close()
    out = engine.run()
    return ticket, session, out[ticket.rid]


@pytest.mark.parametrize("temporal", ["full", "adaptive"])
@pytest.mark.parametrize("paging", ["dense", "paged"])
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_stream_token_identity_matrix(models, execution, paging, temporal,
                                      monkeypatch):
    """Frame-by-frame delivery gives the tokens of the same frame tokens
    submitted as one prompt, in every cell; after a first session, a second
    one with other frames (other silent windows) builds no plan and no
    kernel."""
    from repro_torch.kernels import _build, join_plan

    engine = _engine(models, execution=execution,
                     paging=paged(8) if paging == "paged" else None,
                     temporal=adaptive_t() if temporal == "adaptive" else None)
    _drive_stream(engine, seed=1, silent=(2,))
    builds = []
    monkeypatch.setattr(join_plan, "build_weight_plan",
                        lambda *a, **kw: builds.append("plan"))
    monkeypatch.setattr(_build, "load", lambda *a, **kw: builds.append("kernel"))
    ticket, session, got = _drive_stream(engine, seed=2, silent=(1,))
    assert builds == []
    assert ticket.outcome == "admitted"
    assert len(session.frames) == N_WIN
    np.testing.assert_array_equal(
        got, _monolithic(models, session.prompt_tokens()))
    m = engine.metrics
    assert m.n_stream_sessions == 2 and m.n_stream_windows == 2 * N_WIN
    assert len(m.stream_frame_latency_s) == 2 * N_WIN
    s = engine.summary()
    assert s["frame_to_first_token_s_p50"] >= 0.0
    assert s["frame_to_first_token_s_p99"] >= s["frame_to_first_token_s_p50"]
    if temporal == "adaptive":
        # the silent window's frame is all-silent: every plane skipped
        assert int(m.timesteps_skipped) > 0


@pytest.mark.parametrize("temporal", ["full", "adaptive"])
@pytest.mark.parametrize("paging", ["dense", "paged"])
@pytest.mark.parametrize("execution", ["sync", "pipelined"])
def test_stream_token_identity_matrix_mesh(models, execution, paging,
                                           temporal, monkeypatch):
    """The matrix's ``mesh`` cells: a stream served on a data=4 x model=2
    mesh (its one-row cohort padded to the data axis, each row a data
    group, every FFN plan in two column slabs) gives the one-prompt
    tokens, and a second session builds no plan and no kernel."""
    from repro_torch.kernels import _build, join_plan

    mesh = make_serve_mesh("data=4,model=2", devices=[
        LogicalDevice(i, torch.device("cpu")) for i in range(8)])
    engine = _engine(models, execution=execution,
                     paging=paged(8) if paging == "paged" else None,
                     temporal=adaptive_t() if temporal == "adaptive" else None,
                     placement=Placement(mesh=mesh))
    _drive_stream(engine, seed=1, silent=(2,))
    builds = []
    monkeypatch.setattr(join_plan, "build_weight_plan",
                        lambda *a, **kw: builds.append("plan"))
    monkeypatch.setattr(_build, "load", lambda *a, **kw: builds.append("kernel"))
    ticket, session, got = _drive_stream(engine, seed=2, silent=(1,))
    assert builds == []
    assert ticket.outcome == "admitted"
    np.testing.assert_array_equal(
        got, _monolithic(models, session.prompt_tokens()))
    assert engine.summary()["mesh"] == "data=4xmodel=2"


def test_stream_logits_equal_the_monolithic_prompt(models):
    """With logits captured, the stream's go-live logits and every decode's
    equal the one-prompt serve's bit for bit: ingesting a frame at position
    p computes what a prefill computes there."""
    tcfg = models[1][0]
    engine = Engine(*models[1][1:], max_len=24, device="cpu",
                    capture_logits=True, policy=ExecutionPolicy.for_arch(tcfg))
    ticket, session, got = _drive_stream(engine, seed=4)
    mono = Engine(*models[1][1:], max_len=24, device="cpu", capture_logits=True,
                  policy=ExecutionPolicy.for_arch(tcfg))
    want = mono.generate_batch([session.prompt_tokens()], MAX_NEW)[0]
    np.testing.assert_array_equal(got, want)
    [tg], [tw] = engine.drain_logit_traces(), mono.drain_logit_traces()
    assert len(tg) == len(tw) == MAX_NEW
    for x, y in zip(tg, tw):
        np.testing.assert_array_equal(x, y)


def test_stream_interleaves_with_normal_requests(models):
    """A stream session and a plain request serve together: the ingesting
    cohort never merges with the decode cohort, and both give their solo
    tokens."""
    engine = _engine(models)
    tcfg = models[1][0]
    rng = np.random.default_rng(0)
    prompt = np.asarray(rng.integers(0, tcfg.vocab, size=(5,)), np.int32)
    t_req = engine.submit(prompt, MAX_NEW)
    events = moving_blob_events(N_WIN, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=32, seed=7)
    stream = EventStream(WINDOW_US)
    session = StreamSession(stream, height=H, width=W, T=tcfg.spiking_T,
                            vocab=tcfg.vocab)
    t_stream = engine.submit_stream(session, MAX_NEW)
    for chunk in split_into_windows(events, N_WIN, WINDOW_US):
        stream.push(chunk)
        engine.step()
    stream.close()
    out = engine.run()
    np.testing.assert_array_equal(out[t_req.rid], _monolithic(models, prompt))
    np.testing.assert_array_equal(
        out[t_stream.rid], _monolithic(models, session.prompt_tokens()))


def test_submit_stream_rejects_temporal_axis_mismatch(models):
    engine = _engine(models)
    bad = StreamSession(EventStream(WINDOW_US), height=H, width=W,
                        T=engine.cfg.spiking_T + 1, vocab=engine.cfg.vocab)
    with pytest.raises(ValueError, match="spiking_T"):
        engine.submit_stream(bad, 4)


def test_submit_stream_binds_frame_budget(models):
    engine = _engine(models)
    session = StreamSession(EventStream(WINDOW_US), height=H, width=W,
                            T=engine.cfg.spiking_T, vocab=engine.cfg.vocab)
    engine.submit_stream(session, MAX_NEW)
    assert session.max_frames == 24 - MAX_NEW


def test_flush_never_emits_the_go_live_candidate(models):
    """`Engine.flush()` mid-ingest must not land the pending go-live step:
    it is a candidate, not an emitted token (landing it would count the
    first token twice)."""
    engine = _engine(models, execution="pipelined")
    events = moving_blob_events(2, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=16, seed=9)
    chunks = split_into_windows(events, 2, WINDOW_US)
    stream = EventStream(WINDOW_US)
    session = StreamSession(stream, height=H, width=W,
                            T=engine.cfg.spiking_T, vocab=engine.cfg.vocab)
    ticket = engine.submit_stream(session, MAX_NEW)
    stream.push(chunks[0])
    engine.step()               # window 0 still open: the session waits
    assert engine.cohorts == []
    stream.push(chunks[1])
    engine.step()               # window 0 sealed: admitted, frame 0 in
    [cohort] = engine.cohorts
    assert cohort.stream is session and len(cohort.pending) == 1
    assert isinstance(cohort.pending[0].tokens, torch.Tensor)
    engine.flush()
    assert len(cohort.pending) == 1, "flush landed the go-live candidate"
    assert cohort.slots[0].generated == []
    stream.close()
    out = engine.run()
    np.testing.assert_array_equal(
        out[ticket.rid], _monolithic(models, session.prompt_tokens()))


def test_stream_cohort_never_speculates_while_ingesting(models):
    """Under a speculative policy an ingesting cohort only ingests; after
    go-live it speculates like any cohort, with the monolithic tokens."""
    from repro_torch.serve import draft

    tcfg = models[1][0]
    fd = ExecutionPolicy.for_arch(tcfg, spike_format="float",
                                  weight_sparsity="dense")
    engine = _engine(models, max_len=28, speculation=draft(fd, k=3))
    ticket, session, got = _drive_stream(engine, seed=6)
    np.testing.assert_array_equal(
        got, _monolithic(models, session.prompt_tokens()))
    assert engine.metrics.n_speculative_rounds > 0


def test_idle_step_is_guaranteed_noop(models):
    """Empty queue and no cohorts: `step()` dispatches nothing and records
    nothing (streaming drivers tick the engine between frames)."""
    from repro_torch.kernels import ftp_spmm

    engine = _engine(models, max_len=16)
    before = ftp_spmm.launch_counts()
    for _ in range(5):
        assert engine.step() == {"active": 0, "queued": 0, "cohorts": 0}
    assert ftp_spmm.launch_counts() == before
    m = engine.metrics
    assert m.stage_s == {} and m.wall_s == 0.0 and m.max_queue_depth == 0
    assert m.n_prefill_batches == 0 and m.n_decode_batches == 0


def test_drain_hands_off_mid_ingest_stream(models):
    """`Engine.drain()` with an ingesting cohort ends (its stream cannot
    close from inside the engine) and hands the frames completed so far off
    as the successor request's prompt; the reference's drain of the same
    stream hands off the same prompt, and the successor serves it as a
    plain request."""
    tcfg, tm, tp = models[1]
    jcfg, jm, jp = models[0]
    events = moving_blob_events(2, height=H, width=W, window_us=WINDOW_US,
                                events_per_window=16, seed=11)
    chunks = split_into_windows(events, 2, WINDOW_US)
    got = {}
    for name, mod, make in (
            ("port", t_streaming, lambda: Engine(
                tm, tp, max_len=24, device="cpu",
                policy=ExecutionPolicy.for_arch(tcfg))),
            ("ref", j_streaming, lambda: JEngine(
                jm, jp, max_len=24, policy=JPolicy.for_arch(jcfg)))):
        engine = make()
        stream = mod.EventStream(WINDOW_US)
        session = mod.StreamSession(stream, height=H, width=W,
                                    T=tcfg.spiking_T, vocab=tcfg.vocab)
        ticket = engine.submit_stream(session, MAX_NEW)
        stream.push(chunks[0])
        stream.push(chunks[1])      # seals window 0
        engine.step()               # admitted: frame 0 prefilled, stream open
        assert engine.cohorts and engine.cohorts[0].stream is session
        handoff = engine.drain()    # must not spin on the open stream
        [hr] = [r for r in handoff.requests if r.rid == ticket.rid]
        assert hr.state == "inflight" and hr.generated.size == 0
        np.testing.assert_array_equal(
            hr.prompt, session.prompt_tokens()[: hr.prompt.shape[0]])
        assert hr.prompt.shape[0] >= 1
        assert engine.metrics.n_drained == 1 and not engine.cohorts
        got[name] = (handoff, engine)
    np.testing.assert_array_equal(got["port"][0].requests[0].prompt,
                                  got["ref"][0].requests[0].prompt)
    handoff = got["port"][0]
    successor = Engine.resume(tm, tp, handoff, device="cpu",
                              policy=ExecutionPolicy.for_arch(tcfg))
    out = successor.run()
    want = Engine(tm, tp, max_len=24, device="cpu",
                  policy=ExecutionPolicy.for_arch(tcfg)).generate_batch(
        [handoff.requests[0].prompt], MAX_NEW)[0]
    np.testing.assert_array_equal(out[handoff.requests[0].rid], want)
