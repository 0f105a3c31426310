"""The port's preemption drain, handoff and resume (`Engine.drain`,
`Engine.resume`, `serve/handoff.py`, the scheduler's drain lane) against
the JAX reference's, on the CPU at smoke size: the single-device cells of
`tests/test_serve_handoff.py`.

Both packages get the reference's params (`repro_torch.bridge`); the model
is the main path, llama3.2-1b smoke with dual-sparse spiking FFNs.  Held:
* drain -> save -> load -> resume returns every request's tokens equal to
  an undisturbed port serve and to the reference's own drain -> resume of
  the same schedule (greedy tokens identical), under sync and pipelined
  execution over dense and paged caches, and no token the victim emitted
  is lost (the resume ledger in `Engine._finish` raises otherwise);
* the ledger raises `ParityError` on a tampered handoff;
* SIGTERM closes admission (``draining`` rejections), `run()` returns
  early, the scheduler's drained tickets are terminal and leave its map,
  `PreemptionHandler.restore` is idempotent, and a handoff survives a
  save/load round trip.

The reference's mesh cells run on a mesh of logical CPU devices
(`launch.mesh`): the ``meshed`` column of ``test_drain_resume_token_identity``
is ``test_drain_resume_token_identity_meshed`` (a data=2 x model=2 victim
resumed on another mesh, data=1 x model=2), and
``test_plan_serve_mesh_shapes``, ``test_remesh_paged_identity_zero_page_moves``,
``test_remesh_to_single_device_dense_identity`` and
``test_straggler_observation_triggers_repack_identity_kept`` are ported
under their names.  The reference's engine is not run on a mesh (it aborts
in JAX's CPU gather): the meshed port is held to its single-device serve
and to the reference's single-device drain -> resume.
"""
import dataclasses
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.ft import PreemptionHandler as JPreemption
from repro.models.registry import build_model as j_build
from repro.serve import Engine as JEngine
from repro.serve import ExecutionPolicy as JPolicy
from repro.serve import Handoff as JHandoff
from repro.serve import paged as j_paged
from repro_torch import bridge
from repro_torch.ft import PreemptionHandler
from repro_torch.ft.elastic import plan_serve_mesh
from repro_torch.launch.mesh import LogicalDevice
from repro_torch.launch.serve import build_config
from repro_torch.models.registry import build_model as t_build
from repro_torch.serve import (
    AdmissionError,
    Engine,
    ExecutionPolicy,
    Handoff,
    HandoffRequest,
    ParityError,
    Placement,
    Scheduler,
    make_serve_mesh,
    paged,
)

torch.set_num_threads(1)

GEN = 8
N_PROMPTS = 5


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(smoke_variant(get_config("llama3_2_1b")),
                               spiking_ffn=True, spiking_weight_density=0.3)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = build_config("llama3_2_1b", smoke=True, spiking=True,
                        weight_density=0.3)
    tm = t_build(tcfg)
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp))
    return (jcfg, jm, jp), (tcfg, tm, tp)


def _prompts(vocab, n=N_PROMPTS, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(length,)).astype(np.int32)
            for _ in range(n)]


CPU8 = [LogicalDevice(i, torch.device("cpu")) for i in range(8)]


def _policy(cfg, execution="sync", paging=False, mesh=None):
    placement = Placement(mesh=make_serve_mesh(mesh, devices=CPU8)
                          if mesh else None)
    return ExecutionPolicy.for_arch(cfg, execution=execution,
                                    paging=paged(8) if paging else None,
                                    placement=placement)


def _jpolicy(cfg, execution="sync", paging=False):
    return JPolicy.for_arch(cfg, execution=execution,
                            paging=j_paged(8) if paging else None)


def _cycle(path, make_victim, make_successor, handoff_cls, prompts,
           *, steps=2, step_budget=2, tamper=None):
    """Submit the prompts, preempt after ``steps`` steps, drain within
    ``step_budget``, save and reload the handoff, resume a successor and run
    it.  Returns (successor outputs by rid, the victim's handoff)."""
    victim, handler = make_victim()
    tickets = [victim.submit(p, GEN) for p in prompts]
    for _ in range(steps):
        victim.step()
    handler.trigger()
    handoff = victim.drain(step_budget=step_budget)
    assert victim.scheduler._tickets == {}       # no ticket left in the map
    c = handoff.counts()
    assert c["waiting"] + c["inflight"] + c["finished"] == len(prompts)
    handoff.save(str(path))
    loaded = handoff_cls.load(str(path))
    assert loaded.counts() == c
    if tamper is not None:
        tamper(loaded)
    out = make_successor(loaded).run()
    assert sorted(out) == sorted(t.rid for t in tickets)
    return out, handoff


def _port_cycle(models, path, execution="sync", paging=False, **kw):
    tcfg, tm, tp = models[1]
    policy = _policy(tcfg, execution, paging)

    def victim():
        h = PreemptionHandler(signals=())
        return Engine(tm, tp, max_len=16, max_slots=2, policy=policy,
                      preemption=h, device="cpu"), h

    def successor(loaded):
        return Engine.resume(tm, tp, loaded, policy=policy, device="cpu")

    return _cycle(path, victim, successor, Handoff, _prompts(tcfg.vocab), **kw)


_REFERENCE = {}


def _reference_cycle(models, path, execution, paging):
    """The reference's drain -> resume of the same schedule (cached per
    cell)."""
    key = (execution, paging)
    if key not in _REFERENCE:
        jcfg, jm, jp = models[0]
        policy = _jpolicy(jcfg, execution, paging)

        def victim():
            h = JPreemption(signals=())
            return JEngine(jm, jp, max_len=16, max_slots=2, policy=policy,
                           preemption=h), h

        def successor(loaded):
            return JEngine.resume(jm, jp, loaded, policy=policy)

        _REFERENCE[key] = _cycle(path, victim, successor, JHandoff,
                                 _prompts(jcfg.vocab))
    return _REFERENCE[key]


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging", [False, True], ids=["dense", "paged"])
def test_drain_resume_token_identity(models, tmp_path, execution, paging):
    """Preempt mid-serve, drain within a step budget, hand off, resume: the
    successor's results (partly served requests too) equal an undisturbed
    port serve and the reference's drain -> resume, token for token, and
    every token the victim emitted survives (the ledger would raise)."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab)
    want = Engine(tm, tp, max_len=16, max_slots=2, device="cpu",
                  policy=_policy(tcfg, execution, paging)
                  ).generate_batch(prompts, GEN)
    out, handoff = _port_cycle(models, tmp_path / "port", execution, paging)
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(out[rid], w)
    ref_out, ref_handoff = _reference_cycle(models, tmp_path / "ref",
                                            execution, paging)
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(out[rid], ref_out[rid])
    # the grace carried live progress, not only queue state, and both
    # engines handed off the same request states
    c = handoff.counts()
    assert c["tokens_in_flight"] > 0
    assert c == ref_handoff.counts()
    assert ([(r.rid, r.state) for r in handoff.requests]
            == [(r.rid, r.state) for r in ref_handoff.requests])


@pytest.mark.parametrize("execution", ["sync", "pipelined"])
@pytest.mark.parametrize("paging", [False, True], ids=["dense", "paged"])
def test_drain_resume_token_identity_meshed(models, tmp_path, execution,
                                            paging):
    """The reference's ``meshed`` column: a victim serving on a data=2 x
    model=2 mesh drains, and its successor resumes on another mesh
    (data=1 x model=2); the results equal the undisturbed single-device
    serve and the reference's drain -> resume, token for token."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab)
    want = Engine(tm, tp, max_len=16, max_slots=2, device="cpu",
                  policy=_policy(tcfg, execution, paging)
                  ).generate_batch(prompts, GEN)
    victim_policy = _policy(tcfg, execution, paging, mesh="data=2,model=2")
    successor_policy = _policy(tcfg, execution, paging, mesh="data=1,model=2")

    def victim():
        h = PreemptionHandler(signals=())
        return Engine(tm, tp, max_len=16, max_slots=2, policy=victim_policy,
                      preemption=h, device="cpu"), h

    def successor(loaded):
        eng = Engine.resume(tm, tp, loaded, policy=successor_policy,
                            device="cpu")
        assert eng.summary()["mesh"] == "data=1xmodel=2"
        return eng

    out, handoff = _cycle(tmp_path / "port", victim, successor, Handoff,
                          prompts)
    ref_out, _ = _reference_cycle(models, tmp_path / "ref", execution, paging)
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(out[rid], ref_out[rid])
    assert handoff.counts()["tokens_in_flight"] > 0


def test_plan_serve_mesh_shapes():
    from repro.ft.elastic import plan_serve_mesh as j_plan_serve_mesh

    jdevs = jax.devices()
    for n, mp in ((8, 2), (6, 2), (5, 2), (3, 4), (1, 1), (8, 1)):
        got = plan_serve_mesh(CPU8[:n], model_parallel=mp)
        want = j_plan_serve_mesh(jdevs[:n], model_parallel=mp)
        if want is None:
            assert got is None
        else:
            assert got.shape == dict(want.shape)
            assert [d.id for d in got.devices.flat] == \
                [d.id for d in want.devices.flat]
    assert plan_serve_mesh(CPU8, model_parallel=2).shape == \
        {"data": 4, "model": 2}
    assert plan_serve_mesh(CPU8[:5], model_parallel=2).shape == \
        {"data": 2, "model": 2}  # idles the fifth
    assert plan_serve_mesh(CPU8[:1]) is None
    with pytest.raises(ValueError):
        plan_serve_mesh([])


def _remesh_run(models, policy, remesh_to, n=4):
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, n=n)
    want = Engine(tm, tp, max_len=16, max_slots=4, device="cpu",
                  policy=_policy(tcfg)).generate_batch(prompts, GEN)
    eng = Engine(tm, tp, max_len=16, max_slots=4, policy=policy,
                 device="cpu")
    tickets = [eng.submit(p, GEN) for p in prompts]
    for _ in range(3):
        eng.step()
    moves = eng.metrics.n_page_moves
    rep = eng.remesh(devices=remesh_to)
    assert eng.metrics.n_page_moves == moves
    out = eng.run()
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(out[t.rid], w)
    return rep, eng


def test_remesh_paged_identity_zero_page_moves(models):
    """Device loss mid-serve: re-plan to 6 survivors, re-place params and
    plan slabs live and keep serving: tokens stay those of the
    single-device serve, and not one cache page is copied."""
    tcfg = models[1][0]
    rep, eng = _remesh_run(models, _policy(tcfg, paging=True,
                                           mesh="data=4,model=2"), CPU8[:6])
    assert rep["remeshed"] and rep["mesh"] == "data=3xmodel=2"
    assert eng.metrics.n_remeshes == 1
    assert eng.summary()["remeshes"] == 1
    plan = eng.params["layers"][0]["mlp"]["plan_in"]
    assert plan.shards == 2


def test_remesh_to_single_device_dense_identity(models):
    """Total mesh loss: fold back to single-device serving mid-flight."""
    tcfg, tm, tp = models[1]
    rep, eng = _remesh_run(models, _policy(tcfg, mesh="data=4,model=2"),
                           CPU8[:1])
    assert rep["remeshed"] and rep["mesh"] is None and eng.mesh is None
    # the same survivors again: a no-op
    assert not eng.remesh(devices=CPU8[:1])["remeshed"]
    assert "plan_in" in eng.params["layers"][0]["mlp"]
    assert eng.params["layers"][0]["mlp"]["plan_in"].payload.ndim == 3


def test_straggler_observation_triggers_repack_identity_kept(models):
    """Feeding the pipelined executor's `StepTimer` a straggling decode
    sample forces a re-pack on the next step (on a data=4 x model=2 mesh:
    the three live rows re-pad to four); served tokens are unchanged."""
    tcfg, tm, tp = models[1]
    prompts = _prompts(tcfg.vocab, n=3)
    want = Engine(tm, tp, max_len=16, max_slots=4, device="cpu",
                  policy=_policy(tcfg)).generate_batch(prompts, GEN)
    eng = Engine(tm, tp, max_len=16, max_slots=4, device="cpu",
                 policy=_policy(tcfg, "pipelined", mesh="data=4,model=2"))
    tickets = [eng.submit(p, GEN) for p in prompts]
    eng.step()
    for _ in range(6):                           # build the timing window
        eng.executor.step_timer.observe(0.01)
    eng.executor.step_timer.observe(0.5)         # 50x the median
    assert eng.metrics.n_straggler_events == 1
    assert eng.executor._force_repack
    eng.step()                                   # the re-pack takes the flag
    assert not eng.executor._force_repack
    assert eng.metrics.n_rebalances >= 1
    out = eng.run()
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(out[t.rid], w)


def test_resume_parity_ledger_detects_lost_tokens(models, tmp_path):
    """A tampered in-flight progress makes the successor's replay raise
    `ParityError`: a lost or corrupted token is an error, never a silent
    truncation."""
    def tamper(loaded):
        hr = next(r for r in loaded.requests
                  if r.state == "inflight" and r.generated.size)
        hr.generated = hr.generated + 1          # every carried token wrong

    with pytest.raises(ParityError, match="handed-off"):
        _port_cycle(models, tmp_path, tamper=tamper)


def test_resume_ledger_holds_every_inflight_request(models, tmp_path):
    """The successor's ledger holds each in-flight request with its
    handed-off tokens until the replay finishes it, then is empty; finished
    results are preloaded, not counted again."""
    tcfg, tm, tp = models[1]
    policy = _policy(tcfg)
    h = PreemptionHandler(signals=())
    victim = Engine(tm, tp, max_len=16, max_slots=2, policy=policy,
                    preemption=h, device="cpu")
    for p in _prompts(tcfg.vocab):
        victim.submit(p, GEN)
    for _ in range(2):
        victim.step()
    h.trigger()
    handoff = victim.drain(step_budget=2)
    succ = Engine.resume(tm, tp, handoff, policy=policy, device="cpu")
    inflight = {r.rid: r.generated for r in handoff.requests
                if r.state == "inflight"}
    assert inflight and set(succ._resume_expect) == set(inflight)
    for rid, gen in inflight.items():
        np.testing.assert_array_equal(succ._resume_expect[rid], gen)
    finished = [r.rid for r in handoff.requests if r.state == "finished"]
    assert set(finished) <= set(succ.results)
    succ.run()
    assert succ._resume_expect == {}
    assert succ.summary()["n_requests"] == N_PROMPTS - len(finished)


def test_sigterm_closes_admission_and_drains(models):
    """A real SIGTERM flips `should_stop`; the next step closes admission
    (submits get a ``draining`` rejection ticket) and drain hands the engine
    off."""
    tcfg, tm, tp = models[1]
    h = PreemptionHandler()                      # installs a real handler
    try:
        eng = Engine(tm, tp, max_len=16, max_slots=2, policy=_policy(tcfg),
                     preemption=h, device="cpu")
        prompts = _prompts(tcfg.vocab, n=3)
        for p in prompts:
            eng.submit(p, GEN)
        eng.step()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and eng.stopping
        eng.step()                               # closes admission
        assert eng.scheduler.closed
        with pytest.raises(AdmissionError) as exc:
            eng.submit(prompts[0], GEN)
        assert exc.value.ticket.outcome == "rejected"
        assert str(exc.value).startswith("draining")
        assert eng.summary()["admission_closed"]
        handoff = eng.drain()
        c = handoff.counts()
        assert c["finished"] + c["waiting"] + c["inflight"] == 3
        assert eng.summary()["drained_requests"] == c["waiting"] + c["inflight"]
    finally:
        h.restore()                              # never leave SIGTERM hooked
    assert signal.getsignal(signal.SIGTERM) != h._handler


def test_run_returns_early_on_preemption_notice(models):
    tcfg, tm, tp = models[1]
    h = PreemptionHandler(signals=())
    eng = Engine(tm, tp, max_len=16, max_slots=4, policy=_policy(tcfg),
                 preemption=h, device="cpu")
    for p in _prompts(tcfg.vocab, n=2):
        eng.submit(p, GEN)
    h.trigger()
    assert eng.run() == {}                       # returns, does not serve
    assert not eng.idle and eng.stopping


def test_scheduler_drain_tickets_terminal_and_map_empty():
    """Never-admitted requests leave the ticket map at drain with the
    terminal ``drained`` outcome; a closed scheduler schedules nothing and
    rejects submits and streams with a ``draining`` reason."""
    s = Scheduler(max_slots=2, max_queue=8, max_len=64)
    tickets = [s.submit(np.zeros(8, np.int32), 4) for _ in range(4)]
    s.next_prefill_group()                       # admits 2, pops their tickets
    popped = s.drain()
    assert [t.outcome for t in tickets] == \
        ["admitted", "admitted", "drained", "drained"]
    assert [t.rid for _req, t in popped] == [2, 3]
    assert s._tickets == {}
    assert s.closed and s.next_prefill_group() == []
    assert s.schedule_prefix_hits() == [] and s.schedule_streams() == []
    with pytest.raises(AdmissionError, match="draining"):
        s.submit(np.zeros(8, np.int32), 4)
    with pytest.raises(AdmissionError, match="draining"):
        s.submit_stream(object(), 4)
    assert s.n_rejected == 2


def test_scheduler_restore_keeps_rid_and_skips_capacity():
    """`restore` re-queues under the handed-off rid without the capacity
    checks a submit runs; `reserve_ids` moves new rids past the restored
    ones."""
    s = Scheduler(max_slots=1, max_queue=1, max_len=16)
    from repro_torch.serve import Request

    for rid in (7, 3):
        # a full queue and a prompt a submit would refuse: restored anyway
        s.restore(Request(rid, np.zeros(12, np.int32), 8))
    s.reserve_ids(8)
    assert [r.rid for r in s.waiting] == [7, 3]
    s2 = Scheduler(max_slots=1, max_queue=4, max_len=16)
    s2.reserve_ids(8)
    assert s2.submit(np.zeros(4, np.int32), 4).rid == 8


def test_preemption_restore_idempotent_and_off_main_thread():
    h = PreemptionHandler()
    prev = signal.getsignal(signal.SIGTERM)
    assert prev == h._handler
    h.restore()
    installed = signal.getsignal(signal.SIGTERM)
    h.restore()                                  # a second restore: no-op
    assert signal.getsignal(signal.SIGTERM) is installed
    assert h._old == {}

    errors = []

    def off_main():
        try:
            hh = PreemptionHandler()             # the ValueError guard path
            assert hh._old == {}                 # nothing installed there
            hh.trigger()
            assert hh.should_stop
            hh.restore()
            hh.restore()
        except Exception as e:                   # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=off_main)
    t.start()
    t.join()
    assert errors == []


def test_handoff_save_load_round_trip(tmp_path):
    """Every request state, its arrays and scalars, the prefix keys and the
    meta survive a save/load; the reference loads the port's handoff too
    (the same layout: manifest, one .npy per array, handoff.json)."""
    reqs = [
        HandoffRequest(0, np.arange(5, dtype=np.int32), 4, "finished",
                       np.asarray([9, 8, 7, 6], np.int32), "length"),
        HandoffRequest(3, np.arange(3, dtype=np.int32), 6, "inflight",
                       np.asarray([1, 2], np.int32)),
        HandoffRequest(4, np.arange(7, dtype=np.int32), 2, "waiting",
                       prefix_hit=True),
    ]
    h = Handoff(reqs, [np.arange(8, dtype=np.int32)],
                {"max_len": 16, "max_slots": 2, "max_queue": 4,
                 "bucket_align": 1, "eos_id": None, "arch": "x",
                 "policy": "p"})
    path = h.save(str(tmp_path))
    assert os.path.isdir(path) and not os.path.exists(path + ".tmp")
    for loaded in (Handoff.load(str(tmp_path)), JHandoff.load(str(tmp_path))):
        assert loaded.meta == h.meta and loaded.max_rid == 4
        assert loaded.counts() == {"waiting": 1, "inflight": 1, "finished": 1,
                                   "prefix_keys": 1, "tokens_in_flight": 2}
        for a, b in zip(loaded.requests, reqs):
            assert (a.rid, a.max_new_tokens, a.state, a.finish_reason,
                    a.prefix_hit) == (b.rid, b.max_new_tokens, b.state,
                                      b.finish_reason, b.prefix_hit)
            np.testing.assert_array_equal(a.prompt, b.prompt)
            np.testing.assert_array_equal(a.generated, b.generated)
        np.testing.assert_array_equal(loaded.prefix_keys[0], np.arange(8))


def test_cli_preempt_then_resume_verified(tmp_path, capsys):
    """The serve CLI's five flags: ``--preempt-after`` drains into
    ``--handoff-path`` within ``--drain-grace``; ``--resume
    --verify-resume`` finishes every request identical to an undisturbed
    engine; ``--stream`` with a handoff flag and ``--resume`` without a
    path are refused, as in the reference launcher."""
    from repro_torch.launch.serve import main

    base = ["--arch", "llama3_2_1b", "--smoke", "--spiking",
            "--weight-density", "0.3", "--batch", "4", "--max-slots", "2",
            "--prompt-len", "8", "--gen", "6", "--device", "cpu",
            "--handoff-path", str(tmp_path)]
    assert main(base + ["--preempt-after", "3", "--drain-grace", "1"]) == 0
    out = capsys.readouterr().out
    assert "preempted after 3 steps" in out and "2 waiting" in out
    assert Handoff.load(str(tmp_path)).counts()["tokens_in_flight"] > 0
    assert main(base + ["--resume", "--verify-resume"]) == 0
    out = capsys.readouterr().out
    assert "resume identity: 4 requests token-identical" in out
    with pytest.raises(SystemExit, match="--stream does not compose"):
        main(base + ["--stream"])
    with pytest.raises(SystemExit, match="requires --handoff-path"):
        main(base[:-2] + ["--resume"])
