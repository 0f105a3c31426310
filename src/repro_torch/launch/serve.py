"""Serving launcher of the port: the continuous-batching engine over the
dense transformer family, the MoE ones (``--arch phi3_5_moe``, ``--arch
mixtral_8x22b``: no cohort merges and no batch padding, capacity routing
couples a batch's rows) and the recurrent ones (``--arch rwkv6_1_6b``,
``--arch zamba2_7b``), on the CUDA device by default.  hubert-xlarge is
encoder-only and refused; llava's stub front end needs image embeddings,
which token requests do not carry.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
        --spiking --weight-density 0.3 --batch 4 --prompt-len 128 --gen 16

``--smoke`` shrinks the arch to the CPU test size; ``--device cpu`` runs the
kernels' plain torch versions.  Params are drawn with a torch generator
on the device (seed 0).  `generate` is the single-shot greedy loop
the engine is held token-identical against.

Policy flags: ``--spike-format float`` serves a spiking arch's FFNs on
the float path (FLOAT_DENSE); ``--weight-sparsity dense`` serves them
through the dense-weight kernels instead of the dual-sparse one;
``--temporal adaptive --min-spikes N`` adds the temporal axis (N > 1 drops
real spikes and needs ``--exactness approximate --tol X``: the launcher
then serves a bitwise reference engine too and reports the measured logit
drift against the bound); ``--execution pipelined --pipeline-depth D``
keeps the sampled tokens on the device behind a window of D steps;
``--paging paged --page-size N`` stores the KV cache in N-position pages
with radix prefix reuse (max_len is rounded up to a multiple of N).
``--batch-align`` pads prefill batches to a multiple of it.

Mesh serving: ``--mesh data,model`` (or ``data=4,model=2``, ``4,2``)
serves on a (data, model) mesh of logical devices under the bitwise
(reduction-free) placement: the same tokens as the unsharded serve.
``--fake-devices N`` makes N logical devices, mapped round-robin onto the
process's physical devices (the CPU with ``--device cpu``, else the
cards), as the reference's fake XLA host devices do:

    ... --device cpu --mesh data,model --fake-devices 8 --batch 4 --gen 6

Speculative decoding: ``--speculation draft --k K`` has a cheaper draft
policy over the same weights propose K tokens a round (the packed target's
own policy, unless ``--draft-weight-density D`` prunes its FFNs harder or
``--draft-min-spikes N`` gates its timestep planes); the target verifies
all K + 1 positions in one decode.  ``--stream`` serves event streams
instead of token prompts: each request is a `StreamSession` fed one
synthetic sensor window (``--window-us``) per engine step, admitted on its
first complete window and closed explicitly or by ``--idle-timeout``
microseconds of event-time silence; ``--prompt-len`` then counts windows.

Preemption: ``--handoff-path DIR`` installs a SIGTERM handler; a SIGTERM,
or ``--preempt-after N`` engine steps, closes admission, drains the live
cohorts within ``--drain-grace`` steps and saves the handoff to DIR.
``--resume --handoff-path DIR`` serves a successor from it, and
``--verify-resume`` replays every handed-off request on an undisturbed
engine and exits non-zero unless the resumed tokens are identical:

    ... --preempt-after 6 --drain-grace 2 --handoff-path /tmp/h
    ... --resume --verify-resume --handoff-path /tmp/h
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


@torch.no_grad()
def generate(model, params, tokens: torch.Tensor, cache: dict, steps: int, *,
             spiking_mode: str = "train") -> torch.Tensor:
    """Greedy generation loop (prefill + ``steps - 1`` decodes) — the
    reference oracle.  ``params`` must already be prepared the way the
    engine prepares them (plans attached for the dual-sparse path)."""
    logits, cache = model.prefill(params, {"tokens": tokens}, cache,
                                  spiking_mode=spiking_mode)
    out = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
    for _ in range(steps - 1):
        logits, cache = model.decode(params, out[-1], cache,
                                     spiking_mode=spiking_mode)
        out.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    return torch.cat(out, dim=1)


def build_config(arch: str, *, smoke: bool, spiking: bool,
                 weight_density: float):
    from repro_torch.configs import get_config, smoke_variant

    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    if spiking:
        cfg = dataclasses.replace(cfg, spiking_ffn=True,
                                  spiking_weight_density=weight_density)
    return cfg


def build_policy(args, cfg, device=None):
    """The `ExecutionPolicy` the flags name (``--mesh`` over the logical
    devices on ``device``)."""
    from repro_torch.serve import (
        ExecutionPolicy,
        Paging,
        Placement,
        Temporal,
        adaptive_t,
        approximate,
        bitwise,
        draft,
        paged,
    )

    speculation = None
    if args.speculation == "draft":
        # the draft: the target's arch under its own (sync, unpaged) policy,
        # cheaper by harder-pruned weights and/or a lossy timestep gate; a
        # lossy draft only lowers acceptance, the emitted tokens are the
        # target's
        d_policy = ExecutionPolicy.for_arch(
            cfg,
            temporal=(adaptive_t(args.draft_min_spikes)
                      if args.draft_min_spikes else Temporal()),
            exactness=(approximate(args.tol) if args.draft_min_spikes > 1
                       else bitwise()),
        )
        speculation = draft(
            d_policy, args.k,
            draft_weight_density=args.draft_weight_density or None)
    return ExecutionPolicy.for_arch(
        cfg, spike_format=args.spike_format,
        weight_sparsity=args.weight_sparsity,
        placement=Placement.from_spec(args.mesh, device=device),
        exactness=(approximate(args.tol) if args.exactness == "approximate"
                   else bitwise()),
        execution=args.execution,
        paging=(paged(args.page_size) if args.paging == "paged" else Paging()),
        temporal=(adaptive_t(args.min_spikes) if args.temporal == "adaptive"
                  else Temporal()),
        speculation=speculation,
    )


def serve_streams(engine, cfg, args):
    """Feed ``--batch`` synthetic sensor streams through the engine, one
    event window per `engine.step()`; returns (outputs, sessions)."""
    from repro_torch.data.events import moving_blob_events, split_into_windows
    from repro_torch.serve import EventStream, StreamSession

    n_win = args.prompt_len
    sessions, tickets, feeds = [], [], []
    for i in range(args.batch):
        # every other stream goes dark for one window: the gap still makes a
        # frame (all-silent words), whose planes --temporal adaptive skips
        silent = (n_win // 2,) if i % 2 and n_win > 1 else ()
        events = moving_blob_events(n_win, height=16, width=16,
                                    window_us=args.window_us, seed=i,
                                    silent=silent)
        stream = EventStream(args.window_us,
                             idle_timeout_us=args.idle_timeout or None)
        session = StreamSession(stream, height=16, width=16,
                                T=cfg.spiking_T, vocab=cfg.vocab)
        tickets.append(engine.submit_stream(session, args.gen))
        sessions.append(session)
        feeds.append(split_into_windows(events, n_win, args.window_us))
    for w in range(n_win):
        for session, chunks in zip(sessions, feeds):
            session.stream.push(chunks[w])
        engine.step()
    for session in sessions:
        if args.idle_timeout:
            session.stream.tick(n_win * args.window_us + args.idle_timeout)
        else:
            session.stream.close()
    out = engine.run()
    return [out[t.rid] for t in tickets], sessions


def serve_preemptible(engine, preemption, prompts, args):
    """Serve ``prompts`` until done or preempted (a SIGTERM, or
    ``--preempt-after`` steps); on preemption drain within
    ``--drain-grace`` steps, save the handoff to ``--handoff-path`` and
    return None, else return the outputs in order."""
    tickets = [engine.submit(p, args.gen) for p in prompts]
    n_steps = 0
    while not engine.idle and not engine.stopping:
        if args.preempt_after and n_steps == args.preempt_after:
            preemption.trigger()
            break
        engine.step()
        n_steps += 1
    if not engine.stopping:
        out = engine.run()
        return [out[t.rid] for t in tickets]
    handoff = engine.drain(step_budget=args.drain_grace or None)
    handoff.save(args.handoff_path)
    c = handoff.counts()
    print(f"preempted after {n_steps} steps; drained within grace "
          f"{args.drain_grace or 'unbounded'}: {c['finished']} finished, "
          f"{c['inflight']} in-flight ({c['tokens_in_flight']} tokens "
          f"preserved), {c['waiting']} waiting -> {args.handoff_path}")
    print("summary:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in engine.summary().items()}))
    return None


def resume(model, params, policy, args, device) -> int:
    """``--resume``: a successor engine from ``--handoff-path``; with
    ``--verify-resume`` every handed-off request again on an undisturbed
    engine, exiting non-zero unless the tokens are identical."""
    from repro_torch.serve import Engine, Handoff

    handoff = Handoff.load(args.handoff_path)
    c = handoff.counts()
    print(f"resuming from {args.handoff_path}: {c['waiting']} waiting + "
          f"{c['inflight']} in-flight ({c['tokens_in_flight']} tokens "
          f"already emitted) + {c['finished']} finished")
    engine = Engine.resume(model, params, handoff, policy=policy,
                           batch_align=args.batch_align,
                           pipeline_depth=args.pipeline_depth, device=device)
    out = engine.run()
    s = engine.summary()
    print(f"resumed {len(out)} results "
          f"({sum(len(v) for v in out.values())} tokens total)")
    if args.verify_resume:
        meta = handoff.meta
        ref = Engine(model, params, max_len=meta["max_len"],
                     max_slots=meta["max_slots"], eos_id=meta["eos_id"],
                     batch_align=args.batch_align, policy=policy,
                     pipeline_depth=args.pipeline_depth, device=device)
        tickets = [ref.submit(r.prompt, r.max_new_tokens)
                   for r in handoff.requests]
        ref_out = ref.run()
        for r, t in zip(handoff.requests, tickets):
            if not np.array_equal(out[r.rid], ref_out[t.rid]):
                raise SystemExit(f"RESUME IDENTITY FAILED: rid {r.rid} "
                                 f"{out[r.rid][:8]} != {ref_out[t.rid][:8]}")
        print(f"resume identity: {len(tickets)} requests token-identical "
              "to an undisturbed engine")
    print("summary:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in s.items()}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--spiking", action="store_true",
                    help="swap the MLP blocks for dual-sparse spiking FFNs")
    ap.add_argument("--weight-density", type=float, default=0.3,
                    help="LTH density for --spiking (plans built at load)")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to submit")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="engine slot budget (0 = one slot per request)")
    ap.add_argument("--batch-align", type=int, default=1,
                    help="pad prefill batches to a multiple of this")
    ap.add_argument("--spike-format", choices=("float", "packed"),
                    default=None,
                    help="policy.spike_format (default: packed for spiking "
                         "archs, float otherwise)")
    ap.add_argument("--weight-sparsity", choices=("dense", "dual_sparse"),
                    default=None,
                    help="policy.weight_sparsity (default: dual_sparse for "
                         "packed + LTH-pruned archs)")
    ap.add_argument("--exactness", choices=("bitwise", "approximate"),
                    default="bitwise",
                    help="policy.exactness: approximate bounds the logit "
                         "drift of a lossy --temporal by --tol")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="max logit drift allowed under --exactness "
                         "approximate")
    ap.add_argument("--execution", choices=("sync", "pipelined"),
                    default="sync",
                    help="policy.execution: sync = every decode step "
                         "host-syncs its sampled tokens; pipelined = the "
                         "staged executor keeps tokens on device between "
                         "steps, defers host materialization behind an "
                         "in-flight window (--pipeline-depth) and overlaps "
                         "the packed-spike encode with the next decode")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight decode window under --execution "
                         "pipelined (>= 1; 1 degenerates to sync cadence)")
    ap.add_argument("--paging", choices=("none", "paged"), default="none",
                    help="policy.paging: paged = cache state lives in "
                         "fixed pages owned by a CacheStore (cohort "
                         "merge/retire are page-table edits) with a radix "
                         "prefix index serving repeated prompts without a "
                         "prefill; none = per-cohort dense caches")
    ap.add_argument("--page-size", type=int, default=8,
                    help="cache positions per page under --paging paged "
                         "(multiple of 8; max_len is rounded up to a "
                         "multiple of it)")
    ap.add_argument("--temporal", choices=("full", "adaptive"),
                    default="full",
                    help="policy.temporal: adaptive = score each timestep "
                         "bit-plane on the device and skip planes below "
                         "--min-spikes; full = walk every timestep")
    ap.add_argument("--min-spikes", type=int, default=1,
                    help="minimum total spikes for a timestep plane under "
                         "--temporal adaptive; 1 skips only all-silent "
                         "planes (bitwise), >1 needs --exactness approximate")
    ap.add_argument("--speculation", choices=("none", "draft"),
                    default="none",
                    help="policy.speculation: draft = a cheaper draft policy "
                         "over the same weights proposes --k tokens a round "
                         "in one chained dispatch; the target verifies all "
                         "k+1 positions in one decode and emits the longest "
                         "matching prefix plus its own bonus token")
    ap.add_argument("--k", type=int, default=4,
                    help="proposal length per round under --speculation "
                         "draft")
    ap.add_argument("--draft-weight-density", type=float, default=0.0,
                    help="prune the draft's FFN weights to this density "
                         "(<= --weight-density; 0 = the target's weights)")
    ap.add_argument("--draft-min-spikes", type=int, default=0,
                    help="run the draft with temporal='adaptive' at this "
                         "min-spikes threshold (0 = full temporal walk; >1 "
                         "makes the DRAFT lossy, which only lowers "
                         "acceptance)")
    ap.add_argument("--stream", action="store_true",
                    help="serve event streams instead of token prompts: "
                         "each request is a StreamSession fed one synthetic "
                         "sensor window per engine step; --prompt-len counts "
                         "windows (one frame token each)")
    ap.add_argument("--window-us", type=int, default=1000,
                    help="event-time width of one stream window under "
                         "--stream")
    ap.add_argument("--idle-timeout", type=int, default=0,
                    help="under --stream: event-time microseconds of silence "
                         "after which tick() closes a stream (0 = close it "
                         "once every window is pushed)")
    # -- preemption / handoff (ft.preemption + serve/handoff.py) -------------
    ap.add_argument("--handoff-path", default=None,
                    help="directory for the drain handoff: a SIGTERM (or "
                         "--preempt-after) closes admission, drains "
                         "in-flight cohorts within --drain-grace steps, "
                         "and checkpoints scheduler state here; with "
                         "--resume, the directory to resume FROM")
    ap.add_argument("--drain-grace", type=int, default=0,
                    help="max engine steps granted to in-flight cohorts "
                         "after a preemption notice (0 = run them to "
                         "completion); unfinished requests ride the "
                         "handoff")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="testing hook: deliver the preemption notice via "
                         "PreemptionHandler.trigger() after this many "
                         "engine steps (0 = only real SIGTERM preempts)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a successor engine from --handoff-path "
                         "instead of submitting fresh requests")
    ap.add_argument("--verify-resume", action="store_true",
                    help="with --resume: replay ALL handoff requests on an "
                         "undisturbed reference engine and exit nonzero "
                         "unless the resumed results are token-identical")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="policy.placement mesh spec, e.g. 'data,model' "
                         "(auto sizes), 'data=4,model=2' or '4,2'; omitted "
                         "= unsharded; one device serves unsharded")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="make this many logical devices, mapped "
                         "round-robin onto the physical ones (mesh serving "
                         "on one card or on the CPU)")
    args = ap.parse_args(argv)
    if args.stream and (args.handoff_path or args.resume):
        raise SystemExit(
            "--stream does not compose with --handoff-path/--resume in this "
            "launcher (mid-ingest drain is exercised by the test suite)"
        )
    if args.resume and not args.handoff_path:
        raise SystemExit("--resume requires --handoff-path")

    from repro_torch import resolve_device
    from repro_torch.kernels import ftp_spmm
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, Temporal, bitwise, check_parity

    cfg = build_config(args.arch, smoke=args.smoke, spiking=args.spiking,
                       weight_density=args.weight_density)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode path")
    device = resolve_device(args.device)
    if args.fake_devices:
        from repro_torch.launch.mesh import force_fake_devices

        force_fake_devices(args.fake_devices)
    policy = build_policy(args, cfg, device)
    print(f"policy: {policy.describe()}  device: {device}")
    mesh = policy.mesh
    if args.mesh and mesh is None:
        print("mesh: single device — auto fallback to unsharded serving")
    elif mesh is not None:
        print(f"mesh: {mesh.shape} over {mesh.size} logical devices on "
              f"{len(mesh.physical_devices())} physical ({mesh.lead.type})")
    max_len = args.prompt_len + args.gen
    if policy.speculation.enabled:
        # a verify window may pass a row's budget by up to k positions
        # (rolled back); the scheduler reserves that slack
        max_len += policy.speculation.k
    if policy.paging.enabled:
        # whole pages per row; the spare positions are masked, never read
        ps = policy.paging.page_size
        max_len = -(-max_len // ps) * ps
    model = build_model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.batch)]
    if args.resume:
        return resume(model, params, policy, args, device)
    preemption = None
    if args.handoff_path:
        from repro_torch.ft import PreemptionHandler

        preemption = PreemptionHandler()
    engine = Engine(model, params, max_len=max_len,
                    max_slots=args.max_slots or args.batch,
                    batch_align=args.batch_align, policy=policy,
                    capture_logits=not policy.token_identical,
                    pipeline_depth=args.pipeline_depth, preemption=preemption,
                    device=device)
    before = ftp_spmm.launch_counts()
    if preemption is not None:
        try:
            outs = serve_preemptible(engine, preemption, prompts, args)
        finally:
            preemption.restore()
        if outs is None:
            return 0
    elif args.stream:
        outs, sessions = serve_streams(engine, cfg, args)
        # the frame-token prompts, for the drift reference below
        prompts = [sess.prompt_tokens() for sess in sessions]
    else:
        outs = engine.generate_batch(prompts, args.gen)
    s = engine.summary()
    s["kernel_launches"] = {k: n - before[k]
                            for k, n in ftp_spmm.launch_counts().items()}
    if not policy.token_identical:
        # drift against a bitwise run of the same prompts with the same
        # spike format and weight sparsity: what --tol bounds is the lossy
        # timestep skipping alone
        ref_policy = dataclasses.replace(policy, exactness=bitwise(),
                                         temporal=Temporal())
        ref = Engine(model, params, max_len=max_len,
                     max_slots=args.max_slots or args.batch,
                     batch_align=args.batch_align, policy=ref_policy,
                     capture_logits=True, device=device)
        ref_outs = ref.generate_batch(prompts, args.gen)
        rep = check_parity(policy, ref_outs, outs,
                           ref_logits=ref.drain_logit_traces(),
                           got_logits=engine.drain_logit_traces())
        # s["token_identical"] stays the policy's contract (False here)
        s["max_logit_drift"] = rep["max_logit_drift"]
        s["token_match_fraction"] = rep["token_match_fraction"]
        print(f"approximate drift: max |logit drift| "
              f"{rep['max_logit_drift']:.3e} <= tol {policy.exactness.tol} "
              f"(token match {rep['token_match_fraction']:.0%})")
    if policy.temporal.enabled:
        print(f"temporal: {policy.temporal.describe()} — "
              f"{s['timesteps_skipped']} timestep planes skipped")
    if policy.speculation.enabled:
        print(f"speculation: {policy.speculation.describe()} — "
              f"{s['speculative_rounds']} rounds, "
              f"{s['tokens_accepted']}/{s['tokens_proposed']} proposals "
              f"accepted ({s['acceptance_rate']:.0%})")
    if args.stream:
        print(f"streamed {s['stream_sessions']} sessions / "
              f"{s['stream_windows']} frames — frame->first-token "
              f"p50 {s['frame_to_first_token_s_p50'] * 1e3:.1f}ms / "
              f"p99 {s['frame_to_first_token_s_p99'] * 1e3:.1f}ms")
    print(f"served {s['n_requests']} requests / {s['total_tokens']} tokens "
          f"in {s['wall_s']:.2f}s ({s['throughput_tok_s']:.1f} tok/s, "
          f"ttft_p50 {s['ttft_s_p50'] * 1e3:.0f}ms, "
          f"mean decode batch {s['mean_decode_batch']:.1f})")
    print("summary:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in s.items()}))
    print("sample:", outs[0][:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
