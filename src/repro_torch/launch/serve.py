"""Serving launcher of the port: the continuous-batching engine over the
dense transformer family, on the CUDA device by default.

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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.kernels import ftp_spmm
    from repro_torch.models.registry import build_model
    from repro_torch.serve import (
        Engine,
        ExecutionPolicy,
        Paging,
        Temporal,
        adaptive_t,
        approximate,
        bitwise,
        check_parity,
        paged,
    )

    cfg = build_config(args.arch, smoke=args.smoke, spiking=args.spiking,
                       weight_density=args.weight_density)
    device = resolve_device(args.device)
    policy = ExecutionPolicy.for_arch(
        cfg, spike_format=args.spike_format,
        weight_sparsity=args.weight_sparsity,
        exactness=(approximate(args.tol) if args.exactness == "approximate"
                   else bitwise()),
        execution=args.execution,
        paging=(paged(args.page_size) if args.paging == "paged" else Paging()),
        temporal=(adaptive_t(args.min_spikes) if args.temporal == "adaptive"
                  else Temporal()),
    )
    print(f"policy: {policy.describe()}  device: {device}")
    max_len = args.prompt_len + args.gen
    if policy.paging.enabled:
        # whole pages per row; the spare positions are masked, never read
        ps = policy.paging.page_size
        max_len = -(-max_len // ps) * ps
    model = build_model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.batch)]
    engine = Engine(model, params, max_len=max_len,
                    max_slots=args.max_slots or args.batch,
                    batch_align=args.batch_align, policy=policy,
                    capture_logits=not policy.token_identical,
                    pipeline_depth=args.pipeline_depth, device=device)
    before = ftp_spmm.launch_counts()
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
