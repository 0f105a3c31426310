#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drive its main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src`` on ``sys.path`` itself).
Phases, each asserted; a failed phase ends the run with a non-zero exit:

1. device  — a CUDA device is present; prints nvidia-smi's name and power
             limit.
2. build   — compiles the hand-written kernel from ``src/repro_torch/
             kernels/csrc``.
3. kernel  — the dual-sparse BSR kernel against its plain torch version on
             the card, at the main path's shapes: llama3.2-1b's W_in
             2048->8192 (fused LIF) and W_out 8192->2048 (full sums), M = 4
             (decode) and 512 (prefill), bf16 payload at block density 0.3;
             plus an all-silent input and a plan with a cnt == 0 column
             block.  Full sums must agree within ``TOL``; a spike word may
             differ only where the LIF input sits within ``TOL`` of v_th.
             Times the kernel, the plain version and one PyTorch matmul of
             the same work (CUDA events, L2 flushed before each launch).
4. serve   — full-width llama3.2-1b (16 layers, d_model 2048, d_ff 8192,
             vocab 128256) with spiking FFNs at weight density 0.3, random
             weights from a seed, served by the `Engine` under PACKED_DUAL:
             4 requests of 128 prompt tokens and 16 generated tokens.  The
             kernel's launch count must be exactly 2 x 16 x forwards; tokens
             must equal the port's own greedy loop; the served logits of
             every step must lie within ``LOGIT_TOL`` of the same params run
             on the CPU (plain versions), teacher-forced with the served
             tokens.  Then every kernel call of that serve is replayed on its
             own inputs: held against the plain version and timed against a
             bound computed from its own activity map.  Three more serves
             without logit capture give tok/s and TTFT, and one under
             torch.profiler the device's busy time.  A smoke-size model
             served on the card and on the CPU must give the same tokens.

Prints a JSON line of per-kernel measurements before the last line (the
headline numbers are the serve's mean launch), and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Full sums of <= 8192 exact products of a {0,1} spike and a bf16 weight,
# summed in f32 in two different orders: rounding differences stay orders
# of magnitude below this.
TOL = 1e-3
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor cores
T = 4
SEED = 0
PROMPT, GEN, REQUESTS = 128, 16, 4
REPLACES = "src/repro/kernels/ftp_spmm.py:211"
# Full-width logits, card vs CPU: the bound tests/test_torch_models.py holds
# the port to against the jitted JAX reference, whose excess precision on
# bf16 residual adds flips FFN spikes the same way other GEMM orders do.
LOGIT_TOL = 0.25
TIMED_SERVES = 3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: the port's sources are not at {SRC}")
    sys.path.insert(0, SRC)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # plain versions in full f32; bf16 GEMMs without reduced-precision
    # partial sums, so the card's logits are comparable with the CPU's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    built = _build.build()
    log(f"built ftp_bsr in {built['seconds']:.1f}s -> {built['path']}")
    for ln in built["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int, flush) -> float:
    """Median device time of one call: the L2 is flushed before each call
    and the stream is kept busy while the host enqueues it, so the events
    bracket the call's device work only."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _flush_buffer():
    """A buffer larger than the H100's 50 MB L2, zeroed before each timed
    call."""
    import torch

    return torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")


def _lif_margin(o, v_th=1.0, tau=0.5):
    """min over t of |x_t - v_th| of the LIF the kernel epilogue runs."""
    import torch

    u = torch.zeros_like(o[0])
    margin = torch.full_like(o[0], float("inf"))
    for t in range(o.shape[0]):
        x = o[t] + u
        margin = torch.minimum(margin, (x - v_th).abs())
        c = x > v_th
        u = tau * x * (1.0 - c.float())
    return margin


def _bound(args, bm, fuse):
    """Least time for one call's work on the card: each input byte read
    once, each output byte written once (payload blocks that some live,
    spike-active join slot needs), against the dense bf16 operations of
    those joins.  Returns (ms, "bytes" or "operations")."""
    import torch

    a, payload, kidx, vidx, cnt, act, n_out = args[:7]
    M = a.shape[0]
    _, bk, bn = payload.shape
    kidx, vidx, cnt = kidx.long(), vidx.long(), cnt.long()
    live = torch.arange(kidx.shape[1], device=a.device)[None] < cnt[:, None]
    joined = (act[:, kidx] > 0) & live[None]              # (nm, nnb, jmax)
    rows = torch.clamp(M - bm * torch.arange(act.shape[0], device=a.device),
                       max=bm)
    ops = 2 * T * bk * bn * int((joined.sum((1, 2)) * rows).sum())
    used = torch.zeros(payload.shape[0], dtype=torch.bool, device=a.device)
    used[vidx[joined.any(0)]] = True
    out = M * n_out * 4 * (2 if fuse else T + 1)
    nbytes = (a.numel() * 4 + int(used.sum()) * bk * bn * payload.element_size()
              + act.numel() * 4 + (kidx.numel() + vidx.numel() + cnt.numel()) * 4
              + out)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _dense_weight(args):
    """The (K, n_out) bf16 weight a join plan stands for (zeros where a
    block was pruned): the library yardstick's operand."""
    import torch

    a, payload, kidx, vidx, cnt, act, n_out = args[:7]
    nnb, jmax = kidx.shape
    _, bk, bn = payload.shape
    w = torch.zeros((act.shape[1], bk, nnb, bn), dtype=torch.bfloat16,
                    device=a.device)
    j, jj = (torch.arange(jmax, device=a.device)[None] < cnt[:, None].long()
             ).nonzero(as_tuple=True)
    w[kidx[j, jj].long(), :, j, :] = payload[vidx[j, jj].long()].to(torch.bfloat16)
    return w.reshape(act.shape[1] * bk, nnb * bn)[: a.shape[1], :n_out]


def _parity(label, args, bm, fuse):
    """Kernel vs plain version on one call's inputs: full sums within TOL,
    spike words equal except where the LIF input is within TOL of v_th.
    Returns (max abs error, spike-word flips)."""
    import torch

    from repro_torch.kernels import ftp_spmm
    from repro_torch.kernels.ref import lif_ref

    c_k, u_k = ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse)
    o_p, _ = ftp_spmm.ftp_spmm_bsr_plain(*args, bm=bm, fuse_lif=False)
    torch.cuda.synchronize()
    if fuse:
        c_p, u_p = lif_ref(o_p)
        differ = c_k != c_p
        flips = int(differ.sum())
        near = _lif_margin(o_p) < TOL
        assert not bool((differ & ~near).any()), (
            f"{label}: {int((differ & ~near).sum())} spike words differ away "
            "from the threshold")
        err = float((u_k - u_p)[~differ].abs().max()) if flips < differ.numel() else 0.0
    else:
        flips = 0
        err = float((c_k - o_p).abs().max())
        assert not bool(u_k.any()), f"{label}: U must be zero without the LIF"
    assert err <= TOL, f"{label}: max |kernel - plain| = {err:.3e} > {TOL}"
    return err, flips


def _measure(args, bm, fuse, flush, w_dense, reps):
    """Kernel, plain version and library yardstick timed on one call's
    inputs, with the call's bound."""
    import torch

    from repro_torch.core.packing import unpack_spikes
    from repro_torch.kernels import ftp_spmm

    a = args[0]
    planes = unpack_spikes(a, T, torch.bfloat16).reshape(T * a.shape[0], -1)
    row = {
        "ms": _time_ms(lambda: ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse),
                       reps, flush),
        "plain_ms": _time_ms(
            lambda: ftp_spmm.ftp_spmm_bsr_plain(*args, bm=bm, fuse_lif=fuse),
            max(1, reps // 5), flush),
        "library_ms": _time_ms(lambda: torch.matmul(planes, w_dense), reps, flush),
    }
    row["bound_ms"], row["bound_by"] = _bound(args, bm, fuse)
    return row


def _check_case(label, a, plan, n_out, fuse, flush=None):
    """Kernel vs plain version on one synthetic input; timed when ``flush``
    is given.  Returns the measurement row."""
    from repro_torch.kernels import ftp_spmm, ops

    bm = ftp_spmm.pick_bm(a.shape[0])
    args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
            ops._activity(a, bm, plan), n_out, T)
    err, flips = _parity(label, args, bm, fuse)
    row = {"case": label, "M": a.shape[0], "fuse_lif": fuse,
           "max_abs_err": err, "flips": flips}
    if flush is not None:
        row.update(_measure(args, bm, fuse, flush, _dense_weight(args), 30))
    log(f"{label}: max_abs_err {err:.3e}, flips {flips}"
        + (f", kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
           f"matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
           f"({row['bound_by']})" if "ms" in row else ""))
    return row


def phase_kernel():
    import torch

    from repro_torch.core.lif import direct_encode
    from repro_torch.core.packing import pack_spikes
    from repro_torch.core.snn_layers import init_spiking_ffn
    from repro_torch.kernels.join_plan import build_weight_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    D, F = 2048, 8192
    ffn = init_spiking_ffn(gen, D, F, weight_density=0.3, prune_block=(128, 128))
    w_in, w_out = ffn["w_in"].to(torch.bfloat16), ffn["w_out"].to(torch.bfloat16)
    plan_in, plan_out = build_weight_plan(w_in), build_weight_plan(w_out)
    log(f"plans: W_in {plan_in.payload.shape[0]} of {plan_in.nkb * plan_in.nnb} "
        f"blocks, W_out {plan_out.payload.shape[0]} of "
        f"{plan_out.nkb * plan_out.nnb} blocks")
    for w, plan in ((w_in, plan_in), (w_out, plan_out)):
        args = (torch.zeros((1, w.shape[0]), dtype=torch.int32, device=dev),
                plan.payload, plan.kidx, plan.vidx, plan.cnt,
                torch.zeros((1, plan.nkb), dtype=torch.int32, device=dev),
                w.shape[1])
        assert torch.equal(_dense_weight(args), w), "plan does not rebuild W"
    flush = _flush_buffer()

    def spikes(M, width):
        x = torch.randn((M, width), generator=gen, device=dev).to(torch.bfloat16)
        return pack_spikes(direct_encode(x, T))

    rows = []
    for M in (4, 512):
        rows.append(_check_case(f"W_in fused_lif M={M}", spikes(M, D), plan_in,
                                F, True, flush))
        rows.append(_check_case(f"W_out full_sums M={M}", spikes(M, F), plan_out,
                                D, False, flush))
    silent = torch.zeros((4, D), dtype=torch.int32, device=dev)
    for fuse in (True, False):
        _check_case(f"all-silent fuse_lif={fuse}", silent, plan_in, F, fuse)
    holed = w_in.clone()
    holed[:, 128:256] = 0
    plan_hole = build_weight_plan(holed)
    assert int(plan_hole.cnt[1]) == 0
    for fuse in (True, False):
        _check_case(f"cnt==0 column block fuse_lif={fuse}", spikes(4, D),
                    plan_hole, F, fuse)
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def phase_serve():
    """The main path: full-width llama3.2-1b served by the engine.  The run
    whose launches are counted captures its logits and records every
    kernel call's inputs; the timed and profiled serves that follow run as
    `launch/serve.py` does, without logit capture."""
    import numpy as np
    import torch

    from repro_torch.kernels import ftp_spmm
    from repro_torch.launch.serve import build_config, generate
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    cfg = build_config("llama3_2_1b", smoke=False, spiking=True, weight_density=0.3)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (16, 2048, 8192, 128256)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    engine = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                    policy=ExecutionPolicy.for_arch(cfg), capture_logits=True)
    torch.cuda.synchronize()
    log(f"init + plans on the card: {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED)
    engine.generate_batch([rng.integers(0, cfg.vocab, size=(8,))], 2)  # warm-up
    engine.metrics.reset()
    engine.logit_traces = {}
    prompts = [rng.integers(0, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]

    calls = []  # (args, kwargs) of every kernel call of the counted run
    kernel = ftp_spmm.ftp_spmm_bsr

    def recorded(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    ftp_spmm.ftp_spmm_bsr = recorded
    ftp_spmm.LAUNCHES = 0
    try:
        outs = engine.generate_batch(prompts, GEN)
        torch.cuda.synchronize()
    finally:
        ftp_spmm.ftp_spmm_bsr = kernel
    launches = ftp_spmm.LAUNCHES

    s = engine.summary()
    forwards = s["prefill_batches"] + s["decode_batches"]
    assert all(len(o) == GEN for o in outs), [len(o) for o in outs]
    assert launches == len(calls) == 2 * cfg.n_layers * forwards, (launches, forwards)
    traces = engine.logit_traces
    assert len(traces) == REQUESTS and all(len(v) == GEN for v in traces.values())
    got = np.stack([np.stack(traces[r]) for r in sorted(traces)])  # (B, GEN, V)
    assert got.shape == (REQUESTS, GEN, cfg.vocab) and np.isfinite(got).all()
    want = generate(model, engine.params,
                    torch.as_tensor(np.stack(prompts), device="cuda").long(),
                    model.init_cache(REQUESTS, PROMPT + GEN, device="cuda"), GEN,
                    spiking_mode="infer").cpu().numpy()
    for i in range(REQUESTS):
        np.testing.assert_array_equal(outs[i], want[i])
    log(f"counted serve: {forwards} forwards, {launches} kernel launches; "
        f"tokens identical to the greedy loop; sample {outs[0][:8].tolist()}")
    cpu_ref = _cpu_reference(model, cfg, params, prompts, outs, got)

    engine.capture_logits = False
    timed = []
    for _ in range(TIMED_SERVES):
        engine.metrics.reset()
        again = engine.generate_batch(prompts, GEN)
        for a, b in zip(again, outs):
            np.testing.assert_array_equal(a, b)
        timed.append(engine.summary())
    tok_s = [t["throughput_tok_s"] for t in timed]
    best = timed[tok_s.index(statistics.median(tok_s))]
    log(f"timed serves (no logit capture): {len(timed)} x {best['total_tokens']} "
        f"tokens: tok/s {[round(x, 1) for x in tok_s]}, TTFT p50 ms "
        f"{[round(t['ttft_s_p50'] * 1e3, 1) for t in timed]}; median run "
        f"{best['wall_s']:.3f}s wall, stages {json.dumps(best['stage_s'])}")
    prof = _profile(engine, prompts, best["wall_s"])
    return {"launches": launches, "calls": calls, "cpu_reference": cpu_ref,
            "timed": timed, "median": best, "profile": prof}


def _cpu_reference(model, cfg, params, prompts, outs, got):
    """The same params through the port on the CPU (the kernels' plain
    versions, CPU GEMMs), teacher-forced with the served tokens: its prefill
    and decode logits against the card's.  Tokens may disagree only where
    the reference's top two logits lie within 2 x LOGIT_TOL."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, ExecutionPolicy

    t0 = time.perf_counter()
    ref = Engine(model, params, max_len=PROMPT + GEN, max_slots=REQUESTS,
                 policy=ExecutionPolicy.for_arch(cfg), device="cpu")
    cache = model.init_cache(REQUESTS, PROMPT + GEN, device="cpu")
    forced = torch.as_tensor(np.stack(outs)).long()
    with torch.no_grad():
        logits, cache = model.prefill(
            ref.params, {"tokens": torch.as_tensor(np.stack(prompts)).long()},
            cache, spiking_mode="infer")
        steps = [logits[:, -1]]
        for k in range(GEN - 1):
            logits, cache = model.decode(ref.params, forced[:, k:k + 1], cache,
                                         spiking_mode="infer")
            steps.append(logits[:, -1])
    want = torch.stack(steps, dim=1).numpy()                 # (B, GEN, V)
    drift = np.abs(got - want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * LOGIT_TOL
    differ = want.argmax(-1) != np.stack(outs)
    out = {"max_abs_drift": float(drift.max()),
           "max_abs_drift_prefill": float(drift[:, 0].max()),
           "mean_abs_drift": float(drift.mean()),
           "logit_std": float(want.std()),
           "tokens_compared": int(differ.size),
           "tokens_disagree": int(differ.sum()),
           "seconds": time.perf_counter() - t0}
    log(f"card vs CPU reference (teacher-forced, {REQUESTS} x {GEN} steps): max "
        f"|logit drift| {out['max_abs_drift']:.3e} (prefill "
        f"{out['max_abs_drift_prefill']:.3e}, mean {out['mean_abs_drift']:.3e}, "
        f"logit std {out['logit_std']:.3f}); {out['tokens_disagree']} of "
        f"{out['tokens_compared']} tokens disagree; {out['seconds']:.1f}s")
    assert out["max_abs_drift"] <= LOGIT_TOL, out
    assert not bool((differ & ~close).any()), (
        f"{int((differ & ~close).sum())} tokens disagree away from a near tie")
    return out


def _replay(calls):
    """Every kernel call of the counted serve again, on its own inputs:
    kernel vs plain version, then kernel, plain version and library
    yardstick timed against the call's bound.  Grouped by (M, fuse_lif):
    W_in runs with the LIF fused, W_out without."""
    import torch

    from repro_torch.serve.batching import spike_sparsity

    flush = _flush_buffer()
    dense = {}
    groups = {}
    for n, (args, kw) in enumerate(calls):
        args = args[:8]
        bm, fuse = kw["bm"], kw["fuse_lif"]
        label = f"serve {'W_in fused_lif' if fuse else 'W_out full_sums'} M={args[0].shape[0]}"
        err, flips = _parity(f"{label} call {n}", args, bm, fuse)
        key = args[1].data_ptr()
        if key not in dense:
            dense[key] = _dense_weight(args)
        row = _measure(args, bm, fuse, flush, dense[key], 3)
        g = groups.setdefault(label, {
            "case": label, "M": args[0].shape[0], "fuse_lif": fuse,
            "launches": 0, "max_abs_err": 0.0, "flips": 0, "ms": 0.0,
            "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_bound_ms": 0.0, "active_blocks": 0.0, "spike_density": 0.0})
        g["launches"] += 1
        g["max_abs_err"] = max(g["max_abs_err"], err)
        g["flips"] += flips
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            g[k] += row[k]
        if row["bound_by"] == "bytes":
            g["bytes_bound_ms"] += row["bound_ms"]
        g["active_blocks"] += float((args[5] > 0).float().mean())
        g["spike_density"] += 1.0 - spike_sparsity(args[0], T)
    rows = []
    for g in groups.values():
        n = g.pop("launches")
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "active_blocks",
                  "spike_density"):
            g[k] /= n
        g["bound_by"] = ("bytes" if g.pop("bytes_bound_ms") / n >= g["bound_ms"] / 2
                         else "operations")
        g["launches"] = n
        rows.append(g)
        log(f"{g['case']}: {n} launches, max_abs_err {g['max_abs_err']:.3e}, flips "
            f"{g['flips']}, per launch: kernel {g['ms']:.4f} ms, plain "
            f"{g['plain_ms']:.4f} ms, matmul {g['library_ms']:.4f} ms, bound "
            f"{g['bound_ms']:.4f} ms ({g['bound_by']}); active spike blocks "
            f"{g['active_blocks']:.3f}, spike density {g['spike_density']:.4f}")
    return rows


def _profile(engine, prompts, unprofiled_wall):
    """One more serve of the same requests under torch.profiler: device
    busy time (kernels and copies of the one stream, summed) against the
    host wall time, and the kernels that take it.  The idle share is given
    against the profiled wall and against the median unprofiled one."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ftp_spmm

    n0 = ftp_spmm.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_batch(prompts, GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_launch = ftp_spmm.LAUNCHES - n0
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total * 1e-6
    busy = sum(by_name.values())
    bsr = sum(v for k, v in by_name.items() if "ftp_bsr" in k)
    out = {"wall_s": wall, "device_busy_s": busy, "ftp_bsr_device_s": bsr,
           "ftp_bsr_launches": n_launch,
           "ftp_bsr_ms_per_launch": 1e3 * bsr / n_launch,
           "idle_share_profiled": 1.0 - busy / wall if busy else None,
           "idle_share_unprofiled": 1.0 - busy / unprofiled_wall if busy else None}
    if not busy:
        log("profile: no device time recorded (not measured)")
        return out
    log(f"profile: device busy {busy:.3f}s; idle share {out['idle_share_profiled']:.3f} "
        f"of the profiled wall ({wall:.3f}s), {out['idle_share_unprofiled']:.3f} of "
        f"the unprofiled one ({unprofiled_wall:.3f}s); ftp_bsr {bsr:.4f}s, "
        f"{out['ftp_bsr_ms_per_launch']:.4f} ms per launch in the serve")
    for name, sec in by_name.most_common(12):
        log(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    return out


def phase_small_cpu_vs_card():
    """The smoke-size model served on the card and on the CPU (the kernels'
    plain versions) from the same params: the same greedy tokens."""
    import numpy as np

    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine, ExecutionPolicy

    cfg = build_config("llama3_2_1b", smoke=True, spiking=True, weight_density=0.3)
    model = build_model(cfg)
    params = model.init(SEED, device="cpu")
    prompts = list(np.random.default_rng(1).integers(0, cfg.vocab, size=(3, 8)))
    got, traces = {}, {}
    for dev in ("cuda", "cpu"):
        eng = Engine(model, params, max_len=16, max_slots=3, capture_logits=True,
                     policy=ExecutionPolicy.for_arch(cfg), device=dev)
        got[dev] = eng.generate_batch(prompts, 6)
        traces[dev] = np.stack([np.stack(eng.logit_traces[r])
                                for r in sorted(eng.logit_traces)])
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(a, b)
    # bf16 GEMM and f32 sums in other orders on the two devices: the same
    # bound the CPU tests hold the jitted JAX reference to
    drift = float(np.abs(traces["cuda"] - traces["cpu"]).max())
    assert drift <= 0.25, drift
    log(f"smoke-size model: card and CPU emit the same tokens, "
        f"max |logit drift| {drift:.3e}")


def main() -> int:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernel()
    phase_small_cpu_vs_card()
    serve = phase_serve()
    served = _replay(serve["calls"])
    import torch

    # headline: the mean launch of the counted serve, on its own inputs
    n = sum(r["launches"] for r in served)
    mean = {k: sum(r[k] * r["launches"] for r in served) / n
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bytes_share = sum(r["bound_ms"] * r["launches"] for r in served
                      if r["bound_by"] == "bytes") / (mean["bound_ms"] * n)
    med = serve["median"]
    log(f"serve mix: {n} launches, kernel {mean['ms']:.4f} ms per launch against "
        f"a bound of {mean['bound_ms']:.4f} ms (replayed, L2 flushed); "
        f"{serve['profile'].get('ftp_bsr_ms_per_launch', float('nan')):.4f} ms "
        "per launch inside the profiled serve")
    kernels = [{
        "name": "ftp_bsr",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ftp_bsr.cu",
        "replaces": REPLACES,
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + served),
        "ms": mean["ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": "bytes" if bytes_share >= 0.5 else "operations",
        "library_ms": mean["library_ms"],
        "serve_cases": served,
        "cases": rows,
        "serve": {"tok_s": med["throughput_tok_s"], "ttft_s_p50": med["ttft_s_p50"],
                  "wall_s": med["wall_s"], "stage_s": med["stage_s"],
                  "tok_s_runs": [t["throughput_tok_s"] for t in serve["timed"]],
                  "ttft_s_p50_runs": [t["ttft_s_p50"] for t in serve["timed"]],
                  "cpu_reference": serve["cpu_reference"],
                  "profile": serve["profile"]},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
