"""Training launcher of the port: the train step with checkpoint/restart,
preemption handling, straggler detection and deterministic data, on the
CUDA device by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --batch 8 --seq 128

``--smoke`` shrinks the arch to the CPU test size; ``--device cpu`` runs on
the CPU.  Params come from seed 0 (a torch generator on the device).  The
reference's flags, plus ``--device``.  ``--mesh host`` is accepted as the
reference accepts it: the reference parses the flag and never reads it (on
a pod each host runs this entry point), so training proceeds as with
``--mesh none``; the train mesh itself is `train.make_train_step(mesh=)`.
There is no spiking flag, as in the reference: the spiking LM trains
through a config with ``spiking_ffn=True`` (`dataclasses.replace`).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData, batch_to_torch
    from repro_torch.ft import PreemptionHandler, StepTimer
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=args.seq, global_batch=args.batch)
    step_fn = make_train_step(model, grad_compress=args.grad_compress)

    mgr = (CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
           if args.ckpt_dir else None)
    preempt = PreemptionHandler()
    timer = StepTimer()
    try:
        state = init_train_state(model, 0, grad_compress=args.grad_compress,
                                 device=device)
        start = 0
        if mgr is not None:
            restored, step = mgr.restore_latest(state)
            if restored is not None:
                state, start = restored, step
                print(f"[restore] resumed from step {step}")

        losses = []
        for step in range(start, args.steps):
            batch = batch_to_torch(data.batch(step), device)
            with timer:  # host time: reading the loss below waits for the step
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if mgr is not None:
                mgr.maybe_save(step + 1, state)
            if preempt.should_stop:
                print("[preempt] signal received; checkpointing and exiting")
                if mgr is not None:
                    mgr.maybe_save(step + 1, state, force=True)
                    mgr.wait()
                return 1
        if mgr is not None:
            mgr.maybe_save(args.steps, state, force=True)
            mgr.wait()
    finally:
        preempt.restore()
    if not losses:
        print(f"nothing to do: the checkpoint is at step {start} >= --steps")
        return 0
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"straggler events: {len(timer.events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
