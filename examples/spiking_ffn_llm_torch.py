"""End-to-end LM training on the PyTorch/CUDA port with the paper's
technique integrated (port of `spiking_ffn_llm.py`): a llama-family decoder
whose MLP blocks run as dual-sparse spiking FFNs (direct-coded LIF + FTP
spMspM), trained on the synthetic pipeline; the loss must drop.

    PYTHONPATH=src python examples/spiking_ffn_llm_torch.py --steps 200               # the card
    PYTHONPATH=src python examples/spiking_ffn_llm_torch.py --steps 40 --device cpu   # plain torch
    PYTHONPATH=src python examples/spiking_ffn_llm_torch.py --steps 200 --dense

Without ``--device`` and without a card it raises instead of running on
the CPU.
"""
import argparse
import dataclasses
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import SyntheticLMData, batch_to_torch
from repro_torch.models.registry import build_model
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves


def example_config(dense: bool = False, weight_density: float = 0.2):
    """The example's model: llama3.2-1b's smoke variant at 3 layers, d_model
    128, d_ff 256, spiking FFNs at T = 4 unless ``dense``."""
    cfg = smoke_variant(get_config("llama3_2_1b"))
    return dataclasses.replace(cfg, n_layers=3, d_model=128, d_ff=256,
                               spiking_ffn=not dense, spiking_T=4,
                               spiking_weight_density=weight_density)


def run(steps=200, batch=8, seq=64, dense=False, weight_density=0.2,
        device=None, state=None, log=print) -> dict:
    """Train ``steps`` steps from ``state`` (the seed-0 train state when
    None); returns the losses and the parameter count."""
    dev = resolve_device(device)
    cfg = example_config(dense, weight_density)
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=seq, global_batch=batch)
    if state is None:
        state = init_train_state(model, 0, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    log(f"mode={'dense' if dense else 'spiking-FFN'} params={n_params / 1e6:.1f}M "
        f"device={dev}")
    step_fn = make_train_step(model)
    t0, losses = time.time(), []
    for step in range(steps):
        state, metrics = step_fn(state, batch_to_torch(data.batch(step), dev))
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {losses[-1]:.4f}")
    first, last = losses[0], losses[-1]
    log(f"loss {first:.3f} -> {last:.3f} in {time.time() - t0:.0f}s "
        f"({'PASS' if last < first else 'FAIL'}: learning with "
        f"{'dense' if dense else 'spiking dual-sparse'} FFN)")
    return {"losses": losses, "n_params": n_params, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dense", action="store_true",
                    help="baseline: standard dense FFN instead of spiking")
    ap.add_argument("--weight-density", type=float, default=0.2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.batch, args.seq, args.dense,
               args.weight_density, args.device)


if __name__ == "__main__":
    main()
