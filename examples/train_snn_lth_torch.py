"""End-to-end dual-sparse SNN pipeline on the PyTorch/CUDA port (the
paper's §V software configuration at reduced scale; `train_snn_lth.py`'s
steps): BPTT + surrogate-gradient training of a spiking MLP, lottery-ticket
iterative magnitude pruning to ~95 % weight sparsity, the silent-neuron
preprocessing + a short fine-tune (paper Fig. 11), and the trained
workload's sparsity fed through the port's LoAS and SparTen-SNN cycle
models.

    PYTHONPATH=src python examples/train_snn_lth_torch.py --steps 150 --rounds 3
    PYTHONPATH=src python examples/train_snn_lth_torch.py --device cpu

Runs on the card unless ``--device cpu``.  The data keeps the reference
example's construction (fixed class templates plus noise), drawn from
explicit `torch.Generator`s, so its numbers are not the reference's.  The
simulated speedup is the ASIC model's (cycles at 800 MHz), not a speed of
the card.
"""
import argparse
import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import direct_encode, pack_spikes, rate_decode
from repro_torch.core.lif import lif_forward
from repro_torch.core.packing import mask_low_activity_spikes
from repro_torch.core.snn_layers import assert_weight_density, prune_by_magnitude
from repro_torch.sim import HwConfig
from repro_torch.sim.loas import layer_cost as loas_cost
from repro_torch.sim.sparten import layer_cost as sparten_cost
from repro_torch.sim.workloads import Layer

D_IN, D_H, N_CLS, T = 64, 256, 10, 4


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_data(n: int, seed: int, device):
    """Synthetic 10-way classification: FIXED class templates + noise."""
    templates = torch.randn((N_CLS, D_IN), generator=_gen(42, device),
                            device=device)
    g = _gen(seed, device)
    y = torch.randint(0, N_CLS, (n,), generator=g, device=device)
    x = templates[y] + 0.6 * torch.randn((n, D_IN), generator=g, device=device)
    return x, y


def init(seed: int, device) -> dict:
    g = _gen(seed, device)
    return {
        "w1": torch.randn((D_IN, D_H), generator=g, device=device) / math.sqrt(D_IN),
        "w2": torch.randn((D_H, N_CLS), generator=g, device=device) / math.sqrt(D_H),
    }


def forward(params, x, masks, min_spikes=0):
    """(B, D_IN) -> (logits (B, N_CLS), hidden spikes (T, B, D_H))."""
    spikes = direct_encode(torch.sigmoid(x) * 2.0, T)      # (T, B, D_IN)
    o1 = torch.einsum("tbi,ih->tbh", spikes, params["w1"] * masks["w1"])
    h, _ = lif_forward(o1)
    if min_spikes:
        h = mask_low_activity_spikes(h, min_spikes)
    o2 = torch.einsum("tbh,hc->tbc", h, params["w2"] * masks["w2"])
    return 6.0 * rate_decode(o2), h


def loss_fn(params, x, y, masks, min_spikes=0):
    logits, _ = forward(params, x, masks, min_spikes)
    return F.cross_entropy(logits, y)


@torch.no_grad()
def accuracy(params, x, y, masks, min_spikes=0) -> float:
    logits, _ = forward(params, x, masks, min_spikes)
    return float((logits.argmax(-1) == y).float().mean())


def train(params, masks, x, y, steps, lr=0.5, min_spikes=0):
    """Plain SGD through BPTT; returns (params, the last step's loss)."""
    params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        loss = loss_fn(params, x, y, masks, min_spikes)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= lr * g
    return {k: v.detach() for k, v in params.items()}, float(loss.detach())


def lth_masks(params, masks, density):
    """One LTH round's pruning: keep the largest surviving magnitudes."""
    return {k: (prune_by_magnitude(params[k] * masks[k], density) != 0).float()
            for k in params}


@torch.no_grad()
def silent_fractions(params, x, masks, min_spikes=2):
    """Silent fraction of the hidden layer's packed words, before and after
    the silent-neuron preprocessing, and the hidden spike density."""
    _, h = forward(params, x, masks)
    _, h2 = forward(params, x, masks, min_spikes=min_spikes)
    before = float((pack_spikes(h) == 0).float().mean())
    after = float((pack_spikes(h2) == 0).float().mean())
    return before, after, float(h.mean())


def run(steps=150, rounds=3, density=0.05, device=None, log=print) -> dict:
    """Train, prune and fine-tune; returns the run's numbers, the masked
    weights, and the simulated speedup on the trained layer."""
    dev = resolve_device(device)
    x, y = make_data(512, 0, dev)
    xt, yt = make_data(256, 1, dev)
    params0 = init(2, dev)
    masks = {k: torch.ones_like(v) for k, v in params0.items()}

    params, loss = train(params0, masks, x, y, steps)
    acc_dense = accuracy(params, xt, yt, masks)
    log(f"dense acc            : {acc_dense:.3f} (loss {loss:.4f})")

    d = 1.0
    for r in range(rounds):
        d = max(density, d * density ** (1 / rounds))
        masks = lth_masks(params, masks, d)
        params, loss = train(params0, masks, x, y, steps)  # rewind to init
        log(f"LTH round {r}: density {d:.3f} acc "
            f"{accuracy(params, xt, yt, masks):.3f}")
    weights = {k: params[k] * masks[k] for k in params}
    for w in weights.values():
        assert_weight_density(w, d)

    # silent-neuron preprocessing + fine-tune (paper Fig. 11)
    acc_masked = accuracy(params, xt, yt, masks, min_spikes=2)
    params_ft, loss_ft = train(params, masks, x, y, max(steps // 5, 20),
                               min_spikes=2)
    acc_ft = accuracy(params_ft, xt, yt, masks, min_spikes=2)
    log(f"mask<2-spike neurons : acc {acc_masked:.3f} -> fine-tuned "
        f"{acc_ft:.3f} (dense {acc_dense:.3f})")

    # measured workload stats -> LoAS cycle model vs SparTen-SNN's
    silent, silent_ft, d_a = silent_fractions(params_ft, xt, masks)
    d_b = float((params_ft["w2"] * masks["w2"] != 0).float().mean())
    layer = Layer(name="trained-fc", T=T, M=xt.shape[0], N=N_CLS, K=D_H,
                  d_a=d_a, ns=1 - silent, ns_ft=1 - silent_ft, d_b=d_b)
    hw = HwConfig()
    speedup = (sparten_cost(layer, hw).cycles
               / loas_cost(layer, hw, preprocessed=True).cycles)
    log(f"workload stats       : spike density {d_a:.2f}, non-silent "
        f"{1 - silent:.2f} (FT {1 - silent_ft:.2f}), weight density {d_b:.2f}")
    log(f"simulated speedup    : LoAS vs SparTen-SNN {speedup:.2f}x on the "
        "trained layer (ASIC cycle model)")
    return {"loss": loss, "loss_ft": loss_ft, "acc_dense": acc_dense,
            "acc_masked": acc_masked, "acc_ft": acc_ft, "density": d,
            "weights": weights, "silent": silent, "silent_ft": silent_ft,
            "d_a": d_a, "d_b": d_b, "sim_speedup": speedup}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=3,
                    help="LTH prune-retrain rounds")
    ap.add_argument("--density", type=float, default=0.05,
                    help="final weight density")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.steps, args.rounds, args.density, args.device)


if __name__ == "__main__":
    main()
