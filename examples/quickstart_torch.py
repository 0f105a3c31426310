"""Quickstart on the PyTorch/CUDA port: the LoAS pipeline on one
dual-sparse SNN layer, the six steps of `quickstart.py`.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain torch

On the card, step 5 runs kernel 3 (the dual-sparse BSR kernel) through a
plan built per call and step 6 through a plan built once; each is held
against the plain FTP layer: full sums within 1e-3, spike words equal
except where the LIF input lies within 1e-3 of v_th (the kernel adds the
same products in another order).  On the CPU the kernels' plain versions
run and the words must be equal.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    compression_efficiency,
    direct_encode,
    ftp_layer,
    ftp_spmspm,
    pack_spikes,
    silent_fraction,
)
from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.snn_layers import prune_by_magnitude
from repro_torch.kernels import ops
from repro_torch.kernels.join_plan import build_weight_plan
from repro_torch.serve.policy import PACKED_DUAL

T, M, K, N = 4, 64, 512, 256
TOL = 1e-3  # full sums of <= 512 {0,1} x f32 products, two sum orders


def near_threshold(o: torch.Tensor) -> torch.Tensor:
    """(M, N) bool: where some step's LIF input lies within TOL of v_th."""
    u = torch.zeros_like(o[0])
    near = torch.zeros_like(o[0], dtype=torch.bool)
    for t in range(o.shape[0]):
        x = o[t] + u
        near |= (x - DEFAULT_VTH).abs() < TOL
        u = torch.where(x > DEFAULT_VTH, torch.zeros_like(x), DEFAULT_TAU * x)
    return near


def hold(label, words, sums, want_words, want_sums, exact):
    """The kernel's words and full sums against the plain layer's."""
    err = float((sums - want_sums).abs().max())
    differ = words != want_words
    assert err <= TOL, f"{label}: full sums differ by {err:.3e}"
    if exact:
        assert not bool(differ.any()), f"{label}: spike words differ"
    else:
        away = differ & ~near_threshold(want_sums)
        assert not bool(away.any()), f"{label}: words differ away from v_th"
    return f"max |full sum diff| {err:.1e}, {int(differ.sum())} words flip"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    dev = resolve_device(ap.parse_args().device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. analog input -> direct encoding -> spike trains (paper §II-A2)
    x = torch.randn((M, K), generator=gen, device=dev) * 0.4
    spikes = direct_encode(x, T)                       # (T, M, K) {0,1}
    print(f"spike sparsity      : {float(1 - spikes.mean()):.1%}")

    # 2. FTP-friendly compression: pack T spikes/neuron into one word (§IV-A)
    packed = pack_spikes(spikes)                       # (M, K) int32
    print(f"silent neurons      : {float(silent_fraction(packed)):.1%}")
    eff = compression_efficiency(spikes.to(torch.int64))
    print(f"compression eff.    : LoAS {eff['loas_efficiency']:.0%} "
          f"vs CSR {eff['csr_efficiency']:.0%}")

    # 3. LTH-style 98%-sparse weights (paper §V)
    w = prune_by_magnitude(torch.randn((K, N), generator=gen, device=dev), 0.02)
    print(f"weight sparsity     : {float((w == 0).float().mean()):.1%}")

    # 4. one LoAS layer: FTP spMspM + P-LIF -> packed output spikes
    out_packed, _ = ftp_layer(packed, w, T)
    sums = ftp_spmspm(packed, w, T)
    print(f"output silent       : {float(silent_fraction(out_packed)):.1%}")

    exact = dev.type == "cpu"
    where = "kernel 3" if dev.type == "cuda" else "plain BSR"
    # 5. the same layer through the dual-sparse BSR kernel via the policy
    #    front door; raw weights -> plan built per call
    words, _ = ops.dispatch(packed, w, PACKED_DUAL, T, fuse_lif=True)
    got_sums, _ = ops.dispatch(packed, w, PACKED_DUAL, T)
    print(f"{where + ', per call':20s}: "
          f"{hold('per call', words, got_sums, out_packed, sums, exact)} ✓")

    # 6. the serving form: build the weight join plan ONCE (model load),
    #    then every call is device-only
    plan = build_weight_plan(w)
    words, _ = ops.dispatch(packed, plan, PACKED_DUAL, T, n_out=N,
                            fuse_lif=True)
    got_sums, _ = ops.dispatch(packed, plan, PACKED_DUAL, T, n_out=N)
    print(f"{where + ', plan':20s}: "
          f"{hold('plan', words, got_sums, out_packed, sums, exact)} ✓")
    print(f"weight join plan    : {float(plan.bmap.float().mean()):.0%} of "
          f"blocks live, join width {plan.jmax} of {plan.nkb} k-blocks")


if __name__ == "__main__":
    main()
