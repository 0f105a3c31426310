"""Dense-SNN systolic-array baselines: PTB (HPCA'22) and Stellar (HPCA'24),
running the DENSE VGG16 SNN (paper Fig. 19 comparison).

Configured per the paper: PTB as a 16x4 array producing 16 full-sum outputs
for 4 timesteps in parallel (time-window columns; timesteps inside a window
are sequential); Stellar at the same array size with its spatiotemporal
row-stationary dataflow + FS-neuron spike skipping.  Neither exploits weight
sparsity, and both fetch dense weights/spikes — ScaleSim-style traffic
accounting (weights + input spikes + outputs per tile pass).
"""
from __future__ import annotations

from .base import HwConfig, SimResult, finalize
from .workloads import Layer


def ptb_layer_cost(layer: Layer, hw: HwConfig, array=(16, 4),
                   window: int = 4) -> SimResult:
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    e = hw.energy
    rows, cols = array
    # each column owns one time-window; inside a window, timesteps serialize.
    windows = max(1, T // max(1, window // 1))
    t_seq = T / min(cols, T)           # timesteps processed sequentially
    # dense systolic pass: K-deep accumulation, rows outputs per pass;
    # utilization penalty when N < rows or T < cols.
    util = min(1.0, N / rows) * min(1.0, T / cols)
    r.compute_cycles = (M * N / rows) * K * t_seq / max(util, 1e-3) / cols
    r.op_counts = {"acc": M * N * K * T, "lif": M * N * T}

    w_bytes = K * N * (hw.weight_bits / 8)
    # dense weights re-streamed once per row-tile pass (output stationary
    # along rows), spikes streamed dense per timestep
    passes = max(1.0, M / rows)
    r.dram_bytes = {
        "A": M * K * T / 8,
        "B": w_bytes * min(passes, max(1.0, w_bytes / hw.sram_bytes) * 4),
        "format": 0.0,
        "psum": 0.0,
        "out": M * N * T / 8,
    }
    r.sram_bytes = (M * K * T / 8) + M * N * K * T * (hw.weight_bits / 8) / rows \
        + r.dram_total
    r.energy_pj = {
        "accum": r.op_counts["acc"] * e.ac_pj,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=150.0)


def stellar_layer_cost(layer: Layer, hw: HwConfig, array=(16, 4)) -> SimResult:
    """Stellar: fully temporal-parallel FS neurons + spike skipping (skips
    compute on zero spikes; weights still dense)."""
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    e = hw.energy
    rows, cols = array
    skip = layer.d_a          # only firing inputs schedule work
    util = min(1.0, N / rows)
    # FS neurons detach accumulate/fire: T processed fully in parallel
    # across the array's temporal dimension (no T factor in latency)
    r.compute_cycles = (M * N / (rows * cols)) * K * skip / max(util, 1e-3)
    r.op_counts = {"acc": M * N * K * T * skip, "lif": M * N * T}
    w_bytes = K * N * (hw.weight_bits / 8)
    r.dram_bytes = {
        "A": M * K * layer.ns * T / 8 + M * K / 8,   # spike-skipping fetch
        "B": w_bytes * max(1.0, (M / rows) / 8),
        "format": 0.0,
        "psum": 0.0,
        "out": M * N * T / 8,
    }
    r.sram_bytes = M * K * T / 8 + M * N * K * skip * T * (
        hw.weight_bits / 8) / (rows * cols) + r.dram_total
    r.energy_pj = {
        "accum": r.op_counts["acc"] * e.ac_pj,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=150.0)


def densify(layer: Layer) -> Layer:
    """Fig. 19 runs the DENSE VGG16: weights dense, spikes at their natural
    density."""
    from dataclasses import replace

    return replace(layer, d_b=1.0)
