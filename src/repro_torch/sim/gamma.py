"""Gamma-SNN (paper baseline): Gustavson (row-wise product) ANN spMspM
accelerator (Gamma, ASPLOS'21) running the SNN timestep-sequentially.

Gust in SNNs (paper §VI): lowest DRAM of the three ANN baselines (FiberCache
keeps partial rows on chip) but the t-dim multiplies partial-row merge
traffic through the SRAM — on average 13.4x LoAS's SRAM traffic.
"""
from __future__ import annotations

import numpy as np

from .base import HwConfig, SimResult, finalize
from .workloads import Layer


def layer_cost(layer: Layer, hw: HwConfig) -> SimResult:
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    d_a, d_b = layer.d_a, layer.d_b
    e = hw.energy

    # --- compute: merge one scaled B-row per nonzero a into the partial row -
    products = T * M * K * d_a * N * d_b
    r.compute_cycles = products / hw.n_pes
    r.op_counts = {"acc": products, "merge": products, "lif": M * N * T}

    # --- DRAM: near-ideal input reuse via FiberCache -------------------------
    coord_bits = max(1, int(np.ceil(np.log2(max(K, 2)))))
    a_payload = T * M * K * d_a / 8
    a_coords = T * M * K * d_a * coord_bits / 8
    b_bytes = K * N * d_b * (hw.weight_bits / 8) + K * N / 8
    # partial rows overflowing the FiberCache spill; t-dim scales the
    # resident set (T partial rows per output row in flight)
    row_bytes = N * d_b * (hw.psum_bits / 8)
    resident = min(float(hw.sram_bytes), T * hw.n_pes * row_bytes * 4)
    spill_frac = max(0.0, 1.0 - hw.sram_bytes / max(T * hw.n_pes * row_bytes * 4, 1e-9))
    psum_traffic = 2 * T * M * row_bytes * spill_frac * 0.25
    out_bytes = M * N * T / 8 + M * N / 8
    r.dram_bytes = {
        "A": a_payload,
        "B": b_bytes - K * N / 8,
        "format": a_coords + K * N / 8 + (M * T + N) * hw.ptr_bits / 8,
        "psum": psum_traffic,
        "out": out_bytes,
    }

    # --- SRAM: every merge reads+writes a partial-row element (the 13x) -----
    sram = products * 2 * (hw.psum_bits / 8) + T * M * K * d_a * N * d_b * (
        hw.weight_bits / 8)
    r.sram_bytes = sram + r.dram_total

    r.energy_pj = {
        "accum": products * e.ac_pj,
        "merge": products * e.merger_pj,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=280.0, sram_Bpc=128.0)


def layer_cost_ann(layer: Layer, hw: HwConfig, act_density: float = 0.561,
                   act_bits: int = 8) -> SimResult:
    """Gamma running the ANN version of the workload (Fig. 18)."""
    r = SimResult()
    M, N, K = layer.M, layer.N, layer.K
    d_b = layer.d_b
    e = hw.energy
    products = M * K * act_density * N * d_b
    r.compute_cycles = products / hw.n_pes
    coord_bits = max(1, int(np.ceil(np.log2(max(K, 2)))))
    r.dram_bytes = {
        "A": M * K * act_density * act_bits / 8,
        "B": K * N * d_b * (hw.weight_bits / 8),
        "format": M * K * act_density * coord_bits / 8 + K * N / 8,
        "psum": 0.0,
        "out": M * N * act_density * act_bits / 8,
    }
    r.sram_bytes = products * 2 * (hw.psum_bits / 8) + r.dram_total
    r.op_counts = {"mac": products, "merge": products}
    r.energy_pj = {
        "mac": products * e.mac_pj,
        "merge": products * e.merger_pj,
    }
    return finalize(r, hw, power_mw=280.0, sram_Bpc=128.0)
