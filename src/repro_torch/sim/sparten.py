"""SparTen-SNN (paper baseline): inner-product ANN spMspM accelerator
(SparTen, MICRO'19) naively running the SNN timestep-sequentially, with the
paper's conservative simplifications: multipliers removed, t-dim innermost,
16 PEs, same global SRAM.

Key penalties vs LoAS (paper §II-D, VI):
  * the inner join re-runs once PER TIMESTEP per output (T x fast-prefix
    energy/latency);
  * spikes double as bitmask and data, so the DENSE spike train (1s and 0s)
    is fetched — no traffic saving on A — and re-fetched per output-column
    tile (poor IP input reuse; the 256 KB cache holds a row-tile of A and
    the current B fibers).
"""
from __future__ import annotations

from .base import HwConfig, SimResult, finalize
from .workloads import Layer


def layer_cost(layer: Layer, hw: HwConfig) -> SimResult:
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    d_a, d_b = layer.d_a, layer.d_b
    e = hw.energy

    # --- compute: per timestep, per output, the join re-runs entirely -------
    # (paper Fig. 4): mask chunk-walk (ceil(K/128) through the 128-wide
    # prefix circuits), the matched-pair drain, AND the A-side spike-offset
    # alignment: spikes double as bitmask+data, so every set spike bit is
    # walked to align payload offsets, 16 bits/cycle (the same 16-wide
    # encoder bandwidth as LoAS's laggy prefix) — calibration assumption C1
    # of the reference model.  LoAS pays its (cheaper, non-silent-only) join once
    # for all T.
    matched_t = K * d_a * d_b
    p_nonempty = 1.0 - (1.0 - d_a * d_b) ** 128     # empty-chunk skip
    chunk_cycles = (-(-K // 128)) * p_nonempty
    a_drain = K * d_a / 16.0
    cyc_per_out_t = max(matched_t, chunk_cycles, a_drain, 1.0)
    r.compute_cycles = (M * N / hw.n_pes) * T * cyc_per_out_t

    r.op_counts = {
        "acc": M * N * T * matched_t,
        "lif": M * N * T,
        "fast_prefix_cycles": r.compute_cycles,  # one fast prefix per PE
    }

    # --- DRAM ---------------------------------------------------------------
    # A dense (spike train IS the bitmask): M*K*T bits, re-fetched once per
    # resident-B-tile pass.  B fibers: N columns, d_b dense + bitmask;
    # cache-resident when compressed B fits (it usually does at 98 %).
    b_bytes = K * N * d_b * (hw.weight_bits / 8) + K * N / 8
    b_passes = max(1.0, b_bytes / (hw.sram_bytes / 2))
    a_bytes_once = M * K * T / 8
    a_refetch = max(1.0, b_passes)
    out_bytes = M * N * T / 8 + M * N / 8
    r.dram_bytes = {
        "A": a_bytes_once * a_refetch,
        "B": b_bytes - K * N / 8,
        "format": K * N / 8 + (M + N) * hw.ptr_bits / 8,
        "psum": 0.0,
        "out": out_bytes,
    }

    # --- SRAM: the t-innermost loop re-reads the spike row and re-broadcasts
    # the B fiber EVERY timestep (no FTP reuse) + matched payload fetches ----
    sram = (
        M * T * (K / 8)                                   # spike rows per t
        + (M / hw.n_pes) * N * T * (K / 8 + K * d_b * hw.weight_bits / 8)
        + M * N * T * matched_t * hw.weight_bits / 8
    )
    r.sram_bytes = sram + r.dram_total

    r.energy_pj = {
        "accum": r.op_counts["acc"] * e.ac_pj,
        "prefix": r.op_counts["fast_prefix_cycles"] * e.fast_prefix_pj,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=185.0)


def layer_cost_ann(layer: Layer, hw: HwConfig, act_density: float = 0.561,
                   act_bits: int = 8) -> SimResult:
    """SparTen running the ANN version (Fig. 18): 8-bit activations at
    ~43.9 % sparsity, multipliers kept, single 'timestep'."""
    r = SimResult()
    M, N, K = layer.M, layer.N, layer.K
    d_b = layer.d_b
    e = hw.energy
    matched = K * act_density * d_b
    r.compute_cycles = (M * N / hw.n_pes) * max(matched, 1.0)
    r.op_counts = {"mac": M * N * matched,
                   "fast_prefix_cycles": 2 * r.compute_cycles}
    b_bytes = K * N * d_b * (hw.weight_bits / 8) + K * N / 8
    b_passes = max(1.0, b_bytes / (hw.sram_bytes / 2))
    a_bytes = (M * K * act_density * act_bits / 8 + M * K / 8) * b_passes
    r.dram_bytes = {
        "A": a_bytes, "B": b_bytes - K * N / 8,
        "format": K * N / 8 + (M + N) * hw.ptr_bits / 8,
        "psum": 0.0,
        "out": M * N * act_density * act_bits / 8 + M * N / 8,
    }
    r.sram_bytes = M * N * (2 * K / 8 + matched * 2 * act_bits / 8) + r.dram_total
    r.energy_pj = {
        "mac": r.op_counts["mac"] * e.mac_pj,
        "prefix": r.op_counts["fast_prefix_cycles"] * e.fast_prefix_pj,
    }
    return finalize(r, hw, power_mw=185.0)
