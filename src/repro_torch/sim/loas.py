"""Cycle/energy model of LoAS (paper §IV-VI).

Dataflow: FTP inner product.  Each of the 16 TPPEs produces one output
neuron's FULL sums for all T timesteps; the inner join walks the
(non-silent x non-zero) matched positions at one weight/cycle through the
fast prefix-sum, with the laggy prefix-sum (8 cycles) and corrections
overlapped with the next fiber fetch (paper Fig. 10).

Memory behavior:
  * A is fetched ONCE (packed payload + bitmask) — non-silent neurons only;
  * B is fetched ONCE (compressed fibers; 96-99 % sparse, so it cache-
    resides) and broadcast to TPPEs;
  * no temporal partial sums: outputs leave as packed spikes.
"""
from __future__ import annotations

from .base import HwConfig, SimResult, finalize
from .workloads import Layer


def layer_cost(layer: Layer, hw: HwConfig, preprocessed: bool = False) -> SimResult:
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    ns = layer.ns_ft if preprocessed else layer.ns
    d_b = layer.d_b
    e = hw.energy

    # --- inner join / compute ---------------------------------------------
    matched = K * ns * d_b                       # per output neuron
    # the join walks the K-bit masks through 128-wide prefix circuits:
    # ceil(K/128) chunk cycles — ONCE for all T timesteps (the FTP win);
    # all-zero AND-result chunks are skipped by the priority encoder; fast
    # prefix emits 1 matched offset/cycle; laggy prefix + corrections overlap
    # with the next fiber fetch (Fig. 10), pipelined across outputs.
    p_nonempty = 1.0 - (1.0 - ns * d_b) ** 128
    chunk_cycles = (-(-K // 128)) * p_nonempty
    cyc_per_out = max(matched, chunk_cycles, 2.0)
    r.compute_cycles = (M * N / hw.n_pes) * cyc_per_out

    pseudo_adds = M * N * matched
    # corrections: one per matched position per timestep WITHOUT a spike
    fire = layer.fire_rate_nonsilent if not preprocessed else min(
        1.0, layer.d_a / max(ns, 1e-9))
    corr_adds = M * N * matched * T * (1.0 - fire)
    r.op_counts = {
        "pseudo_acc": pseudo_adds,
        "correction_acc": corr_adds,
        "lif": M * N * T,
        "fast_prefix_cycles": r.compute_cycles,
        "laggy_prefix_cycles": (M * N / hw.n_pes) * hw.laggy_cycles,
    }

    # --- DRAM traffic -------------------------------------------------------
    a_payload = M * K * ns * T / 8               # packed T-bit words
    a_bitmask = M * K / 8
    b_payload = K * N * d_b * (hw.weight_bits / 8)
    b_bitmask = K * N / 8
    ptrs = (M + N) * hw.ptr_bits / 8
    out_spikes = M * N * T / 8 + M * N / 8       # packed C + its bitmask
    r.dram_bytes = {
        "A": a_payload,
        "B": b_payload,
        "format": a_bitmask + b_bitmask + ptrs,
        "psum": 0.0,
        "out": out_spikes,
    }

    # --- SRAM traffic -------------------------------------------------------
    # A fiber: bitmask loaded once per row into the TPPE's bitmask buffer
    # (held across all N outputs); matched packed words fetched per join.
    # B fiber: bitmask+payload broadcast once per (n, 16-row tile) — and,
    # crucially, ONCE for all T timesteps (FTP).
    sram_a = M * (K / 8) + M * N * matched * T / 8
    sram_b = (M / hw.n_pes) * N * (K / 8 + K * d_b * hw.weight_bits / 8)
    sram_out = out_spikes
    r.sram_bytes = sram_a + sram_b + sram_out + r.dram_total  # fill traffic

    r.energy_pj = {
        "accum": (pseudo_adds + corr_adds) * e.ac_pj,
        "prefix": r.op_counts["fast_prefix_cycles"] * e.fast_prefix_pj
        + r.op_counts["laggy_prefix_cycles"] * e.laggy_prefix_pj,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=189.0)
