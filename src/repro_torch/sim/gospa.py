"""GoSPA-SNN (paper baseline): outer-product ANN spMspM accelerator (GoSPA,
ISCA'21) running the SNN timestep-sequentially.

OP penalties in SNNs (paper §II-D, Fig. 5, Fig. 14):
  * per-spike CSR coordinates -> the largest compressed-format traffic;
  * T x more partial-sum matrices; GoSPA's small on-chip psum memory spills
    them to DRAM (write + read back for reduction);
  * excellent input reuse (A and B streamed once per timestep pass).
"""
from __future__ import annotations

import numpy as np

from .base import HwConfig, SimResult, finalize
from .workloads import Layer

PSUM_BUFFER_BYTES = 32 * 1024  # GoSPA's dedicated psum scratch (small)


def layer_cost(layer: Layer, hw: HwConfig) -> SimResult:
    r = SimResult()
    T, M, N, K = layer.T, layer.M, layer.N, layer.K
    d_a, d_b = layer.d_a, layer.d_b
    e = hw.energy

    # --- compute: every (nonzero a) x (nonzero B-row entry) product, plus a
    # per-nonzero-spike dispatch/intersection overhead (GoSPA's on-the-fly
    # intersection unit occupies the lane for ~4 cycles per streamed input
    # before the products issue — calibration assumption C2) ----------------
    products = T * M * K * d_a * N * d_b
    dispatch = T * M * K * d_a * 4.0
    r.compute_cycles = (products + dispatch) / hw.n_pes
    r.op_counts = {"acc": products, "lif": M * N * T,
                   "merge": products}

    # --- DRAM ---------------------------------------------------------------
    coord_bits = max(1, int(np.ceil(np.log2(max(K, 2)))))
    a_payload = T * M * K * d_a / 8                  # spike values (1 bit)
    a_coords = T * M * K * d_a * coord_bits / 8      # CSR per spike per t!
    b_bytes = K * N * d_b * (hw.weight_bits / 8)
    b_bitmask = K * N / 8
    # psum spill: per timestep the (M, N) f32 psum beyond the buffer does a
    # DRAM round trip (the Fig. 5 effect: ~T x single-timestep traffic)
    psum_bytes_t = M * N * (hw.psum_bits / 8)
    spill = max(0.0, psum_bytes_t - PSUM_BUFFER_BYTES)
    psum_traffic = T * 2 * spill
    out_bytes = M * N * T / 8 + M * N / 8
    r.dram_bytes = {
        "A": a_payload,
        "B": b_bytes,
        "format": a_coords + b_bitmask + (M * T + N) * hw.ptr_bits / 8,
        "psum": psum_traffic,
        "out": out_bytes,
    }

    # --- SRAM: stream A once/t; B rows read per nonzero-a; psum updates -----
    sram = (
        T * M * K * d_a * (coord_bits / 8)           # A decode
        + T * M * K * d_a * N * d_b * hw.weight_bits / 8  # B-row reads
        + products * (hw.psum_bits / 8) * 0.5        # psum buffer updates
    )
    r.sram_bytes = sram + r.dram_total

    r.energy_pj = {
        "accum": products * e.ac_pj,
        "merge": r.op_counts["merge"] * e.reg_pj_per_byte,
        "lif": M * N * T * e.lif_pj,
    }
    return finalize(r, hw, power_mw=220.0)
