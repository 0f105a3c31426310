"""Energy and area model for the cycle-level simulator.

Constants follow the paper's setup: 32 nm synthesis at 800 MHz, CACTI-style
SRAM modeling, HBM off-chip.  Per-op energies are Horowitz-ISSCC-2014-derived
numbers scaled to 32 nm, chosen so the paper's reported breakdowns hold
(~60 % of system energy in data movement, global SRAM dominating on-chip
power — Table IV / Fig. 15).  Absolute joules are less meaningful than the
RATIOS between designs, which is what the paper's figures compare.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyModel:
    # data movement (pJ per byte)
    dram_pj_per_byte: float = 160.0      # ~20 pJ/bit HBM
    sram_pj_per_byte: float = 6.0        # 256 KB banked global buffer
    reg_pj_per_byte: float = 0.6         # small FIFOs/buffers

    # compute (pJ per op)
    ac_pj: float = 0.03                  # 8-bit add (AND+accumulate)
    mac_pj: float = 0.23                 # 8-bit MAC (ANN baselines)
    fast_prefix_pj: float = 1.46         # per cycle, from Table IV power/freq
    laggy_prefix_pj: float = 0.32        # per cycle
    lif_pj: float = 0.05                 # compare + mul (leak) per neuron-step
    merger_pj: float = 0.8               # per merged element (OP/Gust designs)

    # on-chip system power draw while active (mW) — Table IV totals for LoAS;
    # baselines estimated at the same normalization (16 PEs, same cache):
    # SparTen keeps one fast prefix per PE; GoSPA adds intersection units;
    # Gamma's high-radix mergers are the big adder (38x multiplier area).
    power_mw: float = 189.0

    def dram(self, nbytes: float) -> float:
        return nbytes * self.dram_pj_per_byte

    def sram(self, nbytes: float) -> float:
        return nbytes * self.sram_pj_per_byte

    def active(self, cycles: float, freq_hz: float) -> float:
        """pJ of on-chip switching while the array is busy."""
        return self.power_mw * 1e-3 * (cycles / freq_hz) * 1e12


# --- Area/power breakdown constants reproduced from paper Table IV ---------
# (mm^2, mW) at 32 nm / 800 MHz; used by benchmarks/table4.
TABLE_IV = {
    "loas": {
        "16 TPPEs": (0.96, 45.1),
        "16 PLIFs": (0.02, 1.2),
        "Global cache": (0.80, 124.5),
        "Others": (0.30, 18.1),
        "Total": (2.08, 188.9),
    },
    "tppe": {
        "Accumulators": (2e-3, 0.16),
        "Fast Prefix": (0.04, 1.46),
        "Laggy Prefix": (5e-3, 0.32),
        "Others": (0.01, 0.88),
        "TPPE total": (0.06, 2.82),
    },
}


def tppe_area_power(T: int) -> tuple[float, float]:
    """TPPE area/power scaling with timesteps (paper Fig. 16a): only the
    correction accumulators and input buffer grow with T.  Calibrated to the
    paper's 1.37x area / 1.25x power at T=16 vs T=4."""
    base_area, base_power = TABLE_IV["tppe"]["TPPE total"]
    # linear growth in (accumulators + input buffer), anchored at the paper's
    # T=16 data point: 1.37x area, 1.25x power vs T=4.
    per_t_area = (1.37 - 1.0) * base_area / 12
    per_t_power = (1.25 - 1.0) * base_power / 12
    area = base_area + per_t_area * (T - 4)
    power = base_power + per_t_power * (T - 4)
    return area, power
