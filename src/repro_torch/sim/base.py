"""Shared simulator scaffolding: hardware config, per-layer result record,
cache/bandwidth helpers."""
from __future__ import annotations

from dataclasses import dataclass, field

from .energy import EnergyModel
from .workloads import Layer, Network


@dataclass(frozen=True)
class HwConfig:
    """Paper Table III (all designs normalized to this, per paper §V)."""

    n_pes: int = 16
    sram_bytes: int = 256 * 1024
    freq_hz: float = 800e6
    dram_Bps: float = 128e9
    weight_bits: int = 8
    psum_bits: int = 32
    ptr_bits: int = 32
    laggy_cycles: int = 8          # 128-bit mask / 16 adders
    fifo_depth: int = 8
    sram_Bpc: float = 64.0         # banked global-buffer bandwidth (B/cycle)
    energy: EnergyModel = field(default_factory=EnergyModel)

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_Bps / self.freq_hz


@dataclass
class SimResult:
    cycles: float = 0.0
    compute_cycles: float = 0.0
    dram_bytes: dict = field(default_factory=dict)   # component -> bytes
    sram_bytes: float = 0.0
    op_counts: dict = field(default_factory=dict)
    energy_pj: dict = field(default_factory=dict)

    @property
    def dram_total(self) -> float:
        return sum(self.dram_bytes.values())

    @property
    def energy_total(self) -> float:
        return sum(self.energy_pj.values())

    def __iadd__(self, o: "SimResult"):
        self.cycles += o.cycles
        self.compute_cycles += o.compute_cycles
        for k, v in o.dram_bytes.items():
            self.dram_bytes[k] = self.dram_bytes.get(k, 0.0) + v
        self.sram_bytes += o.sram_bytes
        for k, v in o.op_counts.items():
            self.op_counts[k] = self.op_counts.get(k, 0.0) + v
        for k, v in o.energy_pj.items():
            self.energy_pj[k] = self.energy_pj.get(k, 0.0) + v
        return self


def finalize(res: SimResult, hw: HwConfig, power_mw: float | None = None,
             sram_Bpc: float | None = None) -> SimResult:
    """Bandwidth-bound the latency; charge data-movement + active energy."""
    dram_cycles = res.dram_total / hw.dram_bytes_per_cycle
    sram_cycles = res.sram_bytes / (sram_Bpc or hw.sram_Bpc)
    res.cycles = max(res.compute_cycles, dram_cycles, sram_cycles)
    e = hw.energy
    res.energy_pj["dram"] = e.dram(res.dram_total)
    res.energy_pj["sram"] = e.sram(res.sram_bytes)
    mw = power_mw if power_mw is not None else e.power_mw
    res.energy_pj["onchip_active"] = mw * 1e-3 * (res.cycles / hw.freq_hz) * 1e12
    return res


def run_network(layer_cost, net: Network, hw: HwConfig, **kw) -> SimResult:
    total = SimResult()
    for layer in net.layers:
        total += layer_cost(layer, hw, **kw)
    return total
