"""Simulator runner: networks x designs -> cycles / energy / traffic tables,
the inputs for every paper figure (port of `repro.sim.runner`)."""
from __future__ import annotations

from dataclasses import dataclass

from . import dense_snn, gamma, gospa, loas, sparten
from .base import HwConfig, SimResult, run_network
from .workloads import NETWORKS, get_layer, get_network

DESIGNS = ("sparten-snn", "gospa-snn", "gamma-snn", "loas", "loas-ft")


def run_design(design: str, net_name: str, hw: HwConfig | None = None) -> SimResult:
    hw = hw or HwConfig()
    net = get_network(net_name)
    if design == "sparten-snn":
        return run_network(sparten.layer_cost, net, hw)
    if design == "gospa-snn":
        return run_network(gospa.layer_cost, net, hw)
    if design == "gamma-snn":
        return run_network(gamma.layer_cost, net, hw)
    if design == "loas":
        return run_network(loas.layer_cost, net, hw, preprocessed=False)
    if design == "loas-ft":
        return run_network(loas.layer_cost, net, hw, preprocessed=True)
    raise ValueError(design)


def run_layer(design: str, layer_name: str, hw: HwConfig | None = None) -> SimResult:
    hw = hw or HwConfig()
    layer = get_layer(layer_name)
    fn = {
        "sparten-snn": sparten.layer_cost,
        "gospa-snn": gospa.layer_cost,
        "gamma-snn": gamma.layer_cost,
        "loas": lambda l, h: loas.layer_cost(l, h, preprocessed=False),
        "loas-ft": lambda l, h: loas.layer_cost(l, h, preprocessed=True),
    }[design]
    return fn(layer, hw)


def speedup_energy_table(hw: HwConfig | None = None) -> dict:
    """Fig. 12 data: speedup + energy-efficiency vs SparTen-SNN per network."""
    hw = hw or HwConfig()
    out = {}
    for net in NETWORKS:
        base = run_design("sparten-snn", net, hw)
        row = {}
        for d in DESIGNS:
            r = run_design(d, net, hw)
            row[d] = {
                "cycles": r.cycles,
                "energy_pj": r.energy_total,
                "speedup_vs_sparten": base.cycles / r.cycles,
                "energy_eff_vs_sparten": base.energy_total / r.energy_total,
                "dram_bytes": r.dram_total,
                "sram_bytes": r.sram_bytes,
            }
        out[net] = row
    return out


def dense_snn_table(hw: HwConfig | None = None) -> dict:
    """Fig. 19 data: LoAS (dual-sparse) vs PTB / Stellar (dense VGG16)."""
    hw = hw or HwConfig()
    net = get_network("vgg16")
    dense_layers = [dense_snn.densify(l) for l in net.layers]
    ptb = SimResult()
    stl = SimResult()
    for l in dense_layers:
        ptb += dense_snn.ptb_layer_cost(l, hw)
        stl += dense_snn.stellar_layer_cost(l, hw)
    lo = run_design("loas-ft", "vgg16", hw)
    return {
        "ptb": {"cycles": ptb.cycles, "energy_pj": ptb.energy_total,
                "dram": ptb.dram_total, "sram": ptb.sram_bytes},
        "stellar": {"cycles": stl.cycles, "energy_pj": stl.energy_total,
                    "dram": stl.dram_total, "sram": stl.sram_bytes},
        "loas": {"cycles": lo.cycles, "energy_pj": lo.energy_total,
                 "dram": lo.dram_total, "sram": lo.sram_bytes},
        "speedup_vs_ptb": ptb.cycles / lo.cycles,
        "speedup_vs_stellar": stl.cycles / lo.cycles,
        "energy_vs_ptb": ptb.energy_total / lo.energy_total,
        "energy_vs_stellar": stl.energy_total / lo.energy_total,
    }


def snn_vs_ann_table(hw: HwConfig | None = None) -> dict:
    """Fig. 18 data: dual-sparse SNN (LoAS) vs dual-sparse ANN (SparTen,
    Gamma) on VGG16 (ANN acts: 8-bit, 43.9 % sparse)."""
    hw = hw or HwConfig()
    net = get_network("vgg16")
    sp = SimResult()
    ga = SimResult()
    for l in net.layers:
        sp += sparten.layer_cost_ann(l, hw)
        ga += gamma.layer_cost_ann(l, hw)
    lo = run_design("loas-ft", "vgg16", hw)
    return {
        "sparten-ann": {"energy_pj": sp.energy_total, "dram": sp.dram_total,
                        "sram": sp.sram_bytes},
        "gamma-ann": {"energy_pj": ga.energy_total, "dram": ga.dram_total,
                      "sram": ga.sram_bytes},
        "loas-snn": {"energy_pj": lo.energy_total, "dram": lo.dram_total,
                     "sram": lo.sram_bytes},
        "energy_vs_sparten_ann": sp.energy_total / lo.energy_total,
        "energy_vs_gamma_ann": ga.energy_total / lo.energy_total,
    }
