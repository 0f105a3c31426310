"""Cycle-level simulator of LoAS and its baselines (the paper's own
evaluation methodology, §V-VI); port of `repro.sim`, numpy only.

These are analytic models of the ASICs (Table III: 16 PEs at 800 MHz,
128 GB/s DRAM).  They take no device: their cycles, bytes and energies
are the models', never a time or rate of the GPU."""
from .base import HwConfig, SimResult
from .runner import (
    DESIGNS,
    dense_snn_table,
    run_design,
    run_layer,
    snn_vs_ann_table,
    speedup_energy_table,
)
from .workloads import NETWORKS, TABLE_II_LAYERS, get_layer, get_network

__all__ = [
    "HwConfig", "SimResult", "DESIGNS", "NETWORKS", "TABLE_II_LAYERS",
    "run_design", "run_layer", "get_layer", "get_network",
    "speedup_energy_table", "dense_snn_table", "snn_vs_ann_table",
]
