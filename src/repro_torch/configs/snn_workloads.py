"""The paper's own workloads (Table II) as selectable configs, the SNN
counterpart of the LM arch zoo (port of `repro.configs.snn_workloads`,
over the port's own `sim.workloads`):

    from repro_torch.configs.snn_workloads import get_snn_workload
    net = get_snn_workload("vgg16")        # Network of dual-sparse layers
    layer = get_snn_workload("T-HFF")      # single Table II layer
"""
from __future__ import annotations

from repro_torch.sim.workloads import (
    NETWORKS,
    TABLE_II_LAYERS,
    Layer,
    Network,
    get_layer,
    get_network,
)

SNN_WORKLOADS = tuple(NETWORKS) + tuple(TABLE_II_LAYERS)


def get_snn_workload(name: str) -> Network | Layer:
    if name in NETWORKS:
        return get_network(name)
    if name in TABLE_II_LAYERS:
        return get_layer(name)
    raise KeyError(f"unknown SNN workload {name!r}; options: {SNN_WORKLOADS}")


def as_gemm_shapes(name: str) -> list[tuple]:
    """(T, M, N, K) per layer: what the FTP kernels and dataflow consume."""
    w = get_snn_workload(name)
    layers = w.layers if isinstance(w, Network) else (w,)
    return [(l.T, l.M, l.N, l.K) for l in layers]
