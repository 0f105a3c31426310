"""Paper workloads (Table II): dual-sparse SNN layers as GEMMs (port of
`repro.sim.workloads`).

Conv layers are im2col GEMMs: M = out spatial, K = Cin*k*k, N = Cout.  The
single-layer workloads the paper spotlights are exact Table II rows
(A-L4 = (4,64,256,3456), V-L8 = (4,16,512,2304), R-L19 = (4,16,512,2304),
T-HFF = (4,784,3072,3072)); full networks are CIFAR-variant layer stacks
whose per-layer sparsities are deterministically jittered around, then
EXACTLY renormalized to, the Table II network averages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class Layer:
    name: str
    T: int
    M: int
    N: int
    K: int
    d_a: float      # per-timestep spike density (1 - AvSpA-origin)
    ns: float       # NON-silent neuron fraction (1 - silent fraction)
    ns_ft: float    # after fine-tuned preprocessing
    d_b: float      # weight density (1 - AvSpB)

    @property
    def fire_rate_nonsilent(self) -> float:
        """P(spike at a timestep | neuron non-silent) — drives the
        correction-accumulator count in the inner join."""
        return min(1.0, self.d_a / max(self.ns, 1e-9))


@dataclass(frozen=True)
class Network:
    name: str
    layers: tuple

    def totals(self):
        return {
            "macs": sum(l.T * l.M * l.N * l.K for l in self.layers),
        }


def _conv(name, hw, cin, cout, k=3, T=4):
    return dict(name=name, T=T, M=hw * hw, N=cout, K=cin * k * k)


def _fc(name, din, dout, T=4):
    return dict(name=name, T=T, M=1, N=dout, K=din)


_ALEXNET = [
    _conv("conv1", 32, 3, 64), _conv("conv2", 16, 64, 192),
    _conv("conv3", 8, 192, 384), _conv("conv4", 8, 384, 256),
    _conv("conv5", 8, 256, 256),
    _fc("fc1", 256 * 4 * 4, 1024), _fc("fc2", 1024, 10),
]

_VGG16 = (
    [_conv("conv1_1", 32, 3, 64), _conv("conv1_2", 32, 64, 64)]
    + [_conv("conv2_1", 16, 64, 128), _conv("conv2_2", 16, 128, 128)]
    + [_conv(f"conv3_{i}", 8, 128 if i == 1 else 256, 256) for i in (1, 2, 3)]
    + [_conv(f"conv4_{i}", 4, 256 if i == 1 else 512, 512) for i in (1, 2, 3)]
    + [_conv(f"conv5_{i}", 2, 512, 512) for i in (1, 2, 3)]
    + [_fc("fc", 512, 10)]
)

_RESNET19 = (
    [_conv("conv1", 32, 3, 128)]
    + [_conv(f"s1_{i}", 32, 128, 128) for i in range(6)]
    + [_conv("s2_0", 16, 128, 256)]
    + [_conv(f"s2_{i}", 16, 256, 256) for i in range(1, 6)]
    + [_conv("s3_0", 8, 256, 512)]
    + [_conv(f"s3_{i}", 8, 512, 512) for i in range(1, 5)]
    + [_fc("fc", 512, 10)]
)

# Table II network averages: (AvSpA-origin, silent, silent+FT, AvSpB) in %.
_TABLE_II = {
    "alexnet": (81.2, 71.3, 76.7, 98.2),
    "vgg16": (82.3, 74.1, 79.6, 98.2),
    "resnet19": (68.6, 59.6, 66.1, 96.8),
}

# Table II single-layer rows: (T,M,N,K), origin, silent, silent+FT, AvSpB.
TABLE_II_LAYERS = {
    "A-L4": ((4, 64, 256, 3456), 75.8, 63.2, 69.7, 98.9),
    "V-L8": ((4, 16, 512, 2304), 88.1, 76.5, 86.8, 96.8),
    "R-L19": ((4, 16, 512, 2304), 57.9, 51.4, 55.7, 99.1),
    "T-HFF": ((4, 784, 3072, 3072), 85.0, 82.0, 86.8, 96.8),
}


def _build_network(name: str, proto: list) -> Network:
    """Jitter per-layer sparsities deterministically, then renormalize the
    MAC-weighted network averages to the Table II values exactly."""
    sp_a, silent, silent_ft, sp_b = (v / 100 for v in _TABLE_II[name])
    # The reference's seed rule, kept as it is so that both packages give
    # the same layers in one process: ``hash`` of a str is randomized per
    # process (PYTHONHASHSEED), so the jitter, and every table built on
    # it, differs between processes.
    rng = np.random.default_rng(abs(hash(name)) % 2**31)
    jitter = rng.uniform(0.85, 1.15, size=len(proto))
    layers = []
    weights = np.array([p["M"] * p["N"] * p["K"] for p in proto], float)
    weights /= weights.sum()

    def renorm(target, raw):
        raw = np.clip(raw, 0.02, 0.98)
        cur = float((weights * raw).sum())
        return np.clip(raw * (target / cur), 0.02, 0.995)

    a = renorm(1 - sp_a, (1 - sp_a) * jitter)       # spike density
    ns = renorm(1 - silent, (1 - silent) * jitter)  # non-silent fraction
    ns_ft = renorm(1 - silent_ft, (1 - silent_ft) * jitter)
    db = renorm(1 - sp_b, (1 - sp_b) * rng.uniform(0.7, 1.3, len(proto)))
    for i, pr in enumerate(proto):
        layers.append(Layer(d_a=float(a[i]), ns=float(ns[i]),
                            ns_ft=float(min(ns_ft[i], ns[i])),
                            d_b=float(db[i]), **pr))
    return Network(name=name, layers=tuple(layers))


def get_network(name: str) -> Network:
    proto = {"alexnet": _ALEXNET, "vgg16": _VGG16, "resnet19": _RESNET19}[name]
    return _build_network(name, proto)


def get_layer(name: str) -> Layer:
    (T, M, N, K), sp_a, silent, silent_ft, sp_b = TABLE_II_LAYERS[name]
    return Layer(
        name=name, T=T, M=M, N=N, K=K,
        d_a=1 - sp_a / 100, ns=1 - silent / 100, ns_ft=1 - silent_ft / 100,
        d_b=1 - sp_b / 100,
    )


NETWORKS = ("alexnet", "vgg16", "resnet19")
