"""`ExecutionPolicy`: one declarative serve/kernel execution policy (port of
`repro.serve.policy`, main-path axes only).

Ported axes: ``spike_format`` (float | packed), ``weight_sparsity``
(dense | dual_sparse), ``execution`` (sync) and ``temporal`` (full).  The
reference's other axes and values (placement/mesh, approximate exactness,
pipelined execution, paging, adaptive temporal, speculation) are later
slices of the port: asking for one raises `NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass

SPIKE_FORMATS = ("float", "packed")
WEIGHT_SPARSITIES = ("dense", "dual_sparse")

_LATER = "not ported yet; see the port's queue in ROADMAP.md"


@dataclass(frozen=True)
class ExecutionPolicy:
    """Frozen, hashable execution policy; construction validates every
    arch-independent combination, `validate_for(cfg)` the arch-dependent
    ones."""

    spike_format: str = "float"
    weight_sparsity: str = "dense"
    execution: str = "sync"
    temporal: str = "full"

    def __post_init__(self):
        if self.execution != "sync":
            raise NotImplementedError(f"execution={self.execution!r} is {_LATER}")
        if self.temporal != "full":
            raise NotImplementedError(f"temporal={self.temporal!r} is {_LATER}")
        if self.spike_format not in SPIKE_FORMATS:
            raise ValueError(
                f"spike_format {self.spike_format!r} not in {SPIKE_FORMATS}"
            )
        if self.weight_sparsity not in WEIGHT_SPARSITIES:
            raise ValueError(
                f"weight_sparsity {self.weight_sparsity!r} not in "
                f"{WEIGHT_SPARSITIES}"
            )
        if self.weight_sparsity == "dual_sparse" and self.spike_format != "packed":
            raise ValueError(
                "weight_sparsity='dual_sparse' runs the BSR spike-join "
                "kernel, which consumes packed spike words; it requires "
                f"spike_format='packed' (got {self.spike_format!r})"
            )

    @property
    def token_identical(self) -> bool:
        """Every ported policy is bitwise (approximate is a later slice)."""
        return True

    def describe(self) -> str:
        return (f"spike_format={self.spike_format!r}, "
                f"weight_sparsity={self.weight_sparsity!r}, "
                f"execution={self.execution!r}, temporal={self.temporal!r}")

    def validate_for(self, cfg) -> "ExecutionPolicy":
        """Arch-dependent checks (an `ArchConfig`); returns self."""
        if self.spike_format == "packed" and not cfg.spiking_ffn:
            raise ValueError(
                f"spike_format='packed' needs a spiking-FFN arch; {cfg.name} "
                "has spiking_ffn=False (set cfg.spiking_ffn or use "
                "spike_format='float')"
            )
        if self.weight_sparsity == "dual_sparse":
            if cfg.spiking_weight_density >= 1.0:
                raise ValueError(
                    "weight_sparsity='dual_sparse' joins against LTH hard "
                    f"zeros, but {cfg.name} has spiking_weight_density="
                    f"{cfg.spiking_weight_density} (unpruned); prune at init "
                    "(spiking_weight_density < 1) or use weight_sparsity='dense'"
                )
        elif self.spike_format == "packed":
            raise NotImplementedError(
                "spike_format='packed' with dense weights runs the "
                f"dense-weight FTP kernels, which are {_LATER}"
            )
        return self

    @classmethod
    def for_arch(cls, cfg, *, spike_format: str | None = None,
                 weight_sparsity: str | None = None) -> "ExecutionPolicy":
        """Arch-aware constructor, ``None`` = the natural default: packed
        spikes for spiking archs, dual-sparse when the weights are pruned."""
        if spike_format is None:
            spike_format = "packed" if cfg.spiking_ffn else "float"
        if weight_sparsity is None:
            weight_sparsity = (
                "dual_sparse"
                if spike_format == "packed" and cfg.spiking_weight_density < 1.0
                else "dense"
            )
        return cls(spike_format=spike_format,
                   weight_sparsity=weight_sparsity).validate_for(cfg)


FLOAT_DENSE = ExecutionPolicy()
PACKED_DUAL = ExecutionPolicy(spike_format="packed", weight_sparsity="dual_sparse")
