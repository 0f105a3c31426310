"""Spiking dataflow core: packing, LIF, the plain FTP reference and the
spiking layers (port of `repro.core`, the same public names).

`fibers` (the bitmask-fiber format) and `innerjoin` (the inner-join
circuit model) are host-side numpy models, imported by module name as in
the reference."""
from .ftp import ftp_layer, ftp_spmspm, ftp_spmspm_unpacked, sequential_spmspm
from .lif import (
    DEFAULT_TAU,
    DEFAULT_VTH,
    direct_encode,
    lif_forward,
    plif_packed,
    rate_decode,
    spike_fn,
)
from .packing import (
    block_activity_map,
    block_nonzero_map,
    compression_efficiency,
    mask_low_activity,
    pack_spikes,
    popcount,
    silent_fraction,
    spike_sparsity,
    unpack_spikes,
)
from .snn_layers import (
    SpikingConfig,
    assert_weight_density,
    attach_join_plans,
    init_spiking_ffn,
    prune_by_magnitude,
    spiking_ffn_apply,
    spiking_ffn_apply_packed,
    spiking_linear_infer,
    spiking_linear_train,
    weight_density,
)

__all__ = [
    "ftp_layer", "ftp_spmspm", "ftp_spmspm_unpacked", "sequential_spmspm",
    "lif_forward", "plif_packed", "direct_encode", "rate_decode", "spike_fn",
    "DEFAULT_TAU", "DEFAULT_VTH",
    "pack_spikes", "unpack_spikes", "silent_fraction", "spike_sparsity",
    "popcount", "mask_low_activity", "block_activity_map", "block_nonzero_map",
    "compression_efficiency",
    "SpikingConfig", "init_spiking_ffn", "spiking_ffn_apply",
    "spiking_ffn_apply_packed", "spiking_linear_train", "spiking_linear_infer",
    "prune_by_magnitude", "attach_join_plans", "assert_weight_density",
    "weight_density",
]
