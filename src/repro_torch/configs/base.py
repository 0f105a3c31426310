"""Architecture configuration schema (copy of `repro.configs.base`'s
`ArchConfig` and `smoke_variant`; the port keeps its own copy)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0            # 0 => attention-free
    n_kv: int = 0
    head_dim: int = 128
    act: str = "swiglu"         # swiglu | geglu | sq_relu | gelu
    qk_norm: bool = False
    attn: str = "causal"        # causal | bidir | swa
    window: int = 4096          # SWA window
    expand_kv: bool = False
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # embedding rows scaled by sqrt(d_model) (gemma); the reference keys
    # this on the name, the port's configs state it
    embed_scale: bool = False
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    shared_attn_every: int = 0
    n_img_tokens: int = 0
    embed_inputs: bool = True
    encoder_only: bool = False

    # Spiking dual-sparse FFN (the paper's technique).
    spiking_ffn: bool = False
    spiking_T: int = 4
    spiking_weight_density: float = 1.0

    optimizer: str = "adamw"
    remat: bool = True
    scan_layers: bool = True
    scan_unroll: int = 1
    fsdp: bool = False
    seq_shard_activations: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 2048
    attn_chunk: int = 512       # query chunking for attention (0 = off)
    ssm_chunk: int = 128

    supports_decode: bool = True
    subquadratic: bool = False


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU tests (same rule as the reference)."""
    repl: dict = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=512,
        loss_chunk=0,
        attn_chunk=32,
        ssm_chunk=8,
        window=16,
    )
    if cfg.n_heads:
        repl.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16)
    if cfg.n_experts:
        repl.update(n_experts=4, top_k=2)
    if cfg.ssm_heads:
        d_in = (cfg.ssm_expand if cfg.family == "hybrid" else 1) * 64
        repl.update(ssm_heads=d_in // 16, ssm_state=8, ssm_head_dim=16)
    if cfg.shared_attn_every:
        repl.update(shared_attn_every=1, n_layers=3)
    if cfg.n_img_tokens:
        repl.update(n_img_tokens=8)
    return dataclasses.replace(cfg, **repl)
