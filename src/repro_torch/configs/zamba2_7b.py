"""zamba2-7b [hybrid]: 81 Mamba2 layers (d3584, ssm_state=64) + one
weight-shared attention block (32H MHA, ff14336) applied every 6 layers
[arXiv:2411.15242]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, d_ff=14336, vocab=32000,
    n_heads=32, n_kv=32, head_dim=112,
    act="swiglu", attn="causal", rope_theta=10000.0,
    ssm_heads=112, ssm_head_dim=64, ssm_state=64, ssm_expand=2,
    shared_attn_every=6,
    optimizer="adamw", fsdp=True, subquadratic=True,
)
