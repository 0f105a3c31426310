"""rwkv6-1.6b "Finch" [ssm]: 24L d2048 attention-free, data-dependent decay,
channel-mix ff7168, v65536 [arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, d_ff=7168, vocab=65536,
    n_heads=0, n_kv=0,
    ssm_heads=32, ssm_head_dim=64, ssm_state=64,
    optimizer="adamw", subquadratic=True,
)
