"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) ff17408 v151936, qk_norm
[hf:Qwen/Qwen3 family]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, d_ff=17408, vocab=151936,
    n_heads=40, n_kv=8, head_dim=128,
    act="swiglu", qk_norm=True, attn="causal", rope_theta=1000000.0,
    optimizer="adamw", subquadratic=False,
)
