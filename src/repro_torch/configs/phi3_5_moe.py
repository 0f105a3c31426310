"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (GQA kv=8) ff6400, 16 experts
top-2, v32064 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, d_ff=6400, vocab=32064,
    n_heads=32, n_kv=8, head_dim=128,
    act="swiglu", attn="causal", rope_theta=10000.0,
    n_experts=16, top_k=2,
    optimizer="adafactor", fsdp=True, subquadratic=False,
)
