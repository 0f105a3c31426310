"""llama3.2-1b [dense]: 16L d2048 32H (GQA kv=8) ff8192 v128256
[hf:meta-llama/Llama-3.2-1B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, d_ff=8192, vocab=128256,
    n_heads=32, n_kv=8, head_dim=64,
    act="swiglu", attn="causal", rope_theta=500000.0,
    tie_embeddings=True,
    optimizer="adamw", subquadratic=False,
)
