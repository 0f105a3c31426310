"""gemma-2b [dense]: 18L d2048 8H (MQA kv=1) ff16384 v256000, GeGLU,
head_dim=256, tied embeddings [arXiv:2403.08295]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, d_ff=16384, vocab=256000,
    n_heads=8, n_kv=1, head_dim=256,
    act="geglu", attn="causal", rope_theta=10000.0,
    tie_embeddings=True, embed_scale=True,
    optimizer="adamw", subquadratic=False,
)
