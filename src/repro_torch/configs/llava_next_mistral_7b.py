"""llava-next-mistral-7b [vlm]: mistral-7b backbone (32L d4096 32H GQA kv=8
ff14336 v32000) + anyres image tokens [hf:llava-hf/llava-v1.6-mistral-7b-hf].
Vision frontend stubbed: precomputed patch embeddings are a model input;
n_img_tokens=576 (24x24 base grid)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, d_ff=14336, vocab=32000,
    n_heads=32, n_kv=8, head_dim=128,
    act="swiglu", attn="causal", rope_theta=1000000.0,
    n_img_tokens=576,
    optimizer="adamw", fsdp=True, subquadratic=False,
)
