"""mixtral-8x22b [moe]: 56L d6144 48H (GQA kv=8) ff16384, 8 experts top-2,
SWA window 4096, v32768 [arXiv:2401.04088].  SWA => sub-quadratic decode:
runs long_500k with a window-sized ring cache.  FSDP for the 141B params."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, d_ff=16384, vocab=32768,
    n_heads=48, n_kv=8, head_dim=128,
    act="swiglu", attn="swa", window=4096, rope_theta=1000000.0,
    n_experts=8, top_k=2,
    optimizer="adafactor", fsdp=True, subquadratic=True,
)
