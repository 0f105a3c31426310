"""hubert-xlarge [audio]: 48L d1280 16H bidirectional encoder, ff5120, 504
masked-prediction classes [arXiv:2106.07447].  Frontend stubbed: inputs are
precomputed frame embeddings (B, S, d_model).  Encoder-only: no decode."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, d_ff=5120, vocab=504,
    n_heads=16, n_kv=16, head_dim=80,
    act="gelu", attn="bidir",
    embed_inputs=False, encoder_only=True, supports_decode=False,
    optimizer="adamw", subquadratic=False,
)
