"""nemotron-4-340b [dense]: 96L d18432 96H (GQA kv=8) ff73728 v256000,
squared-ReLU MLP [arXiv:2402.16819].  Adafactor + FSDP for memory fit."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, d_ff=73728, vocab=256000,
    n_heads=96, n_kv=8, head_dim=192,
    act="sq_relu", attn="causal", rope_theta=10000.0,
    optimizer="adafactor", fsdp=True, subquadratic=False,
)
