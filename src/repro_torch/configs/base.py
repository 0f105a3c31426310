"""Architecture and shape configuration schema (copy of
`repro.configs.base`: `ArchConfig` with its parameter counts, the
assignment's four shape cells, their applicability and `smoke_variant`;
the port keeps its own copy)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0            # 0 => attention-free
    n_kv: int = 0
    head_dim: int = 128
    act: str = "swiglu"         # swiglu | geglu | sq_relu | gelu
    qk_norm: bool = False
    attn: str = "causal"        # causal | bidir | swa
    window: int = 4096          # SWA window
    expand_kv: bool = False
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # embedding rows scaled by sqrt(d_model) (gemma); the reference keys
    # this on the name, the port's configs state it
    embed_scale: bool = False
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    shared_attn_every: int = 0
    n_img_tokens: int = 0
    embed_inputs: bool = True
    encoder_only: bool = False

    # Spiking dual-sparse FFN (the paper's technique).
    spiking_ffn: bool = False
    spiking_T: int = 4
    spiking_weight_density: float = 1.0

    optimizer: str = "adamw"
    remat: bool = True
    scan_layers: bool = True
    scan_unroll: int = 1
    fsdp: bool = False
    seq_shard_activations: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 2048
    attn_chunk: int = 512       # query chunking for attention (0 = off)
    ssm_chunk: int = 128

    supports_decode: bool = True
    subquadratic: bool = False

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        p = 0
        if self.embed_inputs:
            p += V * D
        if not self.tie_embeddings and not self.encoder_only:
            p += D * V
        if self.encoder_only:
            p += D * V  # classifier head
        per_layer = 0
        if self.family in ("dense", "audio", "vlm", "moe"):
            if self.n_heads:
                per_layer += D * self.n_heads * self.head_dim      # q
                per_layer += 2 * D * self.n_kv * self.head_dim     # k, v
                per_layer += self.n_heads * self.head_dim * D      # o
            n_mats = 3 if self.act in ("swiglu", "geglu") else 2
            ffn = n_mats * D * F
            if self.n_experts:
                per_layer += self.n_experts * ffn + D * self.n_experts
            else:
                per_layer += ffn
            per_layer += 2 * D  # norms
        elif self.family == "ssm":
            if self.name.startswith("rwkv"):
                # time-mix: r,k,v,g,o (5 DxD) + low-rank decay; channel-mix 2
                per_layer += 5 * D * D + 2 * D * F + D * 64 * 2
            else:
                d_in = self.ssm_expand * D
                per_layer += D * (2 * d_in + 2 * self.ssm_state) + d_in * D
        elif self.family == "hybrid":
            d_in = self.ssm_expand * D
            per_layer += 2 * D * d_in  # in_proj (x, z)
            per_layer += d_in * (2 * self.ssm_state)  # B, C proj
            per_layer += d_in * D  # out proj
        p += L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared attention+MLP block
            p += 2 * D * self.n_heads * self.head_dim + 2 * D * self.n_kv * self.head_dim
            p += 3 * D * F
        return p

    def active_params(self) -> int:
        """Active (per-token) params — differs from n_params for MoE."""
        if not self.n_experts:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        n_mats = 3 if self.act in ("swiglu", "geglu") else 2
        inactive = L * (self.n_experts - self.top_k) * n_mats * D * F
        return self.n_params() - inactive


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> dict[str, ShapeCell | None]:
    """Which of the four shape cells run for this arch; None = skip, with
    the reason from `skip_reason` in the dry run's manifest."""
    out: dict[str, ShapeCell | None] = {}
    for name, cell in SHAPES.items():
        if cell.kind == "decode" and (cfg.encoder_only or not cfg.supports_decode):
            out[name] = None
        elif name == "long_500k" and not cfg.subquadratic:
            out[name] = None
        else:
            out[name] = cell
    return out


def skip_reason(cfg: ArchConfig, shape: str) -> str:
    if shape in ("decode_32k", "long_500k") and cfg.encoder_only:
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return ""


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU tests (same rule as the reference)."""
    repl: dict = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=512,
        loss_chunk=0,
        attn_chunk=32,
        ssm_chunk=8,
        window=16,
    )
    if cfg.n_heads:
        repl.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16)
    if cfg.n_experts:
        repl.update(n_experts=4, top_k=2)
    if cfg.ssm_heads:
        d_in = (cfg.ssm_expand if cfg.family == "hybrid" else 1) * 64
        repl.update(ssm_heads=d_in // 16, ssm_state=8, ssm_head_dim=16)
    if cfg.shared_attn_every:
        repl.update(shared_attn_every=1, n_layers=3)
    if cfg.n_img_tokens:
        repl.update(n_img_tokens=8)
    return dataclasses.replace(cfg, **repl)
