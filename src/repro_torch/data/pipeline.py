"""Deterministic, stateless synthetic data (copy of
`repro.data.pipeline.SyntheticLMData`; its batches equal the reference's
bit for bit).

Every batch is a pure function of (seed, step): a restart needs only the
step counter in the train state.  The token stream mixes Zipfian unigrams
with a copy structure (the next token is often the one two back), so the
LM loss has something to learn.  The generator is numpy's, as in the
reference; `batch_to_torch` moves a batch to the device, and
`batch_shapes` gives one batch of a shape cell as meta tensors (the dry
run's inputs, torch's counterpart of ``jax.ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.cfg.vocab
        out = {}
        if self.cfg.embed_inputs:
            ranks = np.arange(1, V + 1)
            probs = 1.0 / ranks ** 1.1
            probs /= probs.sum()
            toks = rng.choice(V, size=(B, S + 1), p=probs)
            copy_mask = rng.random((B, S + 1)) < 0.5
            toks[:, 2:][copy_mask[:, 2:]] = toks[:, :-2][copy_mask[:, 2:]]
            out["tokens"] = toks[:, :-1].astype(np.int32)
            out["labels"] = toks[:, 1:].astype(np.int32)
        else:
            frames = rng.standard_normal((B, S, self.cfg.d_model), dtype=np.float32)
            out["frames"] = frames
            out["labels"] = rng.integers(0, V, size=(B, S)).astype(np.int32)
        if self.cfg.n_img_tokens:
            out["img_embed"] = rng.standard_normal(
                (B, self.cfg.n_img_tokens, self.cfg.d_model), dtype=np.float32
            )
        return out


def batch_to_torch(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids and labels as int64 (torch's
    index type), float arrays unchanged."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            if v.dtype.kind in "iu" else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


def batch_shapes(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """One batch of ``cell`` as meta tensors: the reference's keys and
    shapes in the port's dtypes (token ids and labels int64, as
    `batch_to_torch` gives them; frames and image embeddings f32)."""
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    if cfg.embed_inputs:
        out["tokens"] = meta((B, S), torch.int64)
    else:
        out["frames"] = meta((B, S, cfg.d_model), torch.float32)
    out["labels"] = meta((B, S), torch.int64)
    if cfg.n_img_tokens:
        out["img_embed"] = meta((B, cfg.n_img_tokens, cfg.d_model), torch.float32)
    return out
