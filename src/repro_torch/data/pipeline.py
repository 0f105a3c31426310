"""Deterministic, stateless synthetic data (copy of
`repro.data.pipeline.SyntheticLMData`; its batches equal the reference's
bit for bit).

Every batch is a pure function of (seed, step): a restart needs only the
step counter in the train state.  The token stream mixes Zipfian unigrams
with a copy structure (the next token is often the one two back), so the
LM loss has something to learn.  The generator is numpy's, as in the
reference; `batch_to_torch` moves a batch to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


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
