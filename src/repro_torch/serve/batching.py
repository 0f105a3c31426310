"""Batch-composition machinery for the continuous-batching engine (port of
`repro.serve.batching`, without the mesh's row padding).

A model exposes its serving cache as a dict plus a parallel `cache_axes()`
dict of logical-axis tuples.  `CacheOps` is the one surface through which
the engine and the executors edit cohort caches between model calls; two
backends implement it: `DenseCacheOps` here (each cohort owns a dict of
tensors; it locates the ``"batch"`` axis of every leaf and concatenates /
gathers along it) and `serve.paging.PagedCacheOps` (cohorts hold page
tables into one pool; the same operations are host table edits).  Leaves
without a batch axis are position-like (``kv_pos``, ``pos``): two cohorts
merge only when those are equal — the "same sequence position"
precondition of continuous batching.

Also here: `PackedSpikeCache`, which carries each slot's direct-encoded
current token between engine steps as packed 32-bit spike words (bit t =
timestep t) instead of (T, ...) float planes, on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def _batch_axis(ax: tuple) -> int | None:
    return ax.index("batch") if "batch" in ax else None


def _equal(a, b) -> bool:
    """Leaf equality; waits for the device (merge-time only, never per
    decode step)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a, b))
    return a == b


def upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values -> a tensor on ``device`` without waiting for it: on a
    CUDA device the values go through pinned memory with a non-blocking
    copy (a pageable host-to-device copy ends in a stream synchronize)."""
    host = torch.as_tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class CacheOps:
    """Facade over cohort-cache manipulation: everything the engine and the
    step executors do to a cache between model calls.  The executors never
    branch on the backend: they call these methods and the engine's
    dispatch hooks."""

    def batch_size(self, cache) -> int:
        raise NotImplementedError

    def concat(self, caches: list):
        """Merge cohort caches (same sequence position) into one."""
        raise NotImplementedError

    def take(self, cache, idx: list[int]):
        """Keep only rows ``idx`` (host ints); other rows are discarded."""
        raise NotImplementedError

    def pad_rows(self, cache, n: int):
        """Append ``n`` dummy (zero) rows: the mesh's load-skew re-pack."""
        raise NotImplementedError


class DenseCacheOps(CacheOps):
    """Dense backend: cohort caches are plain dicts of tensors; batch-axis
    concat and gather located through the model's logical-axes dict."""

    def __init__(self, axes: dict):
        self.axes = axes

    def batch_size(self, cache: dict) -> int:
        for k, ax in self.axes.items():
            b = _batch_axis(ax)
            if b is not None:
                return int(cache[k].shape[b])
        raise ValueError("cache has no leaf with a batch axis")

    def concat(self, caches: list) -> dict:
        if len(caches) == 1:
            return caches[0]
        out = {}
        for k, ax in self.axes.items():
            leaves = [c[k] for c in caches]
            b = _batch_axis(ax)
            if b is None:
                if not all(_equal(leaves[0], o) for o in leaves[1:]):
                    raise ValueError(
                        "refusing to merge cohorts with differing "
                        f"position-like cache leaf {k!r}"
                    )
                out[k] = leaves[0]
            else:
                out[k] = torch.cat(leaves, dim=b)
        return out

    def take(self, cache: dict, idx) -> dict:
        out, rows = {}, None
        for k, ax in self.axes.items():
            b = _batch_axis(ax)
            leaf = cache[k]
            if b is not None:
                if rows is None:
                    rows = upload(idx, torch.long, leaf.device)
                leaf = leaf.index_select(b, rows)
            out[k] = leaf
        return out

    def pad_rows(self, cache: dict, n: int) -> dict:
        return cache_pad_rows(cache, self.axes, n)


def cache_pad_rows(cache: dict, axes: dict, n: int) -> dict:
    """``cache`` with ``n`` zero rows appended along every batch axis
    (position-like leaves as they are): dummy rows whose outputs are
    discarded, as `pad_batch`'s."""
    if n <= 0:
        return cache
    out = {}
    for k, ax in axes.items():
        leaf, b = cache[k], _batch_axis(ax)
        if b is not None:
            shape = list(leaf.shape)
            shape[b] = n
            leaf = torch.cat([leaf, leaf.new_zeros(shape)], dim=b)
        out[k] = leaf
    return out


def pad_batch(tokens: np.ndarray, align: int) -> tuple[np.ndarray, int]:
    """Pad the batch dimension of a (B, S) prompt batch up to a multiple of
    ``align`` with dummy rows (token 0).  Rows are independent, so dummy
    rows never perturb real ones.  Returns (padded tokens, n_dummy)."""
    B = tokens.shape[0]
    pad = (-B) % max(1, align)
    if pad == 0:
        return tokens, 0
    dummy = np.zeros((pad, tokens.shape[1]), dtype=tokens.dtype)
    return np.concatenate([tokens, dummy], axis=0), pad


def bucket_key(prompt_len: int, align: int = 1) -> int:
    """Bucket id for a prompt length: exact length at ``align=1`` (the
    models have no pad-token masking), rounded up otherwise."""
    return -(-prompt_len // max(1, align)) * max(1, align)


def spike_sparsity(words: torch.Tensor, T: int) -> float:
    """Fraction of (neuron, timestep) positions with no spike in packed
    int32 words (bit t = timestep t).  Reads the words back to the host, so
    callers keep it off the per-step path."""
    if words.numel() == 0:
        return 1.0
    bits = torch.arange(T, dtype=torch.int32, device=words.device)
    fired = (words[..., None] >> bits) & 1
    return 1.0 - int(fired.sum()) / fired.numel()


class PackedSpikeCache:
    """Per-slot SNN activations between engine steps as packed 32-bit spike
    words, one ``(width,)`` row per active slot (int32 with the bits of the
    reference's uint32, on the words' device).  Slot bookkeeping mirrors the
    KV cache: rows concat on merge, gather on retire.  No method but
    `spike_sparsity` waits for the device.

    `update_async` is the pipelined executor's double buffer, as in the
    reference: it stages the newest step's words, and the first access
    applies them (`_sync`).  Here the staged words are already on the
    device, so applying them copies nothing."""

    def __init__(self, T: int, width: int, device):
        self.T, self.width, self.device = T, width, device
        self._words = torch.zeros((0, width), dtype=torch.int32, device=device)
        self._pending: torch.Tensor | None = None

    @property
    def words(self) -> torch.Tensor:
        self._sync()
        return self._words

    def update_async(self, words: torch.Tensor) -> None:
        """Stage this step's (B, width) words; a later `update_async` before
        any access replaces them (only the newest step's words matter)."""
        self._pending = words

    def _sync(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self.update(pending)

    def __len__(self) -> int:
        return self.words.shape[0]

    def _rows(self, words: torch.Tensor) -> torch.Tensor:
        if words.dtype != torch.int32:
            raise ValueError(f"packed spike words are int32, got {words.dtype}")
        return words.reshape(-1, self.width)

    def append(self, words: torch.Tensor) -> None:
        self._words = torch.cat([self.words, self._rows(words)], dim=0)

    def update(self, words: torch.Tensor) -> None:
        """Replace all slots' words with this step's (B, width) batch."""
        w = self._rows(words)
        if w.shape[0] != len(self):
            raise ValueError(f"update of {w.shape[0]} rows into {len(self)} slots")
        self._words = w

    def merge(self, other: "PackedSpikeCache") -> None:
        if (other.T, other.width) != (self.T, self.width):
            raise ValueError("merging incompatible spike caches")
        self._words = torch.cat([self.words, other.words], dim=0)

    def take(self, idx) -> None:
        w = self.words
        self._words = w.index_select(0, upload(idx, torch.long, w.device))

    def spike_sparsity(self) -> float:
        """Fraction of (neuron, timestep) positions with no spike."""
        return spike_sparsity(self.words, self.T)
