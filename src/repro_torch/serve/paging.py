"""Paged cache storage + radix prefix reuse for the serving engine (port of
`repro.serve.paging`, one device: no sharded pools).

The dense serving layout (``paging='none'``) gives every cohort its own
cache, so continuous batching pays whole-cache copies at every membership
change: merge concatenates both cohorts' full KV, retire gathers the
survivors.  ``paging='paged'`` stores cache state in fixed pages owned by
one engine-wide `CacheStore`:

* every *sequence* leaf (logical axes hold ``"batch"`` and ``"cache_seq"``:
  the transformer's ``k``/``v``) is cut into ``page_size``-position pages,
  pooled per leaf with the page axis where the batch axis was;
* every *state* leaf (``"batch"`` without ``"cache_seq"``) is one page per
  row in its own pool;
* *position-like* leaves (no batch axis: ``kv_pos``, ``pos``) stay
  per-cohort "locals", the same merge-invariant values the dense layout
  shares.

A cohort then holds a `PagedCache`: host page tables (``(B, pages_per_row)``
sequence-page ids + ``(B,)`` state-page ids) plus the locals.  Cohort merge
and retire are page-table edits: `PagedCacheOps` moves no cache bytes for
them (`EngineMetrics.n_page_moves` stays 0).  Model code is untouched: each
decode gathers the tables into a fresh dense view (an ``index_select``
copy, laid out exactly as the dense layout's cache), the model writes its
new k/v rows into that view in place, and only the pages the step wrote
are copied back into the pools (``index_copy_``); a prefill scatters every
page of its rows.  Gather and scatter are pure data movement, so paged
serving is bitwise equal to dense serving.  The position to write is the
cache's host-int ``pos``, so locating the step's page needs no device
read.

On top of the store sits `RadixPrefixIndex`: a page-chunk trie of published
prompt prefixes.  `Scheduler.submit` hashes the prompt; an exact
full-prompt hit admits the request into a cohort with the shared KV pages
ref-counted in place (no prefill for the shared prefix) and a copy-on-write
clone of the divergence (tail) page, the only page the new request will
write.  Causal attention makes the shared pages valid: ``k``/``v`` at
position *i* depend only on tokens ``<= i``.  State leaves and the position
locals depend on the whole prompt, so hits are full-prompt exact matches
(hash + token verification) and entries snapshot the post-prefill state
page and locals plus the deterministic greedy first token.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .batching import CacheOps, _equal, spike_sparsity, upload


class PagePoolExhausted(RuntimeError):
    """The page pool ran out even after evicting every unpinned prefix
    entry: the engine needs a larger ``page_pool_rows``."""


# ---------------------------------------------------------------------------
# PageLayout: leaf classification + gather/scatter + paged model wrappers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Leaf:
    kind: str                   # "seq" | "state" | "local"
    b: int | None = None        # batch axis
    s: int | None = None        # sequence axis (seq leaves)
    shape: tuple = ()           # the batch-1 template's shape
    dtype: torch.dtype | None = None


class PageLayout:
    """Paging schema for one model's cache dict.

    Built from a batch-1 template cache and the model's logical-axes dict:
    classifies every leaf (sequence / state / local) and moves rows between
    the pools and dense views.  Every rearrangement is a reshape, a
    permutation or an index copy: bitwise-exact data movement."""

    def __init__(self, template: dict, axes: dict, page_size: int):
        self.page_size = int(page_size)
        self.leaves: dict[str, _Leaf] = {}
        self.pos_key: str | None = None   # scalar position local
        extents = set()
        for key, leaf in template.items():
            ax = axes[key]
            ndim = leaf.ndim if isinstance(leaf, torch.Tensor) else 0
            if len(ax) != ndim:
                raise ValueError(f"axes {ax} rank != cache leaf {key!r} rank {ndim}")
            if "batch" in ax and "cache_seq" in ax:
                b, s = ax.index("batch"), ax.index("cache_seq")
                extents.add(leaf.shape[s])
                self.leaves[key] = _Leaf("seq", b, s, tuple(leaf.shape), leaf.dtype)
            elif "batch" in ax:
                self.leaves[key] = _Leaf("state", ax.index("batch"), None,
                                         tuple(leaf.shape), leaf.dtype)
            else:
                self.leaves[key] = _Leaf("local")
                if ndim == 0 and self.pos_key is None:
                    self.pos_key = key
        self.seq_keys = [k for k, v in self.leaves.items() if v.kind == "seq"]
        self.state_keys = [k for k, v in self.leaves.items() if v.kind == "state"]
        self.local_keys = [k for k, v in self.leaves.items() if v.kind == "local"]
        if len(extents) > 1:
            raise ValueError(
                f"paged serving needs one cache_seq extent, got {sorted(extents)}"
            )
        self.seq_extent = extents.pop() if extents else 0
        if self.seq_extent % self.page_size:
            raise ValueError(
                f"cache sequence extent {self.seq_extent} is not a multiple "
                f"of paging.page_size {self.page_size}; pick a page size "
                "that divides it (or round max_len up)"
            )
        self.pages_per_row = self.seq_extent // self.page_size
        self.has_state = bool(self.state_keys)
        if self.seq_extent and self.pos_key is None:
            raise ValueError(
                "paged serving needs a scalar position local to locate the "
                "active page; this cache has none"
            )

    def pool_shape(self, key: str, n_pages: int) -> tuple:
        """A leaf's pool: its template shape with the batch axis holding
        ``n_pages`` pages (and, for a sequence leaf, ``page_size``
        positions on the sequence axis)."""
        leaf = self.leaves[key]
        shape = list(leaf.shape)
        shape[leaf.b] = n_pages
        if leaf.kind == "seq":
            shape[leaf.s] = self.page_size
        return tuple(shape)

    # -- per-leaf gather/scatter (pure data movement) -----------------------
    def gather(self, pools: dict, seq_dev, state_dev, locals_: dict) -> dict:
        """The dense cache view of a cohort's rows: a fresh contiguous
        tensor per leaf, bitwise equal to the dense layout's cache for the
        same history (the model may write into it in place)."""
        out = {}
        for key, leaf in self.leaves.items():
            if leaf.kind == "seq":
                B, P = seq_dev.shape
                b, s = leaf.b, leaf.s
                g = pools[key].index_select(b, seq_dev.reshape(-1))
                g = g.unflatten(b, (B, P)).movedim(b + 1, s).flatten(s, s + 1)
                out[key] = g.contiguous()
            elif leaf.kind == "state":
                out[key] = pools[key].index_select(leaf.b, state_dev)
            else:
                out[key] = locals_[key]
        return out

    def locals_of(self, cache: dict) -> dict:
        return {k: cache[k] for k in self.local_keys}

    def _pages(self, x, leaf: _Leaf):
        """(..., B at b, ..., S at s, ...) -> (..., B * P at b, ..., ps at s,
        ...): the inverse of `gather`'s reshape."""
        P = self.pages_per_row
        b, s = leaf.b, leaf.s
        x = x.unflatten(s, (P, self.page_size)).movedim(s, b + 1)
        return x.flatten(b, b + 1)

    def scatter_all(self, pools: dict, cache: dict, seq_dev, state_dev) -> None:
        """Write every page of every row (prefill: the whole view is new,
        including the zero tail, so freshly allocated pages need no separate
        zeroing)."""
        for key, leaf in self.leaves.items():
            if leaf.kind == "seq":
                pools[key].index_copy_(leaf.b, seq_dev.reshape(-1),
                                       self._pages(cache[key], leaf))
            elif leaf.kind == "state":
                pools[key].index_copy_(leaf.b, state_dev, cache[key])

    def scatter_step(self, pools: dict, cache: dict, seq_dev, state_dev,
                     pos: int, span: int = 1) -> None:
        """Write back one decode dispatch of ``span`` positions starting at
        the host position ``pos``: the sequence pages that write touched,
        plus the state pages (rewritten every dispatch).  The page ids come
        from the device table by a host column index: no device read."""
        if self.seq_extent:
            slot = int(pos) % self.seq_extent
            first = slot // self.page_size
            last = min(self.pages_per_row - 1,
                       (slot + span - 1) // self.page_size)
        for key, leaf in self.leaves.items():
            if leaf.kind == "seq":
                x = cache[key]
                for j in range(first, last + 1):
                    chunk = x.narrow(leaf.s, j * self.page_size, self.page_size)
                    pools[key].index_copy_(leaf.b, seq_dev[:, j], chunk)
            elif leaf.kind == "state":
                pools[key].index_copy_(leaf.b, state_dev, cache[key])

    # -- paged model calls --------------------------------------------------
    def make_prefill(self, model, max_len: int, device):
        """(params, tokens, pools, seq_dev, state_dev, spiking_mode) ->
        (logits, locals).  The view starts from the model's own zero cache:
        exactly the dense prefill; the pools are written in place."""

        def fn(params, tokens, pools, seq_dev, state_dev, spiking_mode):
            cache = model.init_cache(tokens.shape[0], max_len, device=device)
            logits, cache = model.prefill(params, {"tokens": tokens}, cache,
                                          spiking_mode=spiking_mode)
            self.scatter_all(pools, cache, seq_dev, state_dev)
            return logits, self.locals_of(cache)

        return fn

    def make_propose(self, model, k: int, catchup: int):
        """(params, chunk, pools, seq_dev, state_dev, locals, spiking_mode)
        -> (draft tokens (B, k), locals): the fused draft propose over a
        draft cache's pages.  One gather, ``catchup - 1`` feed positions +
        k chained greedy steps (`propose_chain`), one scatter of every page
        those ``k + catchup - 1`` positions wrote."""

        def fn(params, chunk, pools, seq_dev, state_dev, locals_, spiking_mode):
            cache = self.gather(pools, seq_dev, state_dev, locals_)
            pos = locals_[self.pos_key] if self.pos_key is not None else 0
            toks, cache = propose_chain(model, params, chunk, cache, k,
                                        spiking_mode)
            self.scatter_step(pools, cache, seq_dev, state_dev, pos,
                              span=k + catchup - 1)
            return toks, self.locals_of(cache)

        return fn

    def make_decode(self, model):
        """(params, tokens, pools, seq_dev, state_dev, locals, spiking_mode)
        -> (logits, locals).  Tokens may be (B, 1) or a wider (B, S)
        window; the step scatter covers every page the window wrote."""

        def fn(params, tokens, pools, seq_dev, state_dev, locals_, spiking_mode):
            cache = self.gather(pools, seq_dev, state_dev, locals_)
            pos = locals_[self.pos_key] if self.pos_key is not None else 0
            logits, cache = model.decode(params, tokens, cache,
                                         spiking_mode=spiking_mode)
            self.scatter_step(pools, cache, seq_dev, state_dev, pos,
                              span=tokens.shape[1])
            return logits, self.locals_of(cache)

        return fn


def propose_chain(model, params, chunk: torch.Tensor, cache, k: int,
                  spiking_mode: str):
    """The draft's fused propose on one cache (dense, or a gathered paged
    view): decode the ``catchup - 1`` leading positions of the (B, catchup)
    ``chunk``, then k chained greedy steps from its last token, each step's
    argmax fed to the next on the device.  Returns ((B, k) int32 draft
    tokens, cache); reads nothing back to the host."""
    catchup = chunk.shape[1]
    if catchup > 1:
        _, cache = model.decode(params, chunk[:, : catchup - 1].long(), cache,
                                spiking_mode=spiking_mode)
    tok = chunk[:, catchup - 1]
    out = []
    for _ in range(k):
        logits, cache = model.decode(params, tok[:, None].long(), cache,
                                     spiking_mode=spiking_mode)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1), cache


# ---------------------------------------------------------------------------
# CacheStore: pooled pages + alloc/free/ref-count
# ---------------------------------------------------------------------------

class CacheStore:
    """Engine-wide owner of the page pools.

    One device pool per paged cache leaf, one shared logical page-id space
    per *kind*: every sequence pool is indexed by the same sequence-page id,
    every state pool by the same state-page id, so a row's allocation is
    ``pages_per_row`` sequence ids plus one state id, and ref-counts and
    free lists are per-kind host arrays, not per-leaf.

    ``n_page_moves`` counts page-granular COPIES (prefix publish snapshots
    and copy-on-write clones).  Merge and retire go through `PagedCacheOps`
    and never copy.
    """

    def __init__(self, layout: PageLayout, n_rows: int, *, device="cpu",
                 metrics=None):
        if n_rows < 1:
            raise ValueError("page pool needs at least one row")
        self.layout = layout
        self.device = torch.device(device)
        self.metrics = metrics
        self.on_pressure = None   # callable(kind) -> bool: try to free pages
        self.n_seq_pages = max(1, n_rows * max(1, layout.pages_per_row))
        self.n_state_pages = max(1, n_rows)
        self.pools = {}
        for key in layout.seq_keys:
            self.pools[key] = torch.zeros(
                layout.pool_shape(key, self.n_seq_pages),
                dtype=layout.leaves[key].dtype, device=self.device)
        for key in layout.state_keys:
            self.pools[key] = torch.zeros(
                layout.pool_shape(key, self.n_state_pages),
                dtype=layout.leaves[key].dtype, device=self.device)
        self._seq_ref = np.zeros(self.n_seq_pages, np.int32)
        self._state_ref = np.zeros(self.n_state_pages, np.int32)
        self._seq_free = list(range(self.n_seq_pages - 1, -1, -1))
        self._state_free = list(range(self.n_state_pages - 1, -1, -1))

    def place(self, mesh) -> None:
        """Place the pools on a serve mesh (`sharding.place_pool`: its lead
        device; None keeps the device).  Tables, refcounts and free lists
        are host state: no page is copied, and on the same device no byte
        moves."""
        from .sharding import place_pool

        self.pools = {k: place_pool(v, mesh) for k, v in self.pools.items()}
        if mesh is not None:
            self.device = mesh.lead

    # -- allocation ---------------------------------------------------------
    def _alloc(self, free: list, ref: np.ndarray, n: int, kind: str):
        while len(free) < n:
            if self.on_pressure is None or not self.on_pressure(kind):
                raise PagePoolExhausted(
                    f"page pool out of {kind} pages (need {n}, "
                    f"free {len(free)}); raise Engine(page_pool_rows=...)"
                )
        ids = np.asarray([free.pop() for _ in range(n)], np.int32)
        ref[ids] = 1
        return ids

    def alloc_seq(self, n: int) -> np.ndarray:
        return self._alloc(self._seq_free, self._seq_ref, n, "seq")

    def alloc_state(self, n: int) -> np.ndarray:
        return self._alloc(self._state_free, self._state_ref, n, "state")

    def alloc_rows(self, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """(seq_table (n, pages_per_row), state_table (n,)) for fresh rows.
        Pages are NOT zeroed: a cold prefill scatters every page of the
        row."""
        P = self.layout.pages_per_row
        seq = self.alloc_seq(n_rows * P).reshape(n_rows, P)
        state = (self.alloc_state(n_rows) if self.layout.has_state
                 else np.zeros(n_rows, np.int32))
        return seq, state

    def alloc_rows_zeroed(self, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """Fresh rows with ZEROED pages: for dummy rows and the unwritten
        tail of prefix-hit rows, where the gather must read the zeros the
        dense layout would hold."""
        seq, state = self.alloc_rows(n_rows)
        self.zero_seq(seq.reshape(-1))
        if self.layout.has_state:
            self.zero_state(state)
        return seq, state

    # -- ref-counting -------------------------------------------------------
    def incref_seq(self, ids) -> None:
        self._seq_ref[np.asarray(ids, np.int32)] += 1

    def _decref(self, free: list, ref: np.ndarray, ids) -> None:
        for i in np.asarray(ids, np.int32).reshape(-1):
            ref[i] -= 1
            if ref[i] == 0:
                free.append(int(i))
            elif ref[i] < 0:
                raise RuntimeError(f"page {int(i)} double-freed")

    def decref_seq(self, ids) -> None:
        self._decref(self._seq_free, self._seq_ref, ids)

    def decref_state(self, ids) -> None:
        if self.layout.has_state:
            self._decref(self._state_free, self._state_ref, ids)

    def seq_refcount(self, page: int) -> int:
        return int(self._seq_ref[page])

    @property
    def free_seq_pages(self) -> int:
        return len(self._seq_free)

    @property
    def free_state_pages(self) -> int:
        return len(self._state_free)

    # -- page data ops (the only movers of cache bytes outside model calls) -
    def _ids(self, ids) -> torch.Tensor:
        return upload(np.asarray(ids, np.int64).reshape(-1), torch.long,
                      self.device)

    def _copy(self, keys, src, dst) -> None:
        s, d = self._ids(src), self._ids(dst)
        for key in keys:
            b = self.layout.leaves[key].b
            pool = self.pools[key]
            pool.index_copy_(b, d, pool.index_select(b, s))
        if self.metrics is not None:
            self.metrics.n_page_moves += int(s.shape[0])

    def copy_seq(self, src, dst) -> None:
        self._copy(self.layout.seq_keys, src, dst)

    def copy_state(self, src, dst) -> None:
        self._copy(self.layout.state_keys, src, dst)

    def _zero(self, keys, ids) -> None:
        idx = self._ids(ids)
        for key in keys:
            self.pools[key].index_fill_(self.layout.leaves[key].b, idx, 0)

    def zero_seq(self, ids) -> None:
        self._zero(self.layout.seq_keys, ids)

    def zero_state(self, ids) -> None:
        self._zero(self.layout.state_keys, ids)

    def summary(self) -> dict:
        return {
            "page_size": self.layout.page_size,
            "pages_per_row": self.layout.pages_per_row,
            "seq_pages_total": self.n_seq_pages,
            "seq_pages_free": self.free_seq_pages,
            "state_pages_total": (self.n_state_pages
                                  if self.layout.has_state else 0),
            "state_pages_free": (self.free_state_pages
                                 if self.layout.has_state else 0),
        }


# ---------------------------------------------------------------------------
# PagedCache + PagedCacheOps
# ---------------------------------------------------------------------------

class PagedCache:
    """A cohort's cache under ``paging='paged'``: host page tables into the
    engine's `CacheStore` plus the cohort's position locals.  The tables'
    device copy is made at the first dispatch that needs it and kept until
    the tables change (every edit builds a new `PagedCache`)."""

    def __init__(self, store: CacheStore, seq_table: np.ndarray,
                 state_table: np.ndarray, locals_: dict):
        self.store = store
        self.seq_table = seq_table          # (B, pages_per_row) int32
        self.state_table = state_table      # (B,) int32
        self.locals = locals_
        self._dev = None

    @property
    def batch(self) -> int:
        return int(self.state_table.shape[0])

    def tables_dev(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(seq, state) page tables on the pools' device, uploaded once."""
        if self._dev is None:
            dev = self.store.device
            self._dev = (upload(self.seq_table, torch.long, dev),
                         upload(self.state_table, torch.long, dev))
        return self._dev

    def release(self) -> None:
        """Drop every row (decref; shared pages survive via their refs)."""
        self.store.decref_seq(self.seq_table)
        self.store.decref_state(self.state_table)
        self.seq_table = self.seq_table[:0]
        self.state_table = self.state_table[:0]
        self._dev = None


class PagedCacheOps(CacheOps):
    """Paged backend of the cache-manipulation facade: every operation is
    a host page-table edit; no pool bytes move."""

    def __init__(self, store: CacheStore):
        self.store = store

    def batch_size(self, cache: PagedCache) -> int:
        return cache.batch

    def concat(self, caches: list) -> PagedCache:
        if len(caches) == 1:
            return caches[0]
        first = caches[0]
        for other in caches[1:]:
            for k in first.locals:
                if not _equal(first.locals[k], other.locals[k]):
                    raise ValueError(
                        "refusing to merge cohorts with differing "
                        "position-like cache locals"
                    )
        return PagedCache(
            self.store,
            np.concatenate([c.seq_table for c in caches], axis=0),
            np.concatenate([c.state_table for c in caches], axis=0),
            first.locals,
        )

    def take(self, cache: PagedCache, idx) -> PagedCache:
        idx = np.asarray(idx, np.int64)
        keep = np.zeros(cache.batch, bool)
        keep[idx] = True
        for r in np.nonzero(~keep)[0]:
            self.store.decref_seq(cache.seq_table[r])
            self.store.decref_state(cache.state_table[r: r + 1])
        return PagedCache(self.store, cache.seq_table[idx],
                          cache.state_table[idx], cache.locals)

    def pad_rows(self, cache: PagedCache, n: int) -> PagedCache:
        """Append ``n`` dummy rows on zeroed pages: table edits, no copy."""
        if n <= 0:
            return cache
        seq, state = self.store.alloc_rows_zeroed(n)
        return PagedCache(self.store,
                          np.concatenate([cache.seq_table, seq], axis=0),
                          np.concatenate([cache.state_table, state], axis=0),
                          cache.locals)


# ---------------------------------------------------------------------------
# Paged packed-spike cache
# ---------------------------------------------------------------------------

class SpikeSlotPool:
    """Device pool of packed-spike rows (one ``(width,)`` int32 word row per
    engine slot), so cohort merge and take are id-list edits like the KV
    tables instead of concatenations."""

    def __init__(self, width: int, n_rows: int, device="cpu"):
        self.words = torch.zeros((n_rows, width), dtype=torch.int32,
                                 device=device)
        self._free = list(range(n_rows - 1, -1, -1))

    def alloc(self, n: int) -> np.ndarray:
        if len(self._free) < n:
            raise PagePoolExhausted(
                f"spike slot pool out of rows (need {n}, free "
                f"{len(self._free)})"
            )
        return np.asarray([self._free.pop() for _ in range(n)], np.int64)

    def free(self, ids) -> None:
        self._free.extend(int(i) for i in np.asarray(ids).reshape(-1))


class PagedSpikeCache:
    """`PackedSpikeCache`-interface view over a shared `SpikeSlotPool`.

    Same double-buffering contract (`update_async`/`_sync`) and telemetry;
    `merge` and `take` edit the row-id list instead of concatenating or
    gathering the word arrays."""

    def __init__(self, T: int, width: int, pool: SpikeSlotPool):
        self.T, self.width, self.pool = T, width, pool
        self.row_ids = np.zeros((0,), np.int64)
        self._ids_dev = None
        self._pending = None

    def _set_rows(self, ids: np.ndarray) -> None:
        self.row_ids = ids
        self._ids_dev = None

    def _dev_ids(self) -> torch.Tensor:
        if self._ids_dev is None:
            self._ids_dev = upload(self.row_ids, torch.long,
                                   self.pool.words.device)
        return self._ids_dev

    @property
    def words(self) -> torch.Tensor:
        self._sync()
        return self.pool.words.index_select(0, self._dev_ids())

    def update_async(self, words: torch.Tensor) -> None:
        self._pending = words

    def _sync(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self.update(pending)

    def __len__(self) -> int:
        self._sync()
        return int(self.row_ids.shape[0])

    def _rows(self, words: torch.Tensor) -> torch.Tensor:
        if words.dtype != torch.int32:
            raise ValueError(f"packed spike words are int32, got {words.dtype}")
        return words.reshape(-1, self.width)

    def append(self, words: torch.Tensor) -> None:
        self._sync()
        w = self._rows(words)
        ids = self.pool.alloc(w.shape[0])
        self.pool.words.index_copy_(
            0, upload(ids, torch.long, self.pool.words.device), w)
        self._set_rows(np.concatenate([self.row_ids, ids]))

    def update(self, words: torch.Tensor) -> None:
        self._sync()
        w = self._rows(words)
        if w.shape[0] != len(self):
            raise ValueError(
                f"update of {w.shape[0]} rows into {len(self)} slots"
            )
        self.pool.words.index_copy_(0, self._dev_ids(), w)

    def merge(self, other: "PagedSpikeCache") -> None:
        if (other.T, other.width) != (self.T, self.width):
            raise ValueError("merging incompatible spike caches")
        if other.pool is not self.pool:
            raise ValueError("merging spike caches from different pools")
        self._sync()
        other._sync()
        self._set_rows(np.concatenate([self.row_ids, other.row_ids]))
        other._set_rows(other.row_ids[:0])

    def take(self, idx) -> None:
        self._sync()
        idx = np.asarray(idx, np.int64)
        keep = np.zeros(self.row_ids.shape[0], bool)
        keep[idx] = True
        self.pool.free(self.row_ids[~keep])
        self._set_rows(self.row_ids[idx])

    # -- telemetry (the same formulas as PackedSpikeCache) ------------------
    def spike_sparsity(self) -> float:
        return spike_sparsity(self.words, self.T)

    def silent_fraction(self) -> float:
        w = self.words
        if w.numel() == 0:
            return 1.0
        return float((w == 0).float().mean())


# ---------------------------------------------------------------------------
# Radix prefix index
# ---------------------------------------------------------------------------

@dataclass
class PrefixEntry:
    """One published full-prompt prefix.

    ``full_pages`` are trie-node sequence pages shared by ref-count;
    ``tail_page`` is the index-owned snapshot of the divergence page (the
    page a hit's decode will write, cloned again, copy-on-write, at
    admission); ``state_page`` the index-owned post-prefill state snapshot;
    ``locals`` the post-prefill position locals (never written in place:
    each decode builds new ones); ``first_token`` the deterministic greedy
    first token the prefill emitted.
    """

    prompt: np.ndarray
    full_pages: np.ndarray            # (n_full_chunks,) int32
    tail_page: int | None
    state_page: int | None
    locals: dict
    first_token: int
    last_used: int = 0
    pins: int = 0                     # queued hits not yet admitted
    alive: bool = True

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class _TrieNode:
    __slots__ = ("children", "page", "n_entries")

    def __init__(self, page: int | None = None):
        self.children: dict[int, list] = {}   # hash -> [(chunk_bytes, node)]
        self.page = page
        self.n_entries = 0

    def find(self, h: int, chunk: bytes):
        for cb, node in self.children.get(h, ()):
            if cb == chunk:
                return node
        return None

    def add(self, h: int, chunk: bytes, node: "_TrieNode") -> None:
        self.children.setdefault(h, []).append((chunk, node))

    def remove(self, h: int, chunk: bytes) -> None:
        lst = self.children.get(h, [])
        self.children[h] = [(cb, n) for cb, n in lst if cb != chunk]
        if not self.children[h]:
            del self.children[h]


class RadixPrefixIndex:
    """Page-chunk radix trie over published prompt prefixes.

    * **Dedup**: prompts sharing leading ``page_size``-token chunks share
      trie nodes, and therefore the underlying KV pages (one ref-count hold
      per node, however many entries pass through it).
    * **Collision safety**: both the trie children and the full-prompt
      entry buckets are keyed by hash *and verified by token equality*: a
      colliding hash can cost a lookup miss, never a wrong page.
    * **Eviction**: least-recently-used entries are dropped when
      ``max_entries`` is hit or when the `CacheStore` runs out of pages
      (the store's pressure hook); entries with queued-but-unadmitted hits
      are pinned and never evicted.
    """

    def __init__(self, store: CacheStore, *, max_entries: int = 32):
        self.store = store
        self.page_size = store.layout.page_size
        self.max_entries = max_entries
        self.root = _TrieNode()
        self._buckets: dict[int, list[PrefixEntry]] = {}
        self._paths: dict[int, list] = {}   # id(entry) -> trie path
        self._tick = 0
        self.n_lookups = 0
        self.n_hits = 0
        store.on_pressure = self._on_pressure

    @staticmethod
    def _hash(data: bytes) -> int:
        return zlib.crc32(data)

    def __len__(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    @property
    def entries(self) -> list[PrefixEntry]:
        return [e for v in self._buckets.values() for e in v]

    # -- lookup -------------------------------------------------------------
    def lookup(self, prompt: np.ndarray) -> PrefixEntry | None:
        """Exact full-prompt match (hash bucket + token verification)."""
        self.n_lookups += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        h = self._hash(prompt.tobytes())
        for e in self._buckets.get(h, ()):
            if e.alive and np.array_equal(e.prompt, prompt):
                self._tick += 1
                e.last_used = self._tick
                self.n_hits += 1
                return e
        return None

    # -- publish ------------------------------------------------------------
    def publish(self, prompt, seq_row, state_id, locals_: dict,
                first_token: int) -> PrefixEntry | None:
        """Publish one just-prefilled row's prefix.

        ``seq_row``: the row's (pages_per_row,) sequence-page ids (their
        full-chunk prefix is shared by incref; the partial tail page is
        snapshot-copied, since the row's own decode is about to write it).
        Returns None when the prompt is already published or the pool
        cannot hold the snapshot.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        h = self._hash(prompt.tobytes())
        for e in self._buckets.get(h, ()):
            if e.alive and np.array_equal(e.prompt, prompt):
                return None
        while len(self) >= self.max_entries:
            if not self.evict_lru():
                return None
        ps = self.page_size
        P = prompt.shape[0]
        # state-only caches have no sequence pages: the reusable prefix is
        # then the state-page snapshot + locals alone
        paged_seq = self.store.layout.pages_per_row > 0
        n_full = P // ps if paged_seq else 0
        has_tail = paged_seq and bool(P % ps)
        # snapshot copies FIRST (they can fail under pool pressure; trie
        # increfs cannot): a failed publish leaves no trace
        tail = None
        try:
            if has_tail:
                tail = int(self.store.alloc_seq(1)[0])
                self.store.copy_seq([int(seq_row[n_full])], [tail])
            state = None
            if self.store.layout.has_state:
                state = int(self.store.alloc_state(1)[0])
                self.store.copy_state([int(state_id)], [state])
        except PagePoolExhausted:
            if tail is not None:
                self.store.decref_seq([tail])
            return None
        # walk/extend the trie over the full chunks, sharing nodes (and
        # their pages) with previously published prompts
        node, path, full_pages = self.root, [], []
        for c in range(n_full):
            chunk = prompt[c * ps: (c + 1) * ps].tobytes()
            ch = self._hash(chunk)
            child = node.find(ch, chunk)
            if child is None:
                page = int(seq_row[c])
                self.store.incref_seq([page])
                child = _TrieNode(page)
                node.add(ch, chunk, child)
            child.n_entries += 1
            path.append((node, ch, chunk, child))
            full_pages.append(child.page)
            node = child
        self._tick += 1
        entry = PrefixEntry(
            prompt=prompt.copy(),
            full_pages=np.asarray(full_pages, np.int32),
            tail_page=tail,
            state_page=state,
            locals=dict(locals_),
            first_token=int(first_token),
            last_used=self._tick,
        )
        self._buckets.setdefault(h, []).append(entry)
        self._paths[id(entry)] = path
        return entry

    # -- admission ----------------------------------------------------------
    def admit(self, entry: PrefixEntry) -> tuple[np.ndarray, np.ndarray]:
        """Materialize one row from a prefix entry: incref the shared full
        pages in place, copy-on-write the divergence (tail) page, allocate
        zeroed pages for the unwritten rest of the row, and clone the state
        page.  Returns (seq_row (pages_per_row,), state_id (1,))."""
        if not entry.alive:
            raise RuntimeError("prefix entry was evicted while queued")
        store, ps = self.store, self.page_size
        layout = store.layout
        n_full = entry.prompt_len // ps if layout.pages_per_row else 0
        n_rest = layout.pages_per_row - n_full
        # pin across the allocations: their pressure evictions must not pick
        # THIS entry, and a failed allocation must roll every hold back
        entry.pins += 1
        store.incref_seq(entry.full_pages)
        fresh = None
        try:
            if n_rest:
                fresh = store.alloc_seq(n_rest)
            state = (np.zeros(1, np.int32) if not layout.has_state
                     else store.alloc_state(1))
        except PagePoolExhausted:
            store.decref_seq(entry.full_pages)
            if fresh is not None:
                store.decref_seq(fresh)
            raise
        finally:
            entry.pins -= 1
        row = np.zeros(layout.pages_per_row, np.int32)
        row[:n_full] = entry.full_pages
        if n_rest:
            store.zero_seq(fresh)
            row[n_full:] = fresh
            if entry.tail_page is not None:
                store.copy_seq([entry.tail_page], [int(row[n_full])])
        if entry.state_page is not None:
            store.copy_state([entry.state_page], state)
        return row, state

    # -- eviction -----------------------------------------------------------
    def evict_lru(self) -> bool:
        """Drop the least-recently-used unpinned entry; True if one went."""
        victim = None
        for e in self.entries:
            if e.pins == 0 and (victim is None
                                or e.last_used < victim.last_used):
                victim = e
        if victim is None:
            return False
        self._evict(victim)
        return True

    def _evict(self, entry: PrefixEntry) -> None:
        entry.alive = False
        h = self._hash(entry.prompt.tobytes())
        self._buckets[h] = [e for e in self._buckets.get(h, [])
                            if e is not entry]
        if not self._buckets[h]:
            del self._buckets[h]
        if entry.tail_page is not None:
            self.store.decref_seq([entry.tail_page])
        if entry.state_page is not None:
            self.store.decref_state([entry.state_page])
        # release trie nodes bottom-up once no entry passes through them
        for parent, ch, chunk, node in reversed(
            self._paths.pop(id(entry), [])
        ):
            node.n_entries -= 1
            if node.n_entries == 0 and not node.children:
                self.store.decref_seq([node.page])
                parent.remove(ch, chunk)

    def _on_pressure(self, kind: str) -> bool:
        return self.evict_lru()

    def summary(self) -> dict:
        return {
            "entries": len(self),
            "lookups": self.n_lookups,
            "hits": self.n_hits,
            "hit_rate": self.n_hits / max(1, self.n_lookups),
        }
