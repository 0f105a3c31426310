"""The engine's step, in stages (port of `repro.serve.executor`'s
`SyncExecutor`, without the streaming, speculation and prefix-hit stages):

    admit -> prefill -> merge -> decode -> sample -> encode -> retire

Every stage completes on the host before the next begins (the reference
semantics): the sample stage copies each cohort's greedy tokens to the
host, so it is also where the step waits for the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .batching import bucket_key, pad_batch
from .scheduler import Request, RequestState


class _StageClock:
    """Accumulate wall time per stage into `EngineMetrics.stage_s`."""

    def __init__(self, metrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.stage_s[self.name] = (
            self.metrics.stage_s.get(self.name, 0.0)
            + time.perf_counter() - self.t0
        )
        return False


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 argmax of the last position (first
    maximal index on ties, as in the reference)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


class SyncExecutor:
    """Reference staged executor.  Holds no request state: cohorts,
    scheduler, metrics and the dispatch callables live on the engine."""

    def __init__(self, engine):
        self.engine = engine

    def _clock(self, stage: str) -> _StageClock:
        return _StageClock(self.engine.metrics, stage)

    def step(self) -> dict:
        """One engine iteration: admit+prefill, merge, decode/sample/encode
        per cohort, retire."""
        e = self.engine
        t0 = time.perf_counter()
        e.metrics.sample_queue_depth(e.scheduler.queue_depth)
        with self._clock("admit"):
            groups = e.scheduler.schedule()
        for group in groups:
            self.prefill(group)
        with self._clock("merge"):
            self.merge()
        with self._clock("retire"):
            self.retire()  # requests finished at prefill never enter decode
        for cohort in e.cohorts:
            self.decode_cohort(cohort)
        with self._clock("retire"):
            self.retire()
        e.metrics.wall_s += time.perf_counter() - t0
        return {
            "active": e.n_active,
            "queued": e.scheduler.queue_depth,
            "cohorts": len(e.cohorts),
        }

    def prefill(self, group: list[Request]) -> None:
        """Batched prefill of one same-bucket group; emits each request's
        first token and opens a cohort."""
        e = self.engine
        with self._clock("prefill"):
            P = bucket_key(
                max(r.prompt_len for r in group), e.scheduler.bucket_align
            )
            tokens = np.zeros((len(group), P), np.int32)
            for i, r in enumerate(group):
                tokens[i, : r.prompt_len] = r.prompt
            tokens, n_dummy = pad_batch(tokens, e.batch_align)
            e.metrics.n_padded_rows += n_dummy
            logits, cache = e.dispatch_prefill(tokens)
            e.metrics.n_prefill_batches += 1
            first_dev = _greedy(logits)
            first = first_dev.cpu().numpy()
            slots = [RequestState(r) for r in group]
            e._capture(slots, logits)
            for st, tok in zip(slots, first):
                st.emit(int(tok), e.eos_id)
            cohort = e.new_cohort(
                slots=slots, cache=cache, length=P, n_dummy=n_dummy
            )
            cohort.next_tokens = first_dev
            if e.spiking_packed:
                cohort.spikes = e.new_spike_cache()
                cohort.spikes.append(e._slot_spikes(cohort))
            e.cohorts.append(cohort)

    def merge(self) -> None:
        """Merge cohorts at the same sequence position: caches concat along
        their batch axes, alignment rows are dropped so live rows stay a
        prefix."""
        e = self.engine
        if len(e.cohorts) < 2:
            return
        by_len: dict[int, list] = {}
        for c in e.cohorts:
            by_len.setdefault(c.length, []).append(c)
        merged = []
        for length, group in by_len.items():
            if len(group) == 1:
                merged.append(group[0])
                continue
            cache = e.cache_ops.concat([e._live_cache(c) for c in group])
            slots = [s for c in group for s in c.slots]
            cohort = e.new_cohort(slots=slots, cache=cache, length=length)
            if e.spiking_packed:
                cohort.spikes = group[0].spikes
                for c in group[1:]:
                    cohort.spikes.merge(c.spikes)
            merged.append(cohort)
            e.metrics.n_merges += len(group) - 1
        e.cohorts = merged

    def decode_cohort(self, cohort) -> None:
        """decode -> sample -> encode for one cohort."""
        e = self.engine
        with self._clock("decode"):
            logits = self._dispatch_decode(cohort)
        with self._clock("sample_sync"):
            nxt = cohort.next_tokens.cpu().numpy()
            e._capture(cohort.slots, logits)
            for st, tok in zip(cohort.slots, nxt):
                st.emit(int(tok), e.eos_id)
        with self._clock("encode"):
            self.encode(cohort)

    def _dispatch_decode(self, cohort):
        """Dispatch one decode step; leaves the greedy argmax on the device
        in ``cohort.next_tokens`` and returns the step's logits."""
        e = self.engine
        if cohort.next_tokens is not None:
            tokens = cohort.next_tokens[:, None]
        else:  # membership changed since the last step: host-built tokens
            last = [st.generated[-1] for st in cohort.slots]
            last += [0] * cohort.n_dummy
            tokens = torch.tensor(last, dtype=torch.int32,
                                  device=e.device)[:, None]
        logits, cohort.cache = e.dispatch_decode(tokens, cohort.cache)
        e.metrics.n_decode_batches += 1
        e.metrics.n_decode_rows += len(cohort.slots)
        cohort.next_tokens = _greedy(logits)
        cohort.length += 1
        return logits

    def encode(self, cohort) -> None:
        """Per-step packed-spike re-encode of each slot's newest token."""
        e = self.engine
        if not e.spiking_packed:
            return
        cohort.spikes.update(e._slot_spikes(cohort))
        e._last_spike_words = cohort.spikes.words  # summary() reads it

    def retire(self) -> None:
        """Drop finished requests, gather surviving cache rows, release
        scheduler slots."""
        e = self.engine
        kept = []
        for cohort in e.cohorts:
            done = [st for st in cohort.slots if st.done]
            if not done:
                kept.append(cohort)
                continue
            for st in done:
                e._finish(st)
            e.scheduler.release(len(done))
            alive_idx = [i for i, st in enumerate(cohort.slots) if not st.done]
            if not alive_idx:
                continue
            cohort.cache = e.cache_ops.take(cohort.cache, alive_idx)
            cohort.slots = [cohort.slots[i] for i in alive_idx]
            cohort.n_dummy = 0
            cohort.next_tokens = None  # membership changed: host rebuilds
            if e.spiking_packed:
                cohort.spikes.take(alive_idx)
            kept.append(cohort)
        e.cohorts = kept

