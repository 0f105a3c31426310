"""The engine's step, in stages (port of `repro.serve.executor`):

    admit -> prefill -> ingest -> merge -> decode -> sample -> encode -> retire

Two executors share the stage vocabulary, selected by
``ExecutionPolicy.execution``:

* `SyncExecutor` (``'sync'``): every stage completes on the host before the
  next begins; the sample stage copies each cohort's greedy tokens to the
  host, so it is also where every step waits for the device.
* `PipelinedExecutor` (``'pipelined'``): the greedy argmax of decode step
  *t* stays on the device and feeds the decode of step *t+1*; each step's
  tokens (and captured logits) go to pinned host memory by a non-blocking
  copy behind a CUDA event, and the host waits on that step's event alone,
  up to ``depth - 1`` steps later (`Engine(pipeline_depth=...)`).  Token
  *counts* are known on the host without a wait (each decode emits one
  token per slot), so budget exhaustion never needs the values; EOS is
  discovered up to ``depth - 1`` steps late and the decodes past it are
  discarded by `RequestState.emit` (rows are independent, and the
  admission bound ``prompt + max_new <= max_len`` keeps their writes
  inside the cache).  The packed-spike encode of the newest tokens is
  dispatched from the device argmax right after the decode
  (`PackedSpikeCache.update_async`).

Pipelining reorders host work only: every device computation gets the same
inputs in the same shapes as under sync (the device argmax IS the token the
sync path round-trips through the host), so tokens and captured logits are
equal bit for bit.  The decode and encode stages of a pipelined step make
no host wait: no device-to-host read and no pageable host-to-device copy
(`batching.upload`); `chip_smoke.py` holds them to that with
``torch.cuda.set_sync_debug_mode("error")``.

Speculative rounds (``ExecutionPolicy.speculation``) replace a cohort's
decode: the draft proposes k tokens in one chained dispatch (stage
``propose``), the target decodes the (B, k + 1) window [pending, drafts]
(``decode``), and ``sample_sync`` lands the target's argmax and the drafts
in one copy, accepts the longest matching prefix on the host and rewinds
the rejected positions.  Rounds are synchronous under either executor
(flush first, then emit): only verified tokens reach `RequestState`.

Stream cohorts (``Engine.submit_stream``) ingest each newly complete frame
as one (B, 1) decode-shaped dispatch (stage ``ingest``), keeping its
argmax on the device as the go-live candidate; a flush never lands it.
When the stream closes, the last frame's argmax is the first generated
token, as the last position of a prefill over the same frame tokens.

Every stage is timed into `EngineMetrics.stage_s`: under sync the per-step
host wait shows in ``sample_sync``; under pipelined the decode stage is
dispatch only and ``sample_sync`` is the deferred drain.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.ft.straggler import StepTimer

from .batching import bucket_key, pad_batch, upload
from .policy import acceptance_lengths
from .scheduler import Request, RequestState, rebalance_pad


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


@dataclass
class PendingStep:
    """One decode step whose sampled tokens are still in flight.

    ``tokens``: (B,) int32 argmax (all cohort rows, dummies included);
    ``logits``: (n_live, vocab) f32 last-position logits, kept only when the
    engine captures traces.  On a CUDA device both are pinned host copies
    that land when ``ready`` has been reached; on the CPU they are the
    values themselves and ``ready`` is None.  A stream cohort's go-live
    candidate is a step built directly from device values (no copy)."""

    tokens: torch.Tensor
    logits: torch.Tensor | None = None
    ready: torch.cuda.Event | None = None

    @classmethod
    def launch(cls, tokens: torch.Tensor,
               logits: torch.Tensor | None) -> "PendingStep":
        """Start the copies of one step's device results to the host."""
        if tokens.device.type != "cuda":
            return cls(tokens, logits)
        host_tokens = tokens.to("cpu", non_blocking=True)
        host_logits = (None if logits is None
                       else logits.to("cpu", non_blocking=True))
        ready = torch.cuda.Event()
        ready.record()
        return cls(host_tokens, host_logits, ready)

    def land(self) -> tuple[np.ndarray, np.ndarray | None]:
        """Wait for this step's copies alone; (tokens, logits) on the host."""
        if self.ready is not None:
            self.ready.synchronize()
        return (self.tokens.numpy(),
                None if self.logits is None else self.logits.numpy())


class SyncExecutor:
    """Reference staged executor.  Holds no request state: cohorts,
    scheduler, metrics and the dispatch callables live on the engine; the
    executor owns the order and the stage boundaries."""

    def __init__(self, engine):
        self.engine = engine

    def _clock(self, stage: str) -> _StageClock:
        return _StageClock(self.engine.metrics, stage)

    def step(self) -> dict:
        """One engine iteration: admit (prefix hits, then prefills), merge,
        decode/sample/encode per cohort, retire."""
        e = self.engine
        t0 = time.perf_counter()
        e.metrics.sample_queue_depth(e.scheduler.queue_depth)
        with self._clock("admit"):
            # prefix hits first: prefill-free admissions that use free
            # slots at page-table cost before any prefill batch
            hit_groups = (e.scheduler.schedule_prefix_hits()
                          if e.prefix_index is not None else [])
            groups = e.scheduler.schedule()
            streams = e.scheduler.schedule_streams()
        for group in hit_groups:
            with self._clock("admit_hits"):
                e.admit_prefix_hits(group)
        for group in groups:
            self.prefill(group)
        for session, req in streams:
            self.admit_stream(session, req)
        with self._clock("ingest"):
            self.ingest()  # stream frames -> decode-shaped chunks
        with self._clock("merge"):
            self.merge()  # flushes merging cohorts (pipelined)
        with self._clock("retire"):
            self.retire()  # requests finished at prefill never enter decode
        for cohort in e.cohorts:
            if cohort.stream is not None:
                continue  # ingesting: generation starts at go-live
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
        first token (a host event: TTFT) and opens a cohort."""
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
            cohort.next_tokens = first_dev  # device feedback for the decode
            if e.spiking_packed:
                cohort.spikes = e.new_spike_cache()
                cohort.spikes.append(e._slot_spikes(cohort))
            e.cohorts.append(cohort)
            # publish prompts into the radix index NOW, before any decode
            # writes the rows' tail pages (no-op without a prefix index)
            e.publish_prefix(cohort)

    # -- streaming stages (serve/streaming.py) ------------------------------
    def admit_stream(self, session, req: Request) -> None:
        """Admit a stream session into a cohort of its own: a prefill over
        its first frame's token alone, emitting nothing.  The argmax rides
        in ``cohort.pending`` as the go-live candidate."""
        e = self.engine
        with self._clock("prefill"):
            f0 = session.frames[0]
            req.prompt = np.asarray([f0.token], np.int32)
            tokens, n_dummy = pad_batch(np.asarray([[f0.token]], np.int32),
                                        e.batch_align)
            e.metrics.n_padded_rows += n_dummy
            logits, cache = e.dispatch_prefill(tokens)
            e.metrics.n_prefill_batches += 1
            cohort = e.new_cohort(slots=[RequestState(req)], cache=cache,
                                  length=1, n_dummy=n_dummy, stream=session)
            cohort.pending.append(self._candidate(logits))
            e.record_timestep_skips(upload(f0.words[None], torch.int32,
                                           e.device))
            e.metrics.n_stream_sessions += 1
            e.metrics.n_stream_windows += 1
            e.cohorts.append(cohort)

    def _candidate(self, logits) -> PendingStep:
        """The go-live candidate of an ingest dispatch, left on the device."""
        return PendingStep(
            _greedy(logits),
            logits[:1, -1].float() if self.engine.capture_logits else None)

    def ingest(self) -> None:
        """Each newly complete frame of every ingesting cohort appends as one
        (B, 1) decode-shaped dispatch: position p holds what a prefill over
        the same frame tokens holds there.  Once the stream has closed and
        every frame is in, the cohort goes live."""
        e = self.engine
        for cohort in e.cohorts:
            session = cohort.stream
            if session is None:
                continue
            session.poll()
            frames = session.frames
            while cohort.length < len(frames):
                f = frames[cohort.length]
                row = [f.token] + [0] * cohort.n_dummy
                tokens = upload(row, torch.int32, e.device)[:, None]
                logits, cohort.cache = e.dispatch_decode(tokens, cohort.cache)
                cohort.length += 1
                cohort.pending = [self._candidate(logits)]
                e.record_timestep_skips(upload(f.words[None], torch.int32,
                                               e.device))
                e.metrics.n_stream_windows += 1
            cohort.slots[0].request.prompt = session.prompt_tokens()
            if session.delivered:
                self._go_live(cohort)

    def _go_live(self, cohort) -> None:
        """The stream closed and every frame is in: emit the first
        generated token (the last ingested frame's argmax) and hand the
        cohort to the decode lifecycle."""
        e = self.engine
        session, st = cohort.stream, cohort.slots[0]
        p = cohort.pending.pop()
        cohort.pending = []
        if p.logits is not None:
            e._capture(cohort.slots, p.logits.cpu().numpy()[:, None])
        st.emit(int(p.tokens[0].item()), e.eos_id)
        cohort.next_tokens = p.tokens  # device feedback for the next decode
        cohort.stream = None
        if e.spiking_packed:
            cohort.spikes = e.new_spike_cache()
            cohort.spikes.append(e._slot_spikes(cohort))
        # frame-to-first-token: each frame waited from its completion on
        for f in session.frames:
            e.metrics.stream_frame_latency_s.append(
                st.first_token_time - f.t_wall)

    def merge(self) -> None:
        """Merge cohorts at the same sequence position: caches concat along
        their batch axes (or their page tables), alignment rows are dropped
        so live rows stay a prefix.  Ingesting stream cohorts never merge:
        their length is still moving; nor do the cohorts of an engine with
        ``merge_cohorts`` off (a row-coupled arch)."""
        e = self.engine
        if not e.merge_cohorts or len(e.cohorts) < 2:
            return
        by_len: dict[int, list] = {}
        merged = []
        for c in e.cohorts:
            if c.stream is not None:
                merged.append(c)
                continue
            by_len.setdefault(c.length, []).append(c)
        for length, group in by_len.items():
            if len(group) == 1:
                merged.append(group[0])
                continue
            for c in group:
                self.flush(c)  # host state authoritative before re-batching
            cache = e.cache_ops.concat([e._live_cache(c) for c in group])
            slots = [s for c in group for s in c.slots]
            cohort = e.new_cohort(slots=slots, cache=cache, length=length)
            if e.spiking_packed:
                cohort.spikes = group[0].spikes
                for c in group[1:]:
                    cohort.spikes.merge(c.spikes)
            if e.speculative:
                # draft caches ride the merge only when every member has
                # one at the same catch-up offset; otherwise they rebuild
                if (all(c.draft_cache is not None for c in group)
                        and len({c.draft_behind for c in group}) == 1):
                    cohort.draft_cache = e.cache_ops.concat(
                        [c.draft_cache for c in group])
                    cohort.draft_behind = group[0].draft_behind
                else:
                    for c in group:
                        e.release_draft(c)
            merged.append(cohort)
            e.metrics.n_merges += len(group) - 1
        e.cohorts = merged

    def decode_cohort(self, cohort) -> None:
        """decode -> sample -> encode for one cohort (or a speculative
        round in its place)."""
        e = self.engine
        if self._maybe_speculative(cohort):
            return
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
            tokens = upload(last, torch.int32, e.device)[:, None]
        logits, cohort.cache = e.dispatch_decode(tokens, cohort.cache)
        e.metrics.n_decode_batches += 1
        e.metrics.n_decode_rows += len(cohort.slots)
        cohort.next_tokens = _greedy(logits)
        cohort.length += 1
        return logits

    # -- speculative decoding (ExecutionPolicy.speculation) ------------------
    def _spec_k(self, cohort) -> int:
        """This round's proposal length: the policy's k, bounded by the
        furthest live row's remaining budget (the verify always lands one
        bonus token, hence the - 1) and by the cache extent (the verify
        window writes k + 1 positions)."""
        e = self.engine
        budgets = [st.request.max_new_tokens - len(st.generated)
                   for st in cohort.slots if not st.done]
        if not budgets:
            return 0
        k = min(e.policy.speculation.k, max(budgets) - 1,
                e.max_len - 1 - cohort.length)
        return max(k, 0)

    def _maybe_speculative(self, cohort) -> bool:
        """Run a propose/verify round instead of a decode when the policy
        speculates and the cohort can use a window.  A plain decode leaves
        the draft cache behind, so falling back releases it."""
        e = self.engine
        if not e.speculative or cohort.stream is not None:
            return False
        k = self._spec_k(cohort)
        if k < 1:
            e.release_draft(cohort)
            return False
        self.speculative_round(cohort, k)
        return True

    def _ensure_draft(self, cohort) -> None:
        """(Re)build the draft cache with one draft prefill of each row's
        prompt + ``generated[:-1]`` (everything already fed to the target;
        the pending last token is what the propose feeds).  Done and dummy
        rows get zero rows: their proposals are never emitted."""
        e = self.engine
        if cohort.draft_cache is not None:
            return
        B = len(cohort.slots) + cohort.n_dummy
        L = cohort.length
        tokens = np.zeros((B, L), np.int32)
        for i, st in enumerate(cohort.slots):
            gen = st.generated[:-1] if st.generated else []
            gen = gen[-L:] if len(gen) > L else gen
            Pb = max(0, L - len(gen))
            prompt = np.asarray(st.request.prompt, np.int32)[:Pb]
            tokens[i, : len(prompt)] = prompt
            tokens[i, Pb: Pb + len(gen)] = gen
        cohort.draft_cache = e.dispatch_draft_prefill(tokens)
        cohort.draft_behind = 0

    def _draft_chunk(self, cohort, pending: torch.Tensor) -> torch.Tensor:
        """(B, catchup) tokens of the propose: the pending token, preceded by
        the previous emitted token when a fully accepted round left the
        draft one position behind."""
        if cohort.draft_behind == 0:
            return pending[:, None]
        prev = [st.generated[-2] if len(st.generated) >= 2 else 0
                for st in cohort.slots]
        prev += [0] * cohort.n_dummy
        prev_dev = upload(prev, torch.int32, self.engine.device)
        return torch.stack([prev_dev, pending], dim=1)

    def speculative_round(self, cohort, k: int) -> None:
        """One round: the draft proposes ``k`` tokens in one chained dispatch
        (`Engine.dispatch_propose`), the target verifies all ``k + 1``
        positions in one decode, and each row emits its longest matching
        prefix plus the target's bonus token.  Every emitted token is a
        target argmax.  Rows share their position locals, so the cohort
        advances by the smallest acceptance over live rows; the rest rolls
        back by `Engine.rewind_cache`.  The round's only host read is one
        copy of the target argmax and the drafts, in ``sample_sync``."""
        e = self.engine
        self.flush(cohort)  # host state authoritative (no-op in sync)
        with self._clock("propose"):
            self._ensure_draft(cohort)
            if cohort.next_tokens is not None:
                pending = cohort.next_tokens
            else:  # membership changed since the last step
                last = [st.generated[-1] for st in cohort.slots]
                last += [0] * cohort.n_dummy
                pending = upload(last, torch.int32, e.device)
            chunk = self._draft_chunk(cohort, pending)
            draft_dev, cohort.draft_cache = e.dispatch_propose(
                chunk, cohort.draft_cache, k)
            e.metrics.n_draft_batches += 1
        with self._clock("decode"):
            verify = torch.cat([pending[:, None], draft_dev], dim=1)
            logits, cohort.cache = e.dispatch_decode(verify, cohort.cache)
            e.metrics.n_decode_batches += 1
            e.metrics.n_decode_rows += len(cohort.slots)
            tgt_dev = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, k+1)
            landing = PendingStep.launch(
                torch.cat([tgt_dev, draft_dev], dim=1),
                logits[: len(cohort.slots)].float()
                if e.capture_logits else None)
        with self._clock("sample_sync"):
            both, lg = landing.land()
            tgt, drafts = both[:, : k + 1], both[:, k + 1:]
            acc = acceptance_lengths(drafts, tgt)
            live = [i for i, st in enumerate(cohort.slots) if not st.done]
            A = int(min((int(acc[i]) for i in live), default=k))
            n_live = len(live)
            e.metrics.n_speculative_rounds += 1
            e.metrics.n_tokens_proposed += k * n_live
            e.metrics.n_tokens_accepted += A * n_live
            e.metrics.n_tokens_rejected += (k - A) * n_live
            if lg is not None:
                # one capture + emit per landed position, token-major: one
                # trace row per emitted token, as a step at a time
                for j in range(A + 1):
                    e._capture(cohort.slots, lg[:, j: j + 1])
                    for i, st in enumerate(cohort.slots):
                        st.emit(int(tgt[i, j]), e.eos_id)
            else:
                for i, st in enumerate(cohort.slots):
                    st.emit_many(tgt[i, : A + 1], e.eos_id)
            cohort.cache = e.rewind_cache(cohort.cache, k - A)
            if A < k:
                # the draft consumed rejected tokens past the acceptance
                # point: back to one short of the target (the bonus token is
                # pending, fed nowhere yet)
                cohort.draft_cache = e.rewind_cache(cohort.draft_cache,
                                                    k - A - 1)
                cohort.draft_behind = 0
            else:
                # full acceptance: the draft never fed its own last proposal
                cohort.draft_behind = 1
            cohort.length += A + 1
            cohort.next_tokens = tgt_dev[:, A].contiguous()
        with self._clock("encode"):
            self.encode(cohort)

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
            if cohort.pending:
                # pipelined cohorts flush before any membership change, so
                # a cohort with in-flight steps has no known-done slot
                kept.append(cohort)
                continue
            done = [st for st in cohort.slots if st.done]
            if not done:
                kept.append(cohort)
                continue
            for st in done:
                e._finish(st)
            e.scheduler.release(len(done))
            alive_idx = [i for i, st in enumerate(cohort.slots) if not st.done]
            if not alive_idx:
                e.release_cohort(cohort)  # paged: pages back to the pool
                continue
            cohort.cache = e.cache_ops.take(cohort.cache, alive_idx)
            if cohort.draft_cache is not None:
                # the draft holds the target's rows: the survivors follow
                cohort.draft_cache = e.cache_ops.take(cohort.draft_cache,
                                                      alive_idx)
            cohort.slots = [cohort.slots[i] for i in alive_idx]
            cohort.n_dummy = 0
            cohort.next_tokens = None  # membership changed: host rebuilds
            if e.spiking_packed:
                cohort.spikes.take(alive_idx)
            self.rebalance(cohort)
            kept.append(cohort)
        e.cohorts = kept

    def rebalance(self, cohort) -> None:
        """Load-skew hook: a no-op under sync (a cohort whose rows stop
        dividing the data axis runs whole on mesh row 0, the replicated
        fallback); the pipelined executor re-packs."""

    # -- pipelining hooks (no-ops here) -------------------------------------
    def flush(self, cohort) -> None:
        """Materialize any deferred device state (none in sync mode)."""

    def drain(self) -> None:
        """Drain in-flight steps across cohorts (none in sync mode)."""


class PipelinedExecutor(SyncExecutor):
    """In-flight-window executor: decode dispatch never waits on the host.

    ``depth`` is the in-flight window: up to ``depth - 1`` decode steps may
    have un-landed tokens at any time; each step's drain lands the oldest
    pending step while the newer ones run on the device."""

    def __init__(self, engine, depth: int = 2,
                 straggler_threshold: float = 3.0):
        super().__init__(engine)
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if not engine.row_independent:
            # row-coupled decode (MoE capacity routing): a done-but-unlanded
            # slot riding through a decode would change the other rows
            # against sync, which retires it first.  Window 1 lands each
            # step before the next dispatches.
            depth = 1
        self.depth = depth
        # straggler fold (ft/straggler.py): the per-step decode-stage time
        # from EngineMetrics.stage_s feeds the running-median detector; a
        # detection flushes and re-packs every cohort at the end of the step
        self.step_timer = StepTimer(
            window=32, threshold=straggler_threshold,
            on_straggler=self._on_straggler,
        )
        self._force_repack = False

    def _on_straggler(self, event: dict) -> None:
        self.engine.metrics.n_straggler_events += 1
        self._force_repack = True

    def step(self) -> dict:
        e = self.engine
        decode_before = e.metrics.stage_s.get("decode", 0.0)
        out = super().step()
        decode_delta = e.metrics.stage_s.get("decode", 0.0) - decode_before
        if decode_delta > 0.0:  # only steps that decoded
            self.step_timer.observe(decode_delta)
        if self._force_repack:
            self._force_repack = False
            self.repack()
        return out

    def repack(self) -> None:
        """Straggler response: flush every cohort and re-pack it through the
        rebalance path (row placement only: dummy rows re-pad to the data
        axis, so the next decode splits rows evenly; tokens are untouched)."""
        e = self.engine
        for cohort in e.cohorts:
            if cohort.stream is not None:
                continue  # ingesting: re-packed at go-live
            self.flush(cohort)
            cohort.cache = e._live_cache(cohort)
            cohort.next_tokens = None
            self.rebalance(cohort)

    def decode_cohort(self, cohort) -> None:
        """decode (dispatch only) -> encode (from the device tokens) ->
        drain (land the steps beyond the in-flight window)."""
        e = self.engine
        if not self._count_alive(cohort):
            # every slot's budget is (or may be) spent once the in-flight
            # steps land: land them and let retire run
            with self._clock("sample_sync"):
                self.flush(cohort)
            return
        if self._maybe_speculative(cohort):
            return  # rounds are synchronous: nothing enters the window
        with self._clock("decode"):
            logits = self._dispatch_decode(cohort)
            cohort.pending.append(PendingStep.launch(
                cohort.next_tokens,
                (logits[: len(cohort.slots), -1].float()
                 if e.capture_logits else None),
            ))
        with self._clock("encode"):
            self.encode(cohort)
        with self._clock("sample_sync"):
            self._drain_cohort(cohort)

    def _count_alive(self, cohort) -> bool:
        """Host-only liveness: could any slot still accept a token after
        every in-flight step lands?  Uses token COUNTS (one token per slot
        per step), never values, so it costs no wait.  EOS can only end a
        request earlier: this is an upper bound, and a decode past an
        un-landed EOS is discarded work, never corruption."""
        window = len(cohort.pending)
        return any(
            not st.done
            and len(st.generated) + window < st.request.max_new_tokens
            for st in cohort.slots
        )

    def encode(self, cohort) -> None:
        """Packed-spike encode of the newest tokens straight from the device
        argmax, staged without a wait (`update_async`)."""
        e = self.engine
        if not e.spiking_packed:
            return
        toks = cohort.next_tokens[: len(cohort.slots)]
        cohort.spikes.update_async(e._encode_pack(e.params, toks))

    def _drain_cohort(self, cohort) -> None:
        """Land pending steps beyond the in-flight window; the wait on the
        oldest step's event overlaps the decodes still on the device."""
        while len(cohort.pending) >= self.depth:
            if self._materialize(cohort):
                # a slot finished: flush so retire sees host-true state
                self.flush(cohort)

    def _materialize(self, cohort) -> bool:
        """Land the oldest pending step on the host: emit tokens, capture
        logits.  Returns True when a slot finished (EOS or budget)."""
        e = self.engine
        toks, logits = cohort.pending.pop(0).land()
        if logits is not None:
            e._capture(cohort.slots, logits[:, None])
        for st, tok in zip(cohort.slots, toks):
            st.emit(int(tok), e.eos_id)
        return any(st.done for st in cohort.slots)

    def flush(self, cohort) -> None:
        """Land ALL in-flight steps (forced before merge and retire, and
        when the cohort's budget is spent).  An ingesting stream cohort's
        ``pending`` holds its go-live candidate, not an emitted step: only
        `_go_live` lands it."""
        if cohort.stream is not None:
            return
        while cohort.pending:
            self._materialize(cohort)
        if self.engine.spiking_packed and cohort.spikes is not None:
            self.engine._last_spike_words = cohort.spikes.words

    def drain(self) -> None:
        for cohort in self.engine.cohorts:
            self.flush(cohort)


    def rebalance(self, cohort) -> None:
        """Re-pack a mesh cohort whose surviving rows stopped dividing the
        data axis: pad dummy rows (zero cache rows, outputs discarded) up
        to the next multiple, so its decodes keep splitting into data
        groups instead of running whole on mesh row 0."""
        e = self.engine
        if e.mesh is None or not e.row_independent:
            return
        pad = rebalance_pad(len(cohort.slots), e.mesh.shape["data"])
        if pad == 0:
            return
        cohort.cache = e.cache_ops.pad_rows(cohort.cache, pad)
        if cohort.draft_cache is not None:
            # the draft mirrors the target's rows (dummy rows propose
            # tokens nobody emits)
            cohort.draft_cache = e.cache_ops.pad_rows(cohort.draft_cache, pad)
        cohort.n_dummy = pad
        e.metrics.n_rebalances += 1
        e.metrics.n_padded_rows += pad


def make_executor(engine, policy, *, depth: int = 2) -> SyncExecutor:
    """Build the executor the policy's ``execution`` axis names."""
    if policy.execution == "pipelined":
        return PipelinedExecutor(engine, depth=depth)
    return SyncExecutor(engine)
