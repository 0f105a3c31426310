"""Request lifecycle + continuous-batching scheduler (port of
`repro.serve.scheduler`, with the prefix-hit, stream and drain lanes).

* Admission control: a bounded waiting queue; `submit` rejects when the
  queue is full or the request can never fit (``prompt + max_new +
  speculation_slack > max_len``: a speculative round writes up to k + 1
  positions before acceptance is known).
* Prefill scheduling: FIFO, grouped into prefill batches by prompt-length
  bucket (exact length by default); the bucket of the oldest waiting
  request goes first, so long prompts are never starved.
* Slots: a request holds one slot from admission until it finishes.
* Prefix hits: with a `RadixPrefixIndex` attached, `submit` looks the
  prompt up; exact full-prompt hits wait in their own lane and are admitted
  into cohorts with the shared pages instead of a prefill.  The matched
  entry stays pinned from submit until the engine's admit completes
  (`release_hit_pins`), so eviction can never invalidate a queued hit.
* Streams: `submit_stream` queues a `StreamSession` whose prompt has not
  arrived yet; `schedule_streams` admits it, one session per cohort, once
  its first event window is complete.
* Drain (preemption): `close` rejects new submits with a ``draining``
  reason and schedules no further group; `drain` pops every waiting
  request for the handoff (terminal ``drained`` tickets); `restore`
  re-queues a handed-off request under its rid on the successor.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .batching import bucket_key


@dataclass
class Request:
    """One generation request (prompt in, greedy tokens out)."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    submit_time: float = field(default_factory=time.perf_counter)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclass
class RequestState:
    """Engine-side mutable state for an admitted request."""

    request: Request
    generated: list[int] = field(default_factory=list)
    first_token_time: float | None = None
    finish_time: float | None = None
    finish_reason: str | None = None  # "length" | "eos"

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def emit(self, token: int, eos_id: int | None) -> None:
        if self.done:  # a finished slot may still ride in a cohort briefly
            return
        now = time.perf_counter()
        if self.first_token_time is None:
            self.first_token_time = now
        self.generated.append(token)
        if eos_id is not None and token == eos_id:
            self.finish_reason, self.finish_time = "eos", now
        elif len(self.generated) >= self.request.max_new_tokens:
            self.finish_reason, self.finish_time = "length", now

    def emit_many(self, tokens, eos_id: int | None) -> int:
        """Emit a verified speculative prefix; returns how many tokens were
        recorded.  Stops at the first finish (EOS or budget): positions past
        it were computed against a stream the request never emitted."""
        n = 0
        for t in tokens:
            if self.done:
                break
            self.emit(int(t), eos_id)
            n += 1
        return n


@dataclass
class AdmissionTicket:
    """Structured admission outcome returned by `Scheduler.submit`:
    ``"queued"`` at submit, ``"admitted"`` once the request joins a prefill
    group, ``"rejected"`` on the `AdmissionError` a refused submit raises
    (reason ``"draining: ..."`` once admission is closed), ``"drained"``
    when `Scheduler.drain` pops it for a handoff."""

    request: Request | None
    outcome: str = "queued"        # queued | admitted | rejected | drained
    prefix_hit: bool = False       # matched a published prefix at submit
    reused_tokens: int = 0         # prompt tokens whose prefill is skipped
    reason: str | None = None

    @property
    def rid(self) -> int | None:
        return None if self.request is None else self.request.rid


def rebalance_pad(n_rows: int, data_axis: int) -> int:
    """Dummy rows that re-pack a cohort of ``n_rows`` live requests onto a
    mesh data axis of ``data_axis``: pad to the next multiple (the cheapest
    re-split that keeps whole rows per group), 0 when the cohort already
    divides the axis, the axis is trivial or the cohort is empty."""
    if data_axis <= 1 or n_rows <= 0:
        return 0
    return (-n_rows) % data_axis


class AdmissionError(RuntimeError):
    """Request rejected at submit time; carries its ticket as ``.ticket``."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.ticket = AdmissionTicket(request=None, outcome="rejected",
                                      reason=msg)


class Scheduler:
    """FIFO waiting queue with bucketed prefill-batch selection."""

    def __init__(self, *, max_slots: int, max_queue: int, max_len: int,
                 bucket_align: int = 1, prefix_index=None,
                 speculation_slack: int = 0):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if speculation_slack < 0:
            raise ValueError("speculation_slack must be >= 0")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.max_len = max_len
        # cache headroom reserved per request under a speculative policy (=
        # k): every round can run its full k + 1 verify window
        self.speculation_slack = speculation_slack
        self.bucket_align = bucket_align
        self.prefix_index = prefix_index
        self.waiting: deque[Request] = deque()
        self.hit_waiting: deque[tuple[Request, object]] = deque()
        self.stream_waiting: deque[tuple[object, Request]] = deque()
        self.active_slots = 0
        self._ids = itertools.count()
        self._tickets: dict[int, AdmissionTicket] = {}
        self.n_rejected = 0
        self.closed = False

    def _reject(self, msg: str) -> AdmissionError:
        self.n_rejected += 1
        return AdmissionError(msg)

    def _refuse_if_closed(self) -> None:
        if self.closed:
            raise self._reject(
                "draining: admission closed for preemption; "
                "resubmit to the successor engine"
            )

    def submit(self, prompt, max_new_tokens: int) -> AdmissionTicket:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._refuse_if_closed()
        if prompt.shape[0] < 1 or max_new_tokens < 1:
            raise self._reject("empty prompt or non-positive max_new_tokens")
        need = (bucket_key(prompt.shape[0], self.bucket_align)
                + max_new_tokens + self.speculation_slack)
        if need > self.max_len:
            raise self._reject(
                f"request needs {need} cache slots"
                + (f" (incl. speculation_slack={self.speculation_slack})"
                   if self.speculation_slack else "")
                + f" > engine max_len {self.max_len}"
            )
        if len(self.waiting) + len(self.hit_waiting) >= self.max_queue:
            raise self._reject(f"queue full ({self.max_queue} waiting)")
        req = Request(next(self._ids), prompt, max_new_tokens)
        ticket = AdmissionTicket(request=req)
        entry = (self.prefix_index.lookup(prompt)
                 if self.prefix_index is not None else None)
        if entry is not None:
            entry.pins += 1
            ticket.prefix_hit = True
            ticket.reused_tokens = entry.prompt_len
            self.hit_waiting.append((req, entry))
        else:
            self.waiting.append(req)
        self._tickets[req.rid] = ticket
        return ticket

    def _mark_admitted(self, rid: int) -> None:
        t = self._tickets.pop(rid, None)
        if t is not None:
            t.outcome = "admitted"

    # -- streaming lane -----------------------------------------------------
    def submit_stream(self, session, max_new_tokens: int) -> AdmissionTicket:
        """Queue a `StreamSession` whose prompt has not arrived yet.  It
        waits in its own lane until its first event window is complete
        (`schedule_streams`), then gets a cohort of its own; the request's
        prompt starts empty and fills with frame tokens as they land."""
        self._refuse_if_closed()
        if max_new_tokens < 1:
            raise self._reject("non-positive max_new_tokens")
        if max_new_tokens + 1 > self.max_len:
            raise self._reject(
                f"stream needs at least 1 frame + {max_new_tokens} generated"
                f" > engine max_len {self.max_len}"
            )
        if self.queue_depth >= self.max_queue:
            raise self._reject(f"queue full ({self.max_queue} waiting)")
        req = Request(next(self._ids), np.zeros((0,), np.int32), max_new_tokens)
        ticket = AdmissionTicket(request=req)
        self.stream_waiting.append((session, req))
        self._tickets[req.rid] = ticket
        return ticket

    def schedule_streams(self) -> list[tuple[object, Request]]:
        """Pop the sessions whose first window has landed, capped by free
        slots (one session per cohort).  A session that closed without a
        frame gets a terminal ``rejected`` ticket."""
        if self.closed or not self.stream_waiting:
            return []
        from .streaming import Backpressure

        admitted: list[tuple[object, Request]] = []
        kept: deque[tuple[object, Request]] = deque()
        for session, req in self.stream_waiting:
            try:
                session.poll()
            except Backpressure:
                pass  # the frames materialized so far stand
            if not session.frames:
                if session.delivered:
                    t = self._tickets.pop(req.rid, None)
                    if t is not None:
                        t.outcome = "rejected"
                        t.reason = "stream closed with no frames"
                    self.n_rejected += 1
                else:
                    kept.append((session, req))
                continue
            if self.free_slots > 0:
                self.active_slots += 1
                self._mark_admitted(req.rid)
                admitted.append((session, req))
            else:
                kept.append((session, req))
        self.stream_waiting = kept
        return admitted

    @property
    def queue_depth(self) -> int:
        return (len(self.waiting) + len(self.hit_waiting)
                + len(self.stream_waiting))

    @property
    def free_slots(self) -> int:
        return self.max_slots - self.active_slots

    def next_prefill_group(self) -> list[Request]:
        """Pop the next prefill batch: same-bucket requests, FIFO order, led
        by the oldest waiting request, capped by free slots ([] when nothing
        can run).  The caller releases slots with `release()`."""
        if self.closed or not self.waiting or self.free_slots <= 0:
            return []
        key = bucket_key(self.waiting[0].prompt_len, self.bucket_align)
        group: list[Request] = []
        kept: deque[Request] = deque()
        budget = self.free_slots
        for req in self.waiting:
            if (len(group) < budget
                    and bucket_key(req.prompt_len, self.bucket_align) == key):
                group.append(req)
            else:
                kept.append(req)
        self.waiting = kept
        self.active_slots += len(group)
        for req in group:
            self._mark_admitted(req.rid)
        return group

    def next_prefix_hits(self) -> list[tuple[Request, object]]:
        """Pop the next prefix-hit admission group: hits whose prompts have
        the same length (they join one cohort at sequence position
        ``prompt_len``), FIFO order led by the oldest hit, capped by free
        slots.  Entries stay pinned until the engine calls
        `release_hit_pins` after its admit."""
        if self.closed or not self.hit_waiting or self.free_slots <= 0:
            return []
        lead_len = self.hit_waiting[0][0].prompt_len
        group: list[tuple[Request, object]] = []
        kept: deque = deque()
        budget = self.free_slots
        for req, entry in self.hit_waiting:
            if len(group) < budget and req.prompt_len == lead_len:
                group.append((req, entry))
            else:
                kept.append((req, entry))
        self.hit_waiting = kept
        self.active_slots += len(group)
        for req, _ in group:
            self._mark_admitted(req.rid)
        return group

    def release_hit_pins(self, group: list[tuple[Request, object]]) -> None:
        """Release the submit-time pins of one selected hit group (called by
        the engine after, or on failure of, its admit)."""
        for _, entry in group:
            entry.pins -= 1

    def schedule_prefix_hits(self) -> list[list[tuple[Request, object]]]:
        """All prefix-hit groups runnable this step."""
        groups = []
        while True:
            g = self.next_prefix_hits()
            if not g:
                return groups
            groups.append(g)

    def schedule(self) -> list[list[Request]]:
        """All prefill groups runnable this step (distinct buckets until
        slots run out)."""
        groups = []
        while True:
            g = self.next_prefill_group()
            if not g:
                return groups
            groups.append(g)

    def release(self, n: int = 1) -> None:
        self.active_slots -= n
        if self.active_slots < 0:
            raise RuntimeError("released more slots than were active")

    # -- handoff: restore on the successor ----------------------------------
    def restore(self, req: Request) -> AdmissionTicket:
        """Re-queue a handed-off request under its own rid (the resume path,
        `serve/handoff.py`).  Capacity checks are skipped: the predecessor
        accepted it.  The prefix lookup runs again against this engine's
        index."""
        ticket = AdmissionTicket(request=req)
        entry = (self.prefix_index.lookup(req.prompt)
                 if self.prefix_index is not None else None)
        if entry is not None:
            entry.pins += 1
            ticket.prefix_hit = True
            ticket.reused_tokens = entry.prompt_len
            self.hit_waiting.append((req, entry))
        else:
            self.waiting.append(req)
        self._tickets[req.rid] = ticket
        return ticket

    def reserve_ids(self, start: int) -> None:
        """Start rid allocation at ``start``, past the handed-off requests,
        so restored and new requests never share a rid."""
        self._ids = itertools.count(start)

    # -- preemption drain ---------------------------------------------------
    def close(self) -> None:
        """Close admission (idempotent): new submits are rejected with a
        ``draining`` reason and no further prefill, hit or stream group is
        scheduled.  Admitted requests keep their slots."""
        self.closed = True

    def drain(self) -> list[tuple[Request, AdmissionTicket | None]]:
        """Pop every waiting request of the three lanes for the handoff, in
        FIFO order, prefill lane first, then prefix hits, then streams.
        Each ticket gets the terminal ``drained`` outcome and leaves the
        ticket map; hit entries are unpinned; a waiting stream hands off
        the frames it has completed as its prompt."""
        from .streaming import Backpressure

        self.close()
        out: list[tuple[Request, AdmissionTicket | None]] = []
        for req in self.waiting:
            out.append((req, self._mark_drained(req.rid)))
        for req, entry in self.hit_waiting:
            entry.pins -= 1
            out.append((req, self._mark_drained(req.rid)))
        for session, req in self.stream_waiting:
            try:
                session.poll()
            except Backpressure:
                pass  # the frames materialized so far stand
            req.prompt = session.prompt_tokens()
            out.append((req, self._mark_drained(req.rid)))
        self.waiting.clear()
        self.hit_waiting.clear()
        self.stream_waiting.clear()
        return out

    def _mark_drained(self, rid: int) -> AdmissionTicket | None:
        t = self._tickets.pop(rid, None)
        if t is not None:
            t.outcome = "drained"
        return t
