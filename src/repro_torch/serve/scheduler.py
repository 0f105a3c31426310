"""Request lifecycle + continuous-batching scheduler (port of
`repro.serve.scheduler`, with the prefix-hit lane; the streaming and drain
lanes are later slices).

* Admission control: a bounded waiting queue; `submit` rejects when the
  queue is full or the request can never fit (``prompt + max_new >
  max_len``).
* Prefill scheduling: FIFO, grouped into prefill batches by prompt-length
  bucket (exact length by default); the bucket of the oldest waiting
  request goes first, so long prompts are never starved.
* Slots: a request holds one slot from admission until it finishes.
* Prefix hits: with a `RadixPrefixIndex` attached, `submit` looks the
  prompt up; exact full-prompt hits wait in their own lane and are admitted
  into cohorts with the shared pages instead of a prefill.  The matched
  entry stays pinned from submit until the engine's admit completes
  (`release_hit_pins`), so eviction can never invalidate a queued hit.
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


@dataclass
class AdmissionTicket:
    """Structured admission outcome returned by `Scheduler.submit`:
    ``"queued"`` at submit, ``"admitted"`` once the request joins a prefill
    group, ``"rejected"`` on the `AdmissionError` a refused submit raises."""

    request: Request | None
    outcome: str = "queued"        # queued | admitted | rejected
    prefix_hit: bool = False       # matched a published prefix at submit
    reused_tokens: int = 0         # prompt tokens whose prefill is skipped
    reason: str | None = None

    @property
    def rid(self) -> int | None:
        return None if self.request is None else self.request.rid


class AdmissionError(RuntimeError):
    """Request rejected at submit time; carries its ticket as ``.ticket``."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.ticket = AdmissionTicket(request=None, outcome="rejected",
                                      reason=msg)


class Scheduler:
    """FIFO waiting queue with bucketed prefill-batch selection."""

    def __init__(self, *, max_slots: int, max_queue: int, max_len: int,
                 bucket_align: int = 1, prefix_index=None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.max_len = max_len
        self.bucket_align = bucket_align
        self.prefix_index = prefix_index
        self.waiting: deque[Request] = deque()
        self.hit_waiting: deque[tuple[Request, object]] = deque()
        self.active_slots = 0
        self._ids = itertools.count()
        self._tickets: dict[int, AdmissionTicket] = {}
        self.n_rejected = 0

    def _reject(self, msg: str) -> AdmissionError:
        self.n_rejected += 1
        return AdmissionError(msg)

    def submit(self, prompt, max_new_tokens: int) -> AdmissionTicket:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1 or max_new_tokens < 1:
            raise self._reject("empty prompt or non-positive max_new_tokens")
        need = bucket_key(prompt.shape[0], self.bucket_align) + max_new_tokens
        if need > self.max_len:
            raise self._reject(
                f"request needs {need} cache slots > engine max_len "
                f"{self.max_len}"
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

    @property
    def queue_depth(self) -> int:
        return len(self.waiting) + len(self.hit_waiting)

    @property
    def free_slots(self) -> int:
        return self.max_slots - self.active_slots

    def next_prefill_group(self) -> list[Request]:
        """Pop the next prefill batch: same-bucket requests, FIFO order, led
        by the oldest waiting request, capped by free slots ([] when nothing
        can run).  The caller releases slots with `release()`."""
        if not self.waiting or self.free_slots <= 0:
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
        if not self.hit_waiting or self.free_slots <= 0:
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
