"""Event-stream front end: prompts that arrive as sensor frames (port of
`repro.serve.streaming`; host code).

    sensor events --push--> EventStream --complete windows--> StreamSession
                            (append-only,          (encode_event_window ->
                             time-ordered,          packed words -> frame
                             watermarks)            token)
                                                           |
                                                           v
                                      Engine.submit_stream / executor ingest

**Watermarks.**  An `EventStream` cuts event time into windows ``[w *
window_us, (w + 1) * window_us)``.  A window is *complete* (safe to encode:
no event can still land in it) once an event with ``t >= (w + 1) *
window_us`` was pushed (pushes are time-ordered), once `close()` was called
(every window up to the one holding the last event), or once `tick(now_us)`
saw ``idle_timeout_us`` of event-time silence, which closes the stream.
The caller supplies the clock, so the timeout is deterministic.  Windows
without events still come out, empty: they encode to all-silent words.

**Backpressure.**  `push` raises `Backpressure` when more than
``max_buffered_windows`` complete windows wait unconsumed, and
`StreamSession.poll` when the session's frame budget (``max_len -
max_new_tokens``, bound by `Engine.submit_stream`) is spent.  Both are
recoverable: delay or drop upstream and retry.

**Frame tokens.**  A session's prompt is its sequence of frame tokens, one
per window: ``crc32(words) % vocab`` of the window's packed words (the
bytes of the reference's uint32 words: the port's int32 words carry the
same bits).  Feeding N frames one by one gives the tokens of submitting the
N frame tokens as one prompt.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.packing import MAX_T, encode_event_window


class Backpressure(RuntimeError):
    """Producer is ahead of the consumer: buffered windows or the session
    frame budget would overflow.  Recoverable — delay/drop upstream and
    retry."""


@dataclass
class Frame:
    """One complete, encoded event window."""

    index: int            # window index within the stream (0-based)
    token: int            # content-address of ``words`` in [0, vocab)
    words: np.ndarray     # (height * width,) int32 packed spike planes
    n_events: int         # events that landed in the window (0 for gaps)
    t_wall: float         # wall clock when the frame became available
                          # (basis for frame-to-first-token latency)


class EventStream:
    """Append-only, time-ordered buffer of sensor events with watermarks.

    Events are ``(x, y, polarity, t_us)`` int rows.  Pushes must be
    time-ordered *between* calls: the earliest event of a push may not
    precede the latest event of any prior push (within one push, order is
    free — window binning only looks at values).
    """

    def __init__(
        self,
        window_us: int,
        *,
        idle_timeout_us: int | None = None,
        max_buffered_windows: int = 64,
    ):
        if window_us <= 0:
            raise ValueError(f"window_us must be positive, got {window_us}")
        if idle_timeout_us is not None and idle_timeout_us <= 0:
            raise ValueError(
                f"idle_timeout_us must be positive, got {idle_timeout_us}"
            )
        if max_buffered_windows < 1:
            raise ValueError("max_buffered_windows must be >= 1")
        self.window_us = int(window_us)
        self.idle_timeout_us = (
            None if idle_timeout_us is None else int(idle_timeout_us)
        )
        self.max_buffered_windows = int(max_buffered_windows)
        self.closed = False
        self.last_t: int | None = None  # latest event time seen (event time)
        self.consumed = 0               # windows handed out via pop_window
        self._events: list[np.ndarray] = []
        self.n_events = 0

    # -- producer side ------------------------------------------------------

    def push(self, events: np.ndarray) -> None:
        """Append a batch of events.  (N, 4) int rows; N == 0 is a no-op."""
        if self.closed:
            raise RuntimeError("push on a closed EventStream")
        ev = np.asarray(events, np.int64).reshape(-1, 4)
        if ev.shape[0] == 0:
            return
        t = ev[:, 3]
        tmin, tmax = int(t.min()), int(t.max())
        if tmin < 0:
            raise ValueError(f"negative event time {tmin}")
        if self.last_t is not None and tmin < self.last_t:
            raise ValueError(
                f"out-of-order push: event t={tmin} precedes watermark "
                f"t={self.last_t} (pushes must be time-ordered)"
            )
        if self.n_complete_after(tmax) - self.consumed > self.max_buffered_windows:
            raise Backpressure(
                f"{self.n_complete_after(tmax) - self.consumed} complete "
                f"windows buffered > max_buffered_windows="
                f"{self.max_buffered_windows}; consume before pushing more"
            )
        self._events.append(ev)
        self.n_events += ev.shape[0]
        self.last_t = tmax if self.last_t is None else max(self.last_t, tmax)

    def close(self) -> None:
        """End-of-stream watermark: all windows become complete."""
        self.closed = True

    def tick(self, now_us: int) -> None:
        """Advance the idle clock.  If ``idle_timeout_us`` is configured and
        ``now_us`` is that far past the last event (or past stream creation
        time 0, for an event-less stream), the stream auto-closes.  The
        caller supplies the clock — event time, not wall time — so replays
        are deterministic."""
        if self.closed or self.idle_timeout_us is None:
            return
        anchor = 0 if self.last_t is None else self.last_t
        if int(now_us) - anchor >= self.idle_timeout_us:
            self.close()

    # -- watermark / consumer side ------------------------------------------

    def n_complete_after(self, last_t: int | None) -> int:
        """Complete windows implied by a latest-event-time watermark."""
        if self.closed:
            return 0 if last_t is None else last_t // self.window_us + 1
        if last_t is None:
            return 0
        # the window holding last_t is still open — more events may land
        return last_t // self.window_us

    @property
    def n_complete(self) -> int:
        """Windows currently safe to encode (including already-consumed)."""
        return self.n_complete_after(self.last_t)

    @property
    def exhausted(self) -> bool:
        """Closed and every complete window has been consumed."""
        return self.closed and self.consumed >= self.n_complete

    def pop_window(self) -> np.ndarray | None:
        """Pop the next complete window's events as an (N, 4) array (N may
        be 0 for a gap window), or None if no complete window is pending."""
        w = self.consumed
        if w >= self.n_complete:
            return None
        lo, hi = w * self.window_us, (w + 1) * self.window_us
        parts = []
        for ev in self._events:
            t = ev[:, 3]
            sel = ev[(t >= lo) & (t < hi)]
            if sel.shape[0]:
                parts.append(sel)
        self.consumed = w + 1
        # drop fully-consumed chunks so buffers do not grow with stream life
        self._events = [ev for ev in self._events if int(ev[:, 3].max()) >= hi]
        if not parts:
            return np.zeros((0, 4), np.int64)
        return np.concatenate(parts, axis=0)


class StreamSession:
    """A serving request whose prompt materializes incrementally.

    Wraps an `EventStream` and encodes each complete window into a `Frame`
    (packed words + frame token).  The engine admits the session once its
    first frame lands (`Scheduler.submit_stream` lane) and ingests later
    frames into the in-flight cohort as they complete.
    """

    def __init__(
        self,
        stream: EventStream,
        *,
        height: int,
        width: int,
        T: int,
        vocab: int,
    ):
        if T <= 0 or T > MAX_T:
            raise ValueError(f"T must be in [1, {MAX_T}], got {T}")
        if height <= 0 or width <= 0:
            raise ValueError(f"bad sensor extent {(height, width)}")
        if vocab <= 0:
            raise ValueError(f"vocab must be positive, got {vocab}")
        self.stream = stream
        self.height = int(height)
        self.width = int(width)
        self.T = int(T)
        self.vocab = int(vocab)
        self.max_frames: int | None = None  # bound by Engine.submit_stream
        self._frames: list[Frame] = []

    def frame_token(self, words: np.ndarray) -> int:
        """Deterministic content-address of a packed frame: crc32 % vocab."""
        return zlib.crc32(np.ascontiguousarray(words).tobytes()) % self.vocab

    def poll(self) -> list[Frame]:
        """Drain newly complete windows from the stream, encode them, and
        return the new frames.  All frames so far remain in `frames`."""
        new: list[Frame] = []
        while True:
            if (
                self.max_frames is not None
                and len(self._frames) >= self.max_frames
            ):
                if self.stream.consumed < self.stream.n_complete:
                    raise Backpressure(
                        f"session frame budget exhausted: {self.max_frames} "
                        "frames (= max_len - max_new_tokens) already ingested "
                        "and more windows are pending"
                    )
                break
            ev = self.stream.pop_window()
            if ev is None:
                break
            words = encode_event_window(
                ev, self.height, self.width, self.T, self.stream.window_us,
                t0=len(self._frames) * self.stream.window_us,
            ).numpy()
            frame = Frame(
                index=len(self._frames),
                token=self.frame_token(words),
                words=words,
                n_events=int(ev.shape[0]),
                t_wall=time.perf_counter(),
            )
            self._frames.append(frame)
            new.append(frame)
        return new

    @property
    def frames(self) -> list[Frame]:
        return self._frames

    @property
    def delivered(self) -> bool:
        """Stream closed and every window encoded — the prompt is final."""
        return self.stream.exhausted

    def prompt_tokens(self) -> np.ndarray:
        """The frame tokens materialized so far, as a prompt array."""
        return np.asarray([f.token for f in self._frames], np.int32)
