"""Straggler detection (copy of `repro.ft.straggler`): per-step wall time
against a running median.

The clock is the host's: around an asynchronous CUDA step it measures the
enqueue unless the step ends in a synchronisation, so device step times come
from CUDA events or a synchronised host clock, not from this timer."""
from __future__ import annotations

import time
from collections import deque


class StepTimer:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 on_straggler=None):
        self.window = deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.events: list[dict] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.observe(time.monotonic() - self._t0)
        return False

    def observe(self, dt: float):
        """Feed one externally measured step time (the context manager's
        rule)."""
        med = self.median()
        self.window.append(dt)
        if med is not None and dt > self.threshold * med:
            ev = {"step_time": dt, "median": med, "ratio": dt / med}
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)

    def median(self):
        if len(self.window) < 5:
            return None
        s = sorted(self.window)
        return s[len(s) // 2]
