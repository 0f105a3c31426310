"""Preemption handling (copy of `repro.ft.preemption`): catch SIGTERM,
finish the in-flight step, checkpoint, exit cleanly.  The trainer polls
`should_stop` each step."""
from __future__ import annotations

import signal


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def trigger(self):
        self._flag = True

    def restore(self):
        """Reinstate the previous signal handlers (a second call is a
        no-op)."""
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass  # not the main thread
        self._old = {}
