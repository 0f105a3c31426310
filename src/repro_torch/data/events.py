"""Synthetic DVS-gesture-style event sources, seeded and deterministic
(port of `repro.data.events`: the same numpy generators, so both packages
emit the same events for the same arguments).

Parametric generators of ``(x, y, polarity, t_us)`` int event rows, shaped
like a sensor watching simple moving stimuli, stand in for a real
event-camera dataset.  Each window draws from a fresh
``np.random.default_rng((seed, window))``, so any window can be regenerated
independently of stream order.

* `moving_blob_events` — a Gaussian blob orbiting the sensor; ``silent``
  marks windows that emit nothing (a quiet sensor between gestures), which
  the adaptive temporal axis skips.
* `rate_coded_events` — per-pixel Poisson counts proportional to a static
  intensity image (rate coding).
"""
from __future__ import annotations

import numpy as np

__all__ = ["moving_blob_events", "rate_coded_events", "split_into_windows"]


def _window_events(
    rng: np.random.Generator,
    n: int,
    cx: float,
    cy: float,
    radius: float,
    height: int,
    width: int,
    t_lo: int,
    t_hi: int,
) -> np.ndarray:
    x = np.clip(np.round(rng.normal(cx, radius, n)), 0, width - 1)
    y = np.clip(np.round(rng.normal(cy, radius, n)), 0, height - 1)
    p = rng.integers(0, 2, n)
    t = np.sort(rng.integers(t_lo, t_hi, n))
    return np.stack([x, y, p, t], axis=1).astype(np.int64)


def moving_blob_events(
    n_windows: int,
    *,
    height: int = 16,
    width: int = 16,
    window_us: int = 1000,
    events_per_window: int = 64,
    radius: float = 1.5,
    seed: int = 0,
    silent: tuple[int, ...] = (),
) -> np.ndarray:
    """Events from a blob orbiting the sensor center, one revolution per
    ``n_windows`` windows.  Returns a single time-sorted (N, 4) array of
    ``(x, y, polarity, t_us)`` covering ``[0, n_windows * window_us)``.
    Windows listed in ``silent`` emit no events (quiet sensor)."""
    if n_windows <= 0:
        raise ValueError(f"n_windows must be positive, got {n_windows}")
    silent_set = set(int(w) for w in silent)
    orbit = 0.3 * min(height, width)
    parts = []
    for w in range(n_windows):
        if w in silent_set:
            continue
        rng = np.random.default_rng((seed, w))
        phase = 2.0 * np.pi * w / n_windows
        cx = (width - 1) / 2.0 + orbit * np.cos(phase)
        cy = (height - 1) / 2.0 + orbit * np.sin(phase)
        parts.append(
            _window_events(
                rng, events_per_window, cx, cy, radius, height, width,
                w * window_us, (w + 1) * window_us,
            )
        )
    if not parts:
        return np.zeros((0, 4), np.int64)
    return np.concatenate(parts, axis=0)


def rate_coded_events(
    n_windows: int,
    *,
    height: int = 16,
    width: int = 16,
    window_us: int = 1000,
    rate: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Rate-coded events from a static diagonal-gradient intensity image:
    pixel (y, x) emits ``Poisson(rate * intensity)`` events per window,
    uniform in time within the window.  Returns a time-sorted (N, 4)
    array."""
    if n_windows <= 0:
        raise ValueError(f"n_windows must be positive, got {n_windows}")
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    yy, xx = np.mgrid[0:height, 0:width]
    intensity = (xx + yy) / float(max(height + width - 2, 1))  # [0, 1]
    parts = []
    for w in range(n_windows):
        rng = np.random.default_rng((seed, w))
        counts = rng.poisson(rate * intensity)
        n = int(counts.sum())
        if n == 0:
            continue
        y = np.repeat(yy.ravel(), counts.ravel())
        x = np.repeat(xx.ravel(), counts.ravel())
        p = rng.integers(0, 2, n)
        t = rng.integers(w * window_us, (w + 1) * window_us, n)
        order = np.argsort(t, kind="stable")
        parts.append(
            np.stack([x[order], y[order], p[order], t[order]], axis=1).astype(
                np.int64
            )
        )
    if not parts:
        return np.zeros((0, 4), np.int64)
    return np.concatenate(parts, axis=0)


def split_into_windows(
    events: np.ndarray, n_windows: int, window_us: int
) -> list[np.ndarray]:
    """Partition a time-sorted event array into per-window chunks — the
    shape a driver needs to feed `EventStream.push` one window at a time.
    Gap windows come back as (0, 4) arrays."""
    ev = np.asarray(events, np.int64).reshape(-1, 4)
    out = []
    for w in range(n_windows):
        t = ev[:, 3]
        out.append(ev[(t >= w * window_us) & (t < (w + 1) * window_us)])
    return out
