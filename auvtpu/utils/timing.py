"""Timing utilities.

The reference times each batch end-to-end with std::chrono around the call,
including H2D/D2H staging and the device sync (GridD.cu:107-147 inside the
timed region; SURVEY.md §5 'Tracing').  We report both:

- ``warm_e2e_ms``: one compiled call including the result's readback to the
  host — the reference-comparable number;
- ``steady_state_ms``: the median of individually synced calls
  (``jax.block_until_ready``), result left on the device — the serving
  number.

Dispatch is asynchronous, so every timed region ends in a sync.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def _readback(x):
    """Wait for the device, then copy every array leaf to the host."""
    jax.device_get(jax.block_until_ready(x))
    return x


def time_once_ms(fn, *args) -> tuple[float, object]:
    """One call including any compilation and the result readback."""
    t0 = time.perf_counter()
    out = _readback(fn(*args))
    return (time.perf_counter() - t0) * 1e3, out


def warm_e2e_ms(fn, *args, reps: int = 3):
    """Warm end-to-end: one compiled dispatch + full result readback.

    The reference's timed region is exactly this shape on an already-built
    kernel (GridD.cu:107-147: per-batch staging + launch + sync + D2H) and
    never includes compilation.  Calls fn once un-timed (absorbing any
    compile), then reports the fastest of ``reps`` timed calls."""
    out = _readback(fn(*args))
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        out = _readback(fn(*args))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def steady_state_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median over ``iters`` calls, each ended by jax.block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3
