"""Profiling helpers (SURVEY §5 'Tracing': the reference has wall-clock-only
timing; the equivalent here is jax.profiler traces + the timing utils)."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(out_dir: str | None):
    """Context manager: capture a jax.profiler trace into ``out_dir`` (view
    with TensorBoard / xprof).  No-op when out_dir is falsy."""
    if not out_dir:
        yield
        return
    import jax

    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        yield


# lines of a GPU device plane that repeat or group the kernels of the
# stream lines (counting them would double the busy time)
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework", "Source", "TensorFlow")


def device_busy(trace_dir: str, device: str = "/device:GPU:0"):
    """Reduce the newest jax.profiler trace under ``trace_dir`` to
    (busy_ns, window_ns, kernel_ns) for ``device``: busy is the union of the
    intervals in which a kernel ran on any of its stream lines, the window
    spans the first kernel's start to the last kernel's end, and kernel_ns
    sums device time per kernel name.  Idle share = 1 - busy / window."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name == device]
    if not planes:
        raise ValueError(f"trace has no plane {device}: {[p.name for p in data.planes]}")
    spans, kernel_ns = [], {}
    for line in planes[0].lines:
        if line.name.startswith(_DERIVED_LINES):
            continue
        for ev in line.events:
            spans.append((ev.start_ns, ev.end_ns))
            kernel_ns[ev.name] = kernel_ns.get(ev.name, 0.0) + ev.duration_ns
    if not spans:
        raise ValueError(f"no kernel ran on {device} in the traced window")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, cur_e - spans[0][0], kernel_ns
