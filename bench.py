"""Headline benchmark: masked-point ordinary-kriging fill throughput on the GPU.

Workload (method- and config-matched to the reference): Kerguelen-Plateau-sized
tile (2053x2441 = 5.01M cells; the reference tile is a missing large blob, so
a synthetic stand-in of identical shape/bounds is used), 10% random mask
(~501k masked points, results/TestingResults1.csv:348-385 in the reference),
ordinary kriging with the reference variogram (nugget 1, sill 100, range 10).

Baseline: the reference's published GPU (GeForce MX550) kriging on this
config ran 726-788 ms end-to-end => ~661k masked points/s (BASELINE.md
'Additional raw data points') — the reference's own hardware, not this card.

Timing: one jitted step (fill + RMSE over the masked cells) per call, each
ended by jax.block_until_ready; the median of STEPS calls after WARMUP
calls.  Then a separate profiler-traced window of TRACE_STEPS steps gives
the device's idle share (trace under results_local/bench_trace/).  The
backend is the one ops.backend.resolve picks for the device.  Exits
non-zero without a GPU.  Prints ONE JSON line.
"""

import json
import os
import shutil
import sys
import time

import numpy as np

REMOVAL = 0.10
SHAPE = (2053, 2441)
BASELINE_PTS_PER_S = 500_688 / 0.757  # reference MX550 GPU kriging, Kerguelen 0.10
WARMUP, STEPS, TRACE_STEPS = 3, 30, 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_workload(shape=SHAPE, seed: int = 42):
    """(reduced plane with NaN gaps, masked (row, col) (N, 2), truth (N,))."""
    from auvtpu.masking import mask_grid
    from auvtpu.synthetic import kerguelen_standin

    return mask_grid(kerguelen_standin(shape), REMOVAL, seed)


def make_step(fill, n_pts: int):
    """Jitted bench step: the fill plane, then RMSE and a checksum over the
    masked cells (dense planes, so the step stays gather-free)."""
    import jax
    import jax.numpy as jnp

    def step(grid, truth_d, mask_d):
        plane = fill(grid)
        ok = mask_d * (~jnp.isnan(plane)).astype(jnp.float32)
        d = jnp.where(ok > 0, truth_d - plane, 0.0)
        rmse = jnp.sqrt(jnp.sum(d * d) / n_pts)
        return rmse, jnp.sum(jnp.where(ok > 0, plane, 0.0))

    return jax.jit(step)


def dense_truth(reduced, rc, truth):
    """Truth and mask as dense f32 planes on the device."""
    import jax.numpy as jnp

    truth_plane = np.zeros(reduced.shape, np.float32)
    truth_plane[rc[:, 0], rc[:, 1]] = truth
    mask_plane = np.zeros(reduced.shape, np.float32)
    mask_plane[rc[:, 0], rc[:, 1]] = 1.0
    return jnp.asarray(truth_plane), jnp.asarray(mask_plane)


def main():
    t_start = time.time()
    import jax

    from auvtpu.config import KERGUELEN_EXTENT
    from auvtpu.grid import RegularGrid
    from auvtpu.ops import fill_kriging
    from auvtpu.ops.backend import resolve
    from auvtpu.utils.device import gpu_name_and_power_limit, require_gpu
    from auvtpu.utils.profiling import device_busy, trace
    from auvtpu.utils.timing import steady_state_ms

    devs = require_gpu()
    dev = devs[0]
    card = gpu_name_and_power_limit()
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}; {card}")

    reduced, rc, truth = load_workload()
    n_pts = len(truth)
    grid = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT)
    truth_d, mask_d = dense_truth(reduced, rc, truth)
    backend = resolve(dev.platform, grid.dtype)
    log(f"workload {SHAPE}, {n_pts} masked pts, backend {backend}; "
        f"set-up {time.time() - t_start:.1f}s")

    step = make_step(lambda g: fill_kriging(g, backend=backend), n_pts)
    t0 = time.time()
    rmse, chk = step(grid, truth_d, mask_d)
    rmse = float(rmse)
    log(f"compile+first step {time.time() - t0:.1f}s; RMSE={rmse:.4f} m checksum={float(chk):.1f}")
    if not np.isfinite(rmse):
        raise SystemExit("non-finite RMSE")

    ms = steady_state_ms(step, grid, truth_d, mask_d, iters=STEPS, warmup=WARMUP)
    pts_per_s = n_pts / (ms / 1e3)
    log(f"steady state: {ms:.3f} ms/step (median of {STEPS}) -> "
        f"{pts_per_s / 1e6:.2f} M masked pts/s on {card}")

    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "results_local", "bench_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with trace(trace_dir):
        for _ in range(TRACE_STEPS):
            jax.block_until_ready(step(grid, truth_d, mask_d))
    busy_ns, window_ns, kernel_ns = device_busy(trace_dir)
    idle = 1.0 - busy_ns / window_ns
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:5]
    log(f"traced {TRACE_STEPS} steps: device busy {busy_ns / 1e6:.3f} of "
        f"{window_ns / 1e6:.3f} ms, idle share {idle:.4f}; kernels (ms/step): "
        + ", ".join(f"{k} {v / 1e6 / TRACE_STEPS:.4f}" for k, v in top))
    print(json.dumps({
        "metric": "kriging_masked_fill_points_per_sec_kerguelen_r0.10",
        "value": round(pts_per_s, 1),
        "unit": "points/sec",
        "vs_baseline": round(pts_per_s / BASELINE_PTS_PER_S, 2),
        "ms_per_step": round(ms, 4),
        "backend": backend,
        "rmse_m": round(rmse, 4),
        "idle_share": round(idle, 4),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
