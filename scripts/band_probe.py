"""Calibrate the band router's cost model (ops/band.py COST_NS) on the GPU.

Workload: the Kerguelen-shaped stand-in (2053x2441, 10% mask) and a
5M-sample AUV survey trajectory confined to a band of rows (consecutive
pings ~0.2 cells apart), served as ordinary kriging.

Measures, each time the median of calls ended by jax.block_until_ready:
  1. packed two-tier kriging on the trajectory batch (packed_per_query);
  2. band refresh at two band sizes, fitted as dispatch + fill_per_cell *
     cells;
  3. the band resample alone (serving mode: resample_per_query);
  4. resample parity vs a direct bilinear of the band plane, and the
     routing decisions the calibrated constants give.

Run on the GPU, from the repository root:

    python scripts/band_probe.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 5_000_000


def main():
    import auvtpu  # noqa: F401  (enables the persistent compile cache)
    import jax
    import jax.numpy as jnp

    from auvtpu.config import KERGUELEN_EXTENT as EXT
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.ops.band import BandRouter
    from auvtpu.ops.two_tier import TwoTierInterpolator
    from auvtpu.synthetic import kerguelen_standin
    from auvtpu.utils.device import gpu_name_and_power_limit, require_gpu
    from auvtpu.utils.timing import steady_state_ms

    dev = require_gpu()[0]
    print(f"device: {dev.platform} {dev.device_kind}; {gpu_name_and_power_limit()}", flush=True)

    reduced, _, _ = mask_grid(kerguelen_standin(), 0.10)
    H, W = reduced.shape
    grid = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), EXT)

    # survey trajectory: monotone lon sweep + sinusoidal cross-track weave
    # inside a ~120-row band; ~0.2-cell ping spacing
    t = np.linspace(0.0, 1.0, N)
    rng = np.random.default_rng(0)
    x = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, N), 0.5, W - 1.5)
    y = np.clip(H * 0.45 + 55.0 * np.sin(t * 800 * np.pi) + rng.normal(0, 0.05, N), 0.5, H - 1.5)
    lon = (EXT.min_lon + x * (EXT.max_lon - EXT.min_lon) / (W - 1)).astype(np.float32)
    lat = (EXT.min_lat + y * (EXT.max_lat - EXT.min_lat) / (H - 1)).astype(np.float32)
    lon_d, lat_d = jnp.asarray(lon), jnp.asarray(lat)

    tt = TwoTierInterpolator(grid)
    ms_packed = steady_state_ms(lambda: tt.kriging(lon_d, lat_d), iters=8)
    print(f"packed two-tier kriging (trajectory): {ms_packed:.3f} ms", flush=True)

    router = BandRouter(grid)
    band = router.prepare(lon_d, lat_d)
    ms_big = steady_state_ms(lambda: router.refresh().plane, iters=8)
    small = BandRouter(grid)
    sband = small.prepare(lon_d[:20_000], lat_d[:20_000])
    ms_small = steady_state_ms(lambda: small.refresh().plane, iters=8)
    c_big, c_small = band.cells, sband.cells
    per_cell = (ms_big - ms_small) / (c_big - c_small) * 1e6
    dispatch = ms_small * 1e6 - per_cell * c_small
    print(f"band refresh: {c_big} cells {ms_big:.3f} ms; {c_small} cells {ms_small:.3f} ms",
          flush=True)

    rs = router._resampler
    ms_res = steady_state_ms(lambda: rs.resample(lon_d, lat_d)[0], iters=8)
    print(f"band resample (window {rs.wr}x{rs.wc}): {ms_res:.3f} ms", flush=True)

    z, ok = rs.resample(lon_d, lat_d)
    okh, zh = np.asarray(ok), np.asarray(z)
    sub = slice(0, 200_000)
    xb, yb = x[sub] - band.col0, y[sub] - band.row0
    p = np.asarray(band.plane, np.float64)
    x0, y0 = np.floor(xb).astype(int), np.floor(yb).astype(int)
    wx, wy = xb - x0, yb - y0
    want = ((1 - wy) * ((1 - wx) * p[y0, x0] + wx * p[y0, x0 + 1])
            + wy * ((1 - wx) * p[y0 + 1, x0] + wx * p[y0 + 1, x0 + 1]))
    m = okh[sub]
    print(f"resolved {okh.mean():.4f}; resample parity vs direct bilinear (200k): "
          f"maxabs {np.abs(zh[sub][m] - want[m]).max():.3e}", flush=True)

    cost = {
        "packed_per_query": round(ms_packed * 1e6 / N, 3),
        "dispatch": round(max(dispatch, 0.0), 0),
        "fill_per_cell": round(max(per_cell, 0.0), 4),
        "resample_per_query": round(ms_res * 1e6 / N, 3),
    }
    print(f"COST_NS {cost}", flush=True)
    router.cost_ns = dict(cost)
    print(f"route(trajectory, one-shot) = {router.route(lon_d, lat_d)}; "
          f"band_ready = {router.route(lon_d, lat_d, band_ready=True)}; "
          f"512-ping tick = {router.route(lon_d[:512], lat_d[:512], band_ready=True)}",
          flush=True)


if __name__ == "__main__":
    main()
