"""Quickstart demo (rebuild of main.cpp / edge_app).

- cpuExample (main.cpp:212-262): a 10x8 toy grid, a few named points, one
  single-point call, printed side by side golden vs device.
- runBenchmark (main.cpp:127-207): 1000x800 sinusoid grid, bilinear batches
  {1e3,1e4,1e5,1e6}, golden-vs-device agreement check and speedup print.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import Extent
from ..golden import GoldenGrid
from ..grid import RegularGrid
from ..synthetic import sinusoid
from ..utils import steady_state_ms


def toy_example():
    import jax.numpy as jnp

    from ..ops import scattered_bilinear

    elev = np.arange(80, dtype=float).reshape(8, 10) * 3.0 - 1000.0
    ext = Extent(min_lon=-180.0, max_lon=-171.0, min_lat=20.0, max_lat=27.0)
    grid = RegularGrid.from_nan_array(elev, ext)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    lons = np.array([-175.5, -172.25, -179.9])
    lats = np.array([23.5, 21.75, 26.2])
    dev = np.asarray(scattered_bilinear(grid, lons, lats))
    gold = golden.bilinear(lons, lats)
    print("toy 10x8 grid, bilinear:")
    for lo, la, t, g in zip(lons, lats, dev, gold):
        print(f"  ({lo:8.3f},{la:6.3f}) device={t:10.3f}  golden={g:10.3f}")


def benchmark(batches=(1_000, 10_000, 100_000, 1_000_000), grid_shape=(800, 1000)):
    import jax
    import jax.numpy as jnp

    from ..ops import scattered_bilinear

    elev = sinusoid(*grid_shape)
    ext = Extent(min_lon=-180.0, max_lon=-160.0, min_lat=20.0, max_lat=30.0)
    grid = RegularGrid.dense(elev, ext)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    key = jax.random.PRNGKey(0)
    print(f"\n{grid_shape[1]}x{grid_shape[0]} sinusoid, bilinear, "
          f"golden(numpy f64, 1 host core) vs {jax.devices()[0].device_kind}:")
    any_failed = False
    for n in batches:
        key, k1, k2 = jax.random.split(key, 3)
        lons = jax.random.uniform(k1, (n,), jnp.float32, ext.min_lon + 1e-6, ext.max_lon - 1e-6)
        lats = jax.random.uniform(k2, (n,), jnp.float32, ext.min_lat + 1e-6, ext.max_lat - 1e-6)
        import time

        lons_h = np.asarray(lons, np.float64)
        lats_h = np.asarray(lats, np.float64)
        t0 = time.perf_counter()
        want = golden.bilinear(lons_h, lats_h)
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = steady_state_ms(scattered_bilinear, grid, lons, lats, iters=5)
        got = np.asarray(scattered_bilinear(grid, lons, lats))
        ok = np.allclose(got[:10], want[:10], atol=0.05)
        any_failed = any_failed or not ok
        print(
            f"  n={n:>9}: host {host_ms:9.1f} ms   device {dev_ms:8.2f} ms   "
            f"speedup {host_ms/dev_ms:7.1f}x   validation {'PASSED' if ok else 'FAILED'}"
        )
    return not any_failed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--skip-benchmark", action="store_true")
    p.add_argument("--batches", type=int, nargs="+", default=None,
                   help="benchmark batch sizes (default: 1e3 1e4 1e5 1e6)")
    p.add_argument("--grid-shape", type=int, nargs=2, default=None,
                   metavar=("NLAT", "NLON"), help="benchmark grid shape")
    args = p.parse_args(argv)
    toy_example()
    if not args.skip_benchmark:
        kw = {}
        if args.batches:
            kw["batches"] = tuple(args.batches)
        if args.grid_shape:
            kw["grid_shape"] = tuple(args.grid_shape)
        if not benchmark(**kw):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
