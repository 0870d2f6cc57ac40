"""Mission-replay latency on the GPU: the real-time loop's tick distribution.

Replays a synthetic AUV survey through the real-time loop (streaming mosaic
-> BandRouter.refresh -> band serving: streaming.py, ops/band.py,
cli/mission.py) on the bench workload (Kerguelen stand-in 2053x2441, 10%
masked prior chart):

per 512-ping tick:
  (a) ingest a simulated multibeam swath (B new observations around the
      vehicle) into the StreamingInterpolator and flush (one async device
      scatter — its queue contention with serving is part of what we
      measure);
  (b) every REFRESH_EVERY ticks, hand the mosaic to the router
      (router.refresh(grid=si.grid()) — one async band re-fill);
  (c) serve the tick's 512 navigation queries through the router
      (routing + band resample + escalation of unresolved queries), timed
      to a scalar readback.

Reported per ingest rate B: serve-latency p50/p90/p99/max, the
post-refresh ticks separately (refresh-induced stall), and the tick
budget each rate sustains.  Analog of the reference's end-to-end timing
discipline (test_gebco.cpp:166-196) upgraded to a latency distribution.
Run on the GPU, from the repository root:

    python scripts/mission_replay.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TICK = 512  # nav pings per tick (the SLO unit; decoupled from router chunk)
N_TICKS = 256
REFRESH_EVERY = 32
WARMUP_TICKS = 4
INGEST_RATES = [0, 2_048, 8_192, 32_768, 131_072]  # obs per tick
SWATH_HALF_ROWS = 24


def pct(a, q):
    return float(np.percentile(np.asarray(a), q))


def main():
    import auvtpu  # noqa: F401  (enables the persistent compile cache)
    import jax
    import jax.numpy as jnp

    from auvtpu.config import KERGUELEN_EXTENT as EXT
    from auvtpu.ops.band import BandRouter
    from auvtpu.streaming import StreamingInterpolator
    from auvtpu.utils.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()[0]
    print(f"device: {dev.platform} {dev.device_kind}; {gpu_name_and_power_limit()}", flush=True)

    # ---- prior chart: the bench workload ----
    from bench import load_workload

    reduced, _, _ = load_workload()
    H, W = reduced.shape
    print(f"prior chart: {H}x{W}, {np.isnan(reduced).sum()} unobserved cells",
          flush=True)

    # ---- streaming mosaic seeded with the prior chart ----
    si = StreamingInterpolator((H, W), EXT, swath_cap=65536, stage_slots=16,
                               method="kriging")
    rs, cs = np.nonzero(~np.isnan(reduced))
    si.ingest(rs, cs, reduced[rs, cs])
    si.flush()
    print(f"seeded mosaic with {len(rs)} prior observations", flush=True)

    # ---- mission trajectory (the 'band' survey: lon sweep + weave) ----
    n = N_TICKS * TICK
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(0)
    x = 1.0 + t * (W - 3)
    y = H * 0.45 + 55.0 * np.sin(np.arange(n) * (2.0 * np.pi / 12_500.0))
    x = np.clip(x + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(y + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    lon_step = (EXT.max_lon - EXT.min_lon) / (W - 1)
    lat_step = (EXT.max_lat - EXT.min_lat) / (H - 1)
    lon = (EXT.min_lon + x * lon_step).astype(np.float32)
    lat = (EXT.min_lat + y * lat_step).astype(np.float32)

    results = []
    for B in INGEST_RATES:
        # shipped defaults (hat_t + auto windows + chunk=2048)
        router = BandRouter(si.grid())
        router.prepare(lon, lat)
        b = router._band
        print(f"--- ingest {B} obs/tick ---  band rows {b.row0}+{b.shape[0]}"
              f" cols {b.col0}+{b.shape[1]}", flush=True)

        serve_ms, post_refresh_ms, refresh_ms = [], [], []
        checks = 0.0
        for tick in range(-WARMUP_TICKS, N_TICKS):
            i = max(tick, 0)
            s, e = i * TICK, (i + 1) * TICK
            # (a) multibeam swath around the vehicle
            if B:
                vy = int(np.clip(y[s], SWATH_HALF_ROWS, H - 1 - SWATH_HALF_ROWS))
                orow = rng.integers(vy - SWATH_HALF_ROWS, vy + SWATH_HALF_ROWS, B)
                ocol = rng.integers(max(int(x[s]) - 64, 0),
                                    min(int(x[e - 1]) + 64, W - 1), B)
                si.ingest(orow, ocol, -3000.0 + 0.1 * orow.astype(np.float64))
                si.flush()
            # (b) refresh cadence
            refreshed = False
            if tick > 0 and tick % REFRESH_EVERY == 0:
                t0 = time.perf_counter()
                router.refresh(grid=si.grid())
                refresh_ms.append((time.perf_counter() - t0) * 1e3)
                refreshed = True
            # (c) serve the tick's navigation queries
            t0 = time.perf_counter()
            z = router.kriging(lon[s:e], lat[s:e])
            checks += float(jnp.sum(z))  # scalar readback = tick completion
            dt = (time.perf_counter() - t0) * 1e3
            if tick >= 0:
                (post_refresh_ms if refreshed else serve_ms).append(dt)
        r = dict(B=B,
                 p50=pct(serve_ms, 50), p90=pct(serve_ms, 90),
                 p99=pct(serve_ms, 99), mx=float(np.max(serve_ms)),
                 pr_p50=pct(post_refresh_ms, 50) if post_refresh_ms else float("nan"),
                 pr_mx=float(np.max(post_refresh_ms)) if post_refresh_ms else float("nan"),
                 ref_p50=pct(refresh_ms, 50) if refresh_ms else float("nan"),
                 ref_mx=float(np.max(refresh_ms)) if refresh_ms else float("nan"))
        results.append(r)
        print(f"  serve ms/tick(512 pings): p50 {r['p50']:.1f} p90 {r['p90']:.1f}"
              f" p99 {r['p99']:.1f} max {r['mx']:.1f}", flush=True)
        print(f"  post-refresh serve ms: p50 {r['pr_p50']:.1f} max {r['pr_mx']:.1f};"
              f" refresh() call ms: p50 {r['ref_p50']:.1f} max {r['ref_mx']:.1f}",
              flush=True)
        print(f"  sustainable: {512.0 / r['p99'] * 1e3:,.0f} nav pings/s + "
              f"{B / r['p99'] * 1e3:,.0f} ingest obs/s at p99; checksum {checks:.3e}",
              flush=True)

    print("\nsummary (ms per 512-ping tick):")
    print("  B/tick    p50    p90    p99    max  | post-refresh p50/max | refresh p50/max")
    for r in results:
        print(f"  {r['B']:7d} {r['p50']:6.1f} {r['p90']:6.1f} {r['p99']:6.1f}"
              f" {r['mx']:6.1f}  | {r['pr_p50']:6.1f} / {r['pr_mx']:6.1f}   |"
              f" {r['ref_p50']:6.1f} / {r['ref_mx']:6.1f}")


if __name__ == "__main__":
    main()
