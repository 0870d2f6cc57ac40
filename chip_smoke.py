"""GPU smoke and parity check: the main paths at full size, each device op
against its plain reference.

The CPU test suite (tests/, JAX_PLATFORMS=cpu) proves semantics; this script
proves the GPU agrees, with every kernel compiled for the card (none in
interpret mode).  A silent precision downgrade (TF32 matmuls on the GPU) or a
selection scramble shows up here and nowhere on the CPU.

    python chip_smoke.py            # one GPU: phases (a)-(f)
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (one card):
  (a) Grid B dense kriging fill, Kerguelen-shaped stand-in (2053x2441, 10%
      mask), backend from ops.backend.resolve, vs the XLA path and vs the
      float64 v2 oracle; ms/step of the kernel and the XLA path, interleaved;
  (b) Grid A: 5M random queries through TwoTierInterpolator (kriging, IDW)
      on the 3200x4000 grid vs the v2 oracle;
  (c) mission serving: 512-ping ticks through BandRouter with concurrent
      ingest and a refresh, vs the two-tier path on the same queries;
  (d) streaming: ingest -> window_fill cycles vs a plain fill of the same
      mosaic window;
  (e) exact mode: f64 exact kriging vs the golden engine to 1e-8 * span;
  (f) precision surfaces: packed ops, GPU == CPU backend at f32, band
      resample, knn_search.
--multi runs sharded_fit_fill (4-way rows), sharded_fill2d (2x2),
ShardedStreamingInterpolator and build_atlas_sharded against their
single-device twins: fills bit-equal given the same variogram, fitted
variogram curves within 1e-3.

Prints one line per check and, last, one JSON line; exits non-zero if any
check failed, and without a GPU exits non-zero before any check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    dense: tuple = (2053, 2441)  # Kerguelen-shaped Grid B workload
    grid_a: tuple = (3200, 4000)  # config.GRID_A_SHAPE
    n_queries: int = 5_000_000
    n_oracle: int = 20_000  # oracle subsample
    ticks: int = 8
    stream_window: tuple = (512, 512)
    stream_cycles: int = 4
    exact: tuple = (256, 320, 3000)  # grid rows, cols, query cells
    steps: int = 20  # timed steps per measurement


FULL = Sizes()
# CPU rehearsal of every phase (tests/test_chip_smoke.py)
TINY = Sizes(dense=(96, 112), grid_a=(64, 80), n_queries=4096, n_oracle=400,
             ticks=3, stream_window=(48, 64), stream_cycles=2,
             exact=(48, 64, 200), steps=2)


class Checks:
    """PASS/FAIL lines; a run passes only if every check passed."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def close(got, want, atol, frac=1.0, hard_max=None):
    """NaN patterns equal, |got - want| <= atol at >= frac of the points and
    < hard_max (default atol) at every point.  frac < 1 admits f32 near-tie
    neighbour flips against an f64 oracle; hard_max still bounds every point,
    so a precision scramble (errors of metres at many points) cannot hide in
    the tolerated tail."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nan_ok = bool((np.isnan(got) == np.isnan(want)).all())
    m = ~np.isnan(want) & ~np.isnan(got)
    err = np.abs(got[m] - want[m])
    mx = float(err.max()) if m.any() else 0.0
    within = float((err <= atol).mean()) if m.any() else 1.0
    ok = nan_ok and within >= frac and mx <= (hard_max if hard_max else atol)
    return ok, f"maxabs={mx:.3e} within_tol={within:.5f} nan_pattern_equal={nan_ok}"


def dense_workload(sz: Sizes):
    """bench.py's workload (Kerguelen-shaped stand-in, 10% mask) at sz.dense."""
    from auvtpu.config import KERGUELEN_EXTENT
    from auvtpu.grid import RegularGrid
    from bench import load_workload

    reduced, rc, truth = load_workload(sz.dense)
    return RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT), reduced, rc, truth


def _oracle_v2(reduced, grid, cell_aligned=False):
    """GoldenV2 over ``reduced``.  cell_aligned=True snaps each query back
    onto its cell: the dense fill sees a masked cell at its exact integer
    coordinates, while the f64 round trip index -> lon -> x can land a few
    ulps off and break the many exact distance ties differently."""
    from auvtpu.golden.v2 import GoldenV2

    class CellAligned(GoldenV2):
        def _normalize(self, lons, lats):
            x, y, oob = super()._normalize(lons, lats)
            return np.round(x), np.round(y), oob

    cls = CellAligned if cell_aligned else GoldenV2
    return cls(reduced, grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat)


# ---------------------------------------------------------------------------
# (a) Grid B dense fill
# ---------------------------------------------------------------------------

def phase_dense(check, sz: Sizes, backend: str, wl):
    import jax
    import jax.numpy as jnp

    from auvtpu.ops import fill_kriging
    from auvtpu.ops.dense import window_topk_planes
    from auvtpu.utils.timing import steady_state_ms
    from bench import dense_truth, make_step

    grid, reduced, rc, truth = wl
    print(f"(a) dense kriging fill {grid.shape}, {len(truth)} masked cells, backend {backend}",
          flush=True)
    got = np.asarray(fill_kriging(grid, backend=backend))
    want = np.asarray(fill_kriging(grid, backend="xla"))
    cnt_x = np.asarray(jax.jit(lambda g: window_topk_planes(g)[0])(grid))
    if backend == "fused":
        from auvtpu.pallas import fused_fill_kriging

        _, cnt = fused_fill_kriging(grid, with_count=True)
    else:
        cnt = cnt_x
    check("(a) selected-neighbour counts == xla", bool(np.array_equal(np.asarray(cnt), cnt_x)))
    # both sides are f32 and select the same neighbours; they differ only
    # in how each compiler contracts the solve's multiply-adds
    check("(a) fill == xla fill (1e-3 m at 99.9%, 0.05 m max)",
          *close(got, want, 1e-3, frac=0.999, hard_max=0.05))

    rng = np.random.default_rng(0)
    sub = rc[rng.choice(len(rc), min(sz.n_oracle, len(rc)), replace=False)]
    lon, lat = grid.index_to_lonlat(sub[:, 0], sub[:, 1])
    oracle = _oracle_v2(reduced, grid, cell_aligned=True).kriging(lon, lat)
    # f32 vs f64: near-tie neighbour flips move a cell by up to tens of
    # metres, so 1% may exceed 0.15 m; 100 m bounds every cell
    check(f"(a) fill vs GoldenV2 f64 ({len(sub)} masked cells; 0.15 m at 99%, 100 m max)",
          *close(got[sub[:, 0], sub[:, 1]], oracle, 0.15, frac=0.99, hard_max=100.0))
    rmse = float(np.sqrt(np.mean((got[rc[:, 0], rc[:, 1]] - truth) ** 2)))
    rmse_x = float(np.sqrt(np.mean((want[rc[:, 0], rc[:, 1]] - truth) ** 2)))
    check("(a) RMSE vs held-out truth", np.isfinite(rmse) and abs(rmse - rmse_x) < 1e-3,
          f"{rmse:.6f} m (xla {rmse_x:.6f} m)")

    truth_d, mask_d = dense_truth(reduced, rc, truth)
    steps = {b: make_step(lambda g, b=b: fill_kriging(g, backend=b), len(truth))
             for b in dict.fromkeys([backend, "xla"])}
    mem = steps[backend].lower(grid, truth_d, mask_d).compile().memory_analysis()
    print(f"(a) memory_analysis of the {backend} fill step: {mem}", flush=True)
    times = {b: [] for b in steps}
    for b in ["xla", backend, backend, "xla"]:
        times[b].append(steady_state_ms(steps[b], grid, truth_d, mask_d, iters=sz.steps))
    for b, ts in times.items():
        print(f"(a) bench step, backend {b}: " + " / ".join(f"{t:.4f}" for t in ts)
              + f" ms (median of {sz.steps} steps per turn, turns interleaved)", flush=True)


# ---------------------------------------------------------------------------
# (b) Grid A scattered queries
# ---------------------------------------------------------------------------

def phase_grid_a(check, sz: Sizes):
    import jax
    import jax.numpy as jnp

    from auvtpu.config import GRID_A_EXTENT as ext
    from auvtpu.golden.v2 import GoldenV2
    from auvtpu.grid import RegularGrid
    from auvtpu.ops.two_tier import TwoTierInterpolator
    from auvtpu.utils.timing import steady_state_ms
    from auvtpu.synthetic import shelf_seamount

    elev = shelf_seamount(*sz.grid_a)
    grid = RegularGrid.dense(elev, ext)
    tt = TwoTierInterpolator(grid)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    n = sz.n_queries
    lons = jax.random.uniform(k1, (n,), jnp.float32, ext.min_lon + 1e-6, ext.max_lon - 1e-6)
    lats = jax.random.uniform(k2, (n,), jnp.float32, ext.min_lat + 1e-6, ext.max_lat - 1e-6)
    print(f"(b) Grid A {grid.shape}, {n} random queries", flush=True)
    oracle = GoldenV2(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    idx = np.random.default_rng(1).choice(n, sz.n_oracle, replace=False)
    lo_h = np.asarray(lons, np.float64)[idx]
    la_h = np.asarray(lats, np.float64)[idx]
    scale = max(1.0, float(np.abs(elev).max()))
    for name, fn, ref in [
        ("kriging", tt.kriging, oracle.kriging),
        ("idw", tt.idw, lambda lo, la: oracle.idw(lo, la, k=8)),
    ]:
        out = np.asarray(fn(lons, lats))
        ms = steady_state_ms(fn, lons, lats, iters=max(3, sz.steps // 4))
        print(f"(b) two-tier {name}: {ms:.3f} ms for {n} queries", flush=True)
        # f32 vs f64 on a smooth field: 5e-5 relative, a near-tie flip moves
        # a query by far less than 1 m
        check(f"(b) two-tier {name} vs GoldenV2 f64 ({len(idx)} queries)",
              *close(out[idx], ref(lo_h, la_h), 5e-5 * scale, frac=0.999, hard_max=1.0))


# ---------------------------------------------------------------------------
# (c) mission serving
# ---------------------------------------------------------------------------

TICK = 512


def _trajectory(shape, n, seed=0):
    """Survey sweep with a sinusoidal cross-track weave (mission_replay)."""
    H, W = shape
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = H * 0.45 + min(55.0, 0.2 * H) * np.sin(np.arange(n) * (2.0 * np.pi / 12_500.0))
    y = np.clip(y + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    return x, y


def phase_mission(check, sz: Sizes, wl):
    import jax.numpy as jnp

    from auvtpu.ops.band import BandRouter
    from auvtpu.streaming import StreamingInterpolator

    grid, reduced, rc, truth = wl
    H, W = reduced.shape
    ext = grid.extent
    seabed = reduced.copy()  # what the sonar measures: the unmasked stand-in
    seabed[rc[:, 0], rc[:, 1]] = truth
    si = StreamingInterpolator((H, W), ext, swath_cap=65536, stage_slots=4, method="kriging")
    rs, cs = np.nonzero(~np.isnan(reduced))
    si.ingest(rs, cs, reduced[rs, cs])
    x, y = _trajectory((H, W), 8 * sz.ticks * TICK)
    lon = (ext.min_lon + x * grid.lon_step).astype(np.float32)
    lat = (ext.min_lat + y * grid.lat_step).astype(np.float32)
    router = BandRouter(si.grid())
    router.prepare(lon, lat)
    span = float(np.nanmax(reduced) - np.nanmin(reduced))
    rng = np.random.default_rng(2)
    print(f"(c) mission: {sz.ticks} ticks of {TICK} pings, band {router._band.shape}", flush=True)
    tick_ms, routes, maes = [], [], []
    for tick in range(sz.ticks):
        s, e = tick * TICK, (tick + 1) * TICK
        lo, la = jnp.asarray(lon[s:e]), jnp.asarray(lat[s:e])
        vy = int(np.clip(y[s], 2, H - 3))
        orow = rng.integers(max(vy - 24, 0), min(vy + 24, H), 8192)
        ocol = rng.integers(max(int(x[s]) - 64, 0), min(int(x[e - 1]) + 64, W), 8192)
        si.ingest(orow, ocol, seabed[orow, ocol])
        si.flush()
        if tick == sz.ticks // 2:
            router.refresh(grid=si.grid())
        t0 = time.perf_counter()
        route = router.route(lo, la, band_ready=True)
        z = np.asarray(router.kriging(lo, la, force=route))
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        routes.append(route)
        exact = np.asarray(router.two_tier.kriging(lo, la))
        # resolved queries serve the band resample, the rest escalate to the
        # two-tier path, which ran there on a padded subset: another
        # compiled shape, so f32 rounding of depths of ~4 km (ulp ~2.4e-4 m)
        # may differ by a few ulps
        zr, ok = (np.asarray(a) for a in router._resampler.resample(lo, la))
        if route == "packed":
            ok = np.zeros_like(ok)
        d_band = float(np.abs(z[ok] - zr[ok]).max()) if ok.any() else 0.0
        d_esc = float(np.abs(z[~ok] - exact[~ok]).max()) if (~ok).any() else 0.0
        good = np.isfinite(z).all() and d_band == 0.0 and d_esc <= 5e-3
        # the band serves the bilinear resample of the cell-aligned fill,
        # not per-query kriging (docs/SEMANTICS.md): bound the divergence
        maes.append(float(np.nanmean(np.abs(z - exact))))
        if not (good and maes[-1] < 0.05 * span):
            check(f"(c) tick {tick} ({route}) vs two-tier", False,
                  f"band-served diff {d_band:.2e} m, escalated ({int((~ok).sum())}) diff "
                  f"{d_esc:.2e} m, mae {maes[-1]:.3f} m")
            return
    check(f"(c) {sz.ticks} ticks: band-served == resample + two-tier escalation, "
          "mean |band - two-tier| < 5% of span", True,
          f"max tick mae={max(maes):.3f} m span={span:.0f} m routes={routes}")
    print(f"(c) tick ms (routing + serve + readback): "
          + " ".join(f"{t:.2f}" for t in tick_ms), flush=True)


# ---------------------------------------------------------------------------
# (d) streaming
# ---------------------------------------------------------------------------

def phase_streaming(check, sz: Sizes, backend: str, wl):
    import jax.numpy as jnp

    from auvtpu.grid import RegularGrid
    from auvtpu.ops import fill_kriging
    from auvtpu.streaming import StreamingInterpolator

    grid, reduced, _, _ = wl
    H, W = reduced.shape
    si = StreamingInterpolator((H, W), grid.extent, swath_cap=65536, stage_slots=4,
                               method="kriging", window=sz.stream_window)
    check("(d) streaming backend == resolver's", si.backend == backend, si.backend)
    rs, cs = np.nonzero(~np.isnan(reduced))
    keep = np.random.default_rng(3).random(len(rs)) < 0.5  # half the chart up front
    si.ingest(rs[keep], cs[keep], reduced[rs[keep], cs[keep]])
    rest = np.flatnonzero(~keep)
    chunks = np.array_split(rest, sz.stream_cycles)
    wh, ww = sz.stream_window
    worst = []
    for i, ch in enumerate(chunks):
        si.ingest(rs[ch], cs[ch], reduced[rs[ch], cs[ch]])
        cr = int((i + 1) * H / (sz.stream_cycles + 1))
        cc = int((i + 1) * W / (sz.stream_cycles + 1))
        got, (r0, c0) = si.window_fill(cr, cc)
        g = si.grid()
        we = g.elev[r0:r0 + wh, c0:c0 + ww]
        wv = g.valid[r0:r0 + wh, c0:c0 + ww]
        sub = RegularGrid(elev=we, valid=wv, min_lon=g.min_lon, max_lon=g.max_lon,
                          min_lat=g.min_lat, max_lat=g.max_lat)
        plain = fill_kriging(sub, row0=r0, col0=c0, steps=si._steps, backend="xla")
        want = np.asarray(jnp.where(wv > 0.5, we, plain))
        ok, detail = close(got, want, 1e-3, frac=0.999, hard_max=0.05)
        worst.append(detail)
        if not ok:
            check(f"(d) cycle {i} window_fill vs plain xla fill", False, detail)
            return
    check(f"(d) {sz.stream_cycles} ingest -> window_fill cycles == plain xla fill "
          "(1e-3 m at 99.9%, 0.05 m max)", True, worst[-1])


# ---------------------------------------------------------------------------
# (e) exact mode
# ---------------------------------------------------------------------------

def phase_exact(check, sz: Sizes):
    import jax

    from auvtpu.config import Extent
    from auvtpu.golden import GoldenGrid
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.ops.exact import exact_kriging_at_cells, exact_kriging_scattered
    from auvtpu.synthetic import shelf_seamount

    H, W, n = sz.exact
    ext = Extent(-74.0, -70.0, 35.0, 38.0)
    reduced, rc, _ = mask_grid(shelf_seamount(H, W), 0.15, seed=11)
    gref = GoldenGrid(reduced, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    span = float(np.nanmax(reduced) - np.nanmin(reduced))
    rng = np.random.default_rng(0)
    lons = rng.uniform(ext.min_lon, ext.max_lon, n)
    lats = rng.uniform(ext.min_lat, ext.max_lat, n)
    jax.config.update("jax_enable_x64", True)
    try:
        g64 = RegularGrid.from_nan_array(reduced, ext, dtype=np.float64)
        got = exact_kriging_at_cells(g64, rc[:n, 0], rc[:n, 1])
        qlon = ext.min_lon + rc[:n, 1] * gref.lon_step
        qlat = ext.min_lat + rc[:n, 0] * gref.lat_step
        check("(e) exact_kriging_at_cells vs golden engine (1e-8 * span)",
              *close(got, gref.kriging(qlon, qlat), 1e-8 * span))
        got = exact_kriging_scattered(g64, lons, lats)
        check("(e) exact_kriging_scattered vs golden engine (1e-8 * span)",
              *close(got, gref.kriging(lons, lats), 1e-8 * span))
    finally:
        jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# (f) precision surfaces
# ---------------------------------------------------------------------------

def phase_precision(check, sz: Sizes):
    import jax
    import jax.numpy as jnp

    from auvtpu.config import Extent
    from auvtpu.golden import GoldenGrid
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.ops.band import BandResampler, fill_band
    from auvtpu.ops.packs import StencilPack, packed_bilinear, packed_idw, packed_kriging
    from auvtpu.scattered import knn_search
    from auvtpu.synthetic import shelf_seamount

    H, W, _ = sz.exact
    ext = Extent(-74.0, -70.0, 35.0, 38.0)
    reduced, _, _ = mask_grid(shelf_seamount(H, W), 0.15, seed=11)
    grid = RegularGrid.from_nan_array(reduced, ext)
    gv2 = _oracle_v2(reduced, grid)
    gref = GoldenGrid(reduced, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    rng = np.random.default_rng(0)
    n = 2000
    lons = rng.uniform(ext.min_lon, ext.max_lon, n)
    lats = rng.uniform(ext.min_lat, ext.max_lat, n)
    lo32, la32 = jnp.asarray(lons, jnp.float32), jnp.asarray(lats, jnp.float32)
    tol = 5e-5 * max(1.0, float(np.nanmax(np.abs(reduced))))

    sp = StencilPack(grid, window_radius=2)
    check("(f) packed_bilinear vs golden",
          *close(packed_bilinear(sp.bilinear, grid, lo32, la32), gref.bilinear(lons, lats), tol))
    got_kr = np.asarray(packed_kriging(sp.window, grid, lo32, la32))
    got_id = np.asarray(packed_idw(sp.window, grid, lo32, la32))
    check("(f) packed_kriging vs GoldenV2",
          *close(got_kr, gv2.kriging(lons, lats), 0.15, frac=0.99, hard_max=100.0))
    check("(f) packed_idw vs GoldenV2",
          *close(got_id, gv2.idw(lons, lats, k=8), 0.15, frac=0.99, hard_max=100.0))

    # same f32 program on the CPU backend: any silent precision downgrade
    # or selection scramble on the GPU shows here, though the oracle
    # comparisons above tolerate a near-tie tail
    with jax.default_device(jax.devices("cpu")[0]):
        grid_c = RegularGrid.from_nan_array(reduced, ext)
        sp_c = StencilPack(grid_c, window_radius=2)
        lo_c, la_c = jnp.asarray(lons, jnp.float32), jnp.asarray(lats, jnp.float32)
        cpu_kr = np.asarray(packed_kriging(sp_c.window, grid_c, lo_c, la_c))
        cpu_id = np.asarray(packed_idw(sp_c.window, grid_c, lo_c, la_c))
    check("(f) packed_kriging device == cpu (f32)",
          *close(got_kr, cpu_kr, 2e-3, frac=0.999, hard_max=1.0))
    check("(f) packed_idw device == cpu (f32)",
          *close(got_id, cpu_id, 2e-3, frac=0.999, hard_max=1.0))

    # trajectory-band resample: its row-weight matmul must run at HIGHEST
    # (a TF32 product rounds the band's depths by metres)
    r0 = H // 4
    band = fill_band(grid, r0, H // 4, 0, W, method="kriging")
    rs = BandResampler(grid, band, chunk=256, win_rows=32, win_cols=128)
    t = np.linspace(0.0, 1.0, 4000)
    bx = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, 4000), 0.5, W - 1.5)
    by = np.clip(r0 + H / 8 * (0.5 + 0.4 * np.sin(t * 30 * np.pi)) + rng.normal(0, 0.05, 4000),
                 0.5, H - 1.5)
    bz, bok = rs.resample(ext.min_lon + bx * gref.lon_step, ext.min_lat + by * gref.lat_step)
    bz, bok = np.asarray(bz), np.asarray(bok)
    p64 = np.asarray(band.plane, np.float64)
    x, y = bx - band.col0, by - band.row0
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    wx, wy = x - x0, y - y0
    want_b = ((1 - wy) * ((1 - wx) * p64[y0, x0] + wx * p64[y0, x0 + 1])
              + wy * ((1 - wx) * p64[y0 + 1, x0] + wx * p64[y0 + 1, x0 + 1]))
    e = np.abs(bz[bok] - want_b[bok])
    check("(f) band_resample f32 (HIGHEST)", bok.mean() > 0.9 and e.max() < 5e-3,
          f"resolved={bok.mean():.3f} maxabs={e.max():.2e}")

    # scattered prototype kNN: the A.B matmul must run at HIGHEST
    pts = rng.uniform(0, 1, (4000, 2)).astype(np.float32) + np.array([-73.0, 35.0], np.float32)
    tgt = pts[:500] + 0.001
    d2, _ = knn_search(jnp.asarray(tgt), jnp.asarray(pts), k=8)
    full = ((tgt.astype(np.float64)[:, None] - pts.astype(np.float64)[None]) ** 2).sum(-1)
    err = float(np.abs(np.sort(np.asarray(d2), axis=1) - np.sort(full, axis=1)[:, :8]).max())
    check("(f) knn_search f32 (HIGHEST)", err < 1e-5, f"maxabs={err:.2e}")


# ---------------------------------------------------------------------------
# --multi: the sharded paths against their single-device twins
# ---------------------------------------------------------------------------

N_MULTI = 4  # GPUs of the --multi run


def phase_multi(check, sz: Sizes, backend: str, wl):
    import jax
    import jax.numpy as jnp

    from auvtpu.ops import fill_kriging
    from auvtpu.ops.band import build_atlas, plan_segments
    from auvtpu.parallel import (
        ShardedStreamingInterpolator, build_atlas_sharded, make_mesh, make_mesh2d,
        sharded_fill2d, sharded_fit_fill,
    )
    from auvtpu.streaming import StreamingInterpolator
    from auvtpu.utils.timing import steady_state_ms
    from auvtpu.variogram import empirical_variogram, fit_exponential, variogram_model

    n_dev = N_MULTI
    grid, reduced, _, _ = wl
    H, W = reduced.shape
    eq = lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True))
    print(f"multi: {n_dev} devices, grid {grid.shape}, backend {backend}", flush=True)

    mesh = make_mesh(n_dev)
    plane, vp = sharded_fit_fill(mesh, grid)
    lags, gamma, counts = empirical_variogram(grid)
    h = lags * (0.5 * (abs(grid.lat_step) + abs(grid.lon_step)))
    vp1 = fit_exponential(h, gamma, counts)
    # the psum adds the per-band pair sums in another order.  Compare the
    # fitted curves at the bin lags: on this stand-in the exponential fit
    # runs into its linear regime, where only sill / range is identified
    # and rounding moves the parameters themselves by tens of percent
    g_s = np.asarray(variogram_model(h, tuple(vp)))
    g_1 = np.asarray(variogram_model(h, tuple(vp1)))
    rel = float(np.max(np.abs(g_s - g_1) / np.abs(g_1)))
    check("multi sharded_fit_fill fitted variogram curve == single device (1e-3 relative)",
          rel <= 1e-3, f"max rel diff {rel:.2e}; params sharded {np.asarray(vp)} "
          f"single {np.asarray(vp1)}")
    vp_dev = tuple(jnp.asarray(v) for v in np.asarray(vp))
    single = fill_kriging(grid, vparams=vp_dev, backend=backend)
    check("multi sharded_fit_fill (4 row bands) == single-device fill, bit-equal", eq(plane, single))
    ms_s = steady_state_ms(lambda: sharded_fit_fill(mesh, grid)[0], iters=sz.steps)
    ms_1 = steady_state_ms(lambda: fill_kriging(grid, vparams=vp_dev, backend=backend),
                           iters=sz.steps)
    print(f"multi sharded_fit_fill {ms_s:.3f} ms; single-device fill {ms_1:.3f} ms", flush=True)

    got = sharded_fill2d(make_mesh2d((2, 2)), grid, "kriging")
    check("multi sharded_fill2d (2x2) == single-device fill, bit-equal",
          eq(got, fill_kriging(grid, backend=backend)))

    win = sz.stream_window
    one = StreamingInterpolator((H, W), grid.extent, method="kriging", window=win)
    many = ShardedStreamingInterpolator((H, W), grid.extent, make_mesh(n_dev),
                                        method="kriging", window=win)
    rs, cs = np.nonzero(~np.isnan(reduced))
    ok = True
    for part in np.array_split(np.arange(len(rs)), 3):
        for si in (one, many):
            si.ingest(rs[part], cs[part], reduced[rs[part], cs[part]])
        a, pa = one.window_fill(H // 2, W // 3)
        b, pb = many.window_fill(H // 2, W // 3)
        ok &= pa == pb and eq(a, b)
    check("multi ShardedStreamingInterpolator window_fill == single device, bit-equal", ok)

    n = 8192
    t = np.linspace(0, 1, n)
    x = np.clip(1.0 + t * (W - 3), 0.5, W - 1.5)
    y = np.clip(1.0 + t * (H - 3) + 2 * np.sin(t * 20 * np.pi), 0.5, H - 1.5)
    segs = plan_segments(x, y, chunk=256, max_bands=n_dev, grid_shape=grid.shape)
    ref = build_atlas(grid, segs, fill_backend=backend)
    got = build_atlas_sharded(grid, segs, make_mesh(n_dev, axis="pages"), fill_backend=backend)
    check(f"multi build_atlas_sharded ({len(segs)} pages) == build_atlas, bit-equal",
          eq(got.planes, ref.planes) and eq(got.vmasks, ref.vmasks))


def run(sz: Sizes, *, multi: bool) -> list:
    """Run the phases at ``sz``; returns the names of failed checks."""
    import jax

    from auvtpu.ops.backend import resolve

    check = Checks()
    backend = resolve(jax.devices()[0].platform, np.float32)
    wl = dense_workload(sz)
    if multi:
        phase_multi(check, sz, backend, wl)
        return check.failed
    phases = [
        ("a", lambda: phase_dense(check, sz, backend, wl)),
        ("b", lambda: phase_grid_a(check, sz)),
        ("c", lambda: phase_mission(check, sz, wl)),
        ("d", lambda: phase_streaming(check, sz, backend, wl)),
        ("e", lambda: phase_exact(check, sz)),
        ("f", lambda: phase_precision(check, sz)),
    ]
    for name, fn in phases:
        t0 = time.time()
        fn()
        print(f"phase ({name}) done in {time.time() - t0:.1f} s", flush=True)
    return check.failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="four GPUs: the sharded paths and their single-device twins only")
    args = p.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (jax.devices()[0] is {devs[0].platform!r}); "
              "nothing was checked", file=sys.stderr)
        return 2
    n_need = N_MULTI if args.multi else 1
    if len(devs) < n_need:
        print(f"chip_smoke: {n_need} GPUs needed, {len(devs)} found", file=sys.stderr)
        return 2
    from auvtpu.utils.device import gpu_name_and_power_limit

    print(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}", flush=True)
    print(gpu_name_and_power_limit(), flush=True)
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}", flush=True)
    t0 = time.time()
    failed = run(FULL, multi=args.multi)
    print(f"{len(failed)} failed checks{': ' + str(failed) if failed else ''}; "
          f"{time.time() - t0:.1f} s", flush=True)
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
