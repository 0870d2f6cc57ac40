"""Trajectory-band router (ops/band.py): resample parity, escalation, routing."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid
from auvtpu.masking import mask_grid
from auvtpu.ops.band import Band, BandResampler, BandRouter, fill_band
from auvtpu.synthetic import shelf_seamount

EXT = Extent(-74.0, -70.0, 35.0, 38.0)


def _trajectory(grid, n, seed=0, row_frac=0.35, row_width_frac=0.08):
    """Synthetic AUV survey track: slow sinusoidal sweep inside a row band,
    advancing monotonically in lon — consecutive samples are ~0.2 cells
    apart (dense sampling relative to the grid step, like a real survey)."""
    H, W = grid.shape
    t = np.linspace(0.0, 1.0, n)
    x = 1.0 + t * (W - 3)
    y = H * row_frac + H * row_width_frac * np.sin(t * 40 * np.pi)
    rng = np.random.default_rng(seed)
    x += rng.normal(0, 0.05, n)
    y += rng.normal(0, 0.05, n)
    x = np.clip(x, 0.5, W - 1.5)
    y = np.clip(y, 0.5, H - 1.5)
    lon = EXT.min_lon + x * grid.lon_step
    lat = EXT.min_lat + y * grid.lat_step
    return lon, lat


def _ref_bilinear(plane, x, y):
    """Direct NumPy bilinear on a dense plane (f64)."""
    p = np.asarray(plane, np.float64)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    wx = x - x0
    wy = y - y0
    z00 = p[y0, x0]
    z01 = p[y0, x0 + 1]
    z10 = p[y0 + 1, x0]
    z11 = p[y0 + 1, x0 + 1]
    return (1 - wy) * ((1 - wx) * z00 + wx * z01) + wy * ((1 - wx) * z10 + wx * z11)


def test_fill_band_matches_whole_grid_fill():
    # a margin-expanded band fill must equal the corresponding crop of the
    # whole-grid fill (same candidate windows, same global geometry)
    from auvtpu.ops import fill_kriging

    elev = shelf_seamount(96, 128)
    reduced, rc, _ = mask_grid(elev, 0.2, seed=3)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    whole = np.asarray(fill_kriging(grid))
    band = fill_band(grid, 24, 32, 0, 128)
    want = np.where(np.asarray(grid.valid)[24:56] > 0.5,
                    np.asarray(grid.elev)[24:56], whole[24:56])
    got = np.asarray(jnp.where(band.vmask > 0.5, band.plane, np.nan))
    want_m = np.where(np.isnan(want), np.nan, want)
    assert (np.isnan(got) == np.isnan(want_m)).all()
    m = ~np.isnan(want_m)
    assert np.abs(got[m] - want_m[m]).max() < 1e-4


def test_band_resample_parity_dense():
    # chunked matmul resample == direct bilinear on the band plane (f64 ref)
    elev = shelf_seamount(96, 160)
    grid = RegularGrid.dense(elev, EXT)
    band = fill_band(grid, 16, 48, 0, 160, method="idw")
    rs = BandResampler(grid, band, chunk=64, win_rows=32, win_cols=128)
    lon, lat = _trajectory(grid, 1000, row_frac=0.4, row_width_frac=0.05)
    z, ok = rs.resample(lon, lat)
    z = np.asarray(z)
    ok = np.asarray(ok)
    assert ok.mean() > 0.95  # coherent track: nearly everything resolves
    x = (lon - EXT.min_lon) / grid.lon_step - band.col0
    y = (lat - EXT.min_lat) / grid.lat_step - band.row0
    want = _ref_bilinear(band.plane, x, y)
    assert np.abs(z[ok] - want[ok]).max() < 1e-3


def test_band_resample_lerp_modes():
    # 'hat' builds bit-identical weights to 'onehot' (Sterbenz argument in
    # _lerp_hat); 'hat2' regroups the column summation (<= last-ulp drift).
    # Both must agree on the resolved mask, including a masked band.
    elev = shelf_seamount(96, 160)
    grid = RegularGrid.dense(elev, EXT)
    band = fill_band(grid, 16, 48, 0, 160, method="idw")
    lon, lat = _trajectory(grid, 1000, row_frac=0.4, row_width_frac=0.05)
    plane = np.asarray(band.plane).copy()
    vmask = np.ones_like(plane)
    vmask[20:22, 60:64] = 0.0
    plane[20:22, 60:64] = 0.0
    masked = Band(plane=jnp.asarray(plane), vmask=jnp.asarray(vmask),
                  masked=True, row0=band.row0, col0=band.col0)
    for b in (band, masked):
        outs = {}
        for mode in ("onehot", "hat", "hat2", "hat_t"):
            rs = BandResampler(grid, b, chunk=64, win_rows=32, win_cols=128,
                               lerp_mode=mode)
            z, ok = rs.resample(lon, lat)
            outs[mode] = (np.asarray(z), np.asarray(ok))
        z0, ok0 = outs["onehot"]
        assert ok0.mean() > 0.5
        for mode in ("hat", "hat2", "hat_t"):
            zm, okm = outs[mode]
            np.testing.assert_array_equal(okm, ok0)
            if mode == "hat":
                # bit-identical weights, same layout -> bit-identical output
                assert np.abs(zm[ok0] - z0[ok0]).max() == 0.0
            else:
                # hat2 regroups the column summation; hat_t's transposed row
                # contraction may pick a different FMA pairing: <= 1 f32 ulp
                np.testing.assert_allclose(zm[ok0], z0[ok0], rtol=1e-6,
                                           atol=1e-4)


def test_lerp_hat_t_narrow_window():
    # the transposed layout's whole point: wc below the 128-lane register
    # (down to the 8-sublane quantum); values match to one f32 rounding
    elev = shelf_seamount(64, 96)
    grid = RegularGrid.dense(elev, EXT)
    band = fill_band(grid, 8, 32, 0, 96, method="idw")
    lon, lat = _trajectory(grid, 256, row_frac=0.35, row_width_frac=0.03)
    ref = BandResampler(grid, band, chunk=32, win_rows=16, win_cols=96)
    alt = BandResampler(grid, band, chunk=32, win_rows=16, win_cols=8,
                        lerp_mode="hat_t")
    z0, ok0 = (np.asarray(a) for a in ref.resample(lon, lat))
    z1, ok1 = (np.asarray(a) for a in alt.resample(lon, lat))
    # the tiny window resolves a subset (chunks spanning > 8 cols drop out)
    assert ok1.mean() > 0.3
    assert (ok0 | ~ok1).all()  # everything the wide window resolves, plus ok1 subset
    both = ok0 & ok1
    np.testing.assert_allclose(z1[both], z0[both], rtol=1e-6, atol=1e-4)


def test_effective_chunk_small_batches():
    # a batch smaller than the configured chunk serves through a clamped
    # chunk (no padding to 2048) with values matching the full-chunk config
    from auvtpu.ops.band import _effective_chunk

    assert _effective_chunk(5_000_000, 2048) == 2048
    assert _effective_chunk(2048, 2048) == 2048
    assert _effective_chunk(512, 2048) == 512
    assert _effective_chunk(513, 2048) == 1024
    assert _effective_chunk(100, 2048) == 256
    assert _effective_chunk(1, 256) == 256

    elev = shelf_seamount(96, 160)
    grid = RegularGrid.dense(elev, EXT)
    lon, lat = _trajectory(grid, 4096, row_frac=0.4, row_width_frac=0.02)
    r = BandRouter(grid, chunk=2048)
    r.prepare(lon, lat, method="idw")
    zf, okf = (np.asarray(a) for a in r._resampler.resample(lon, lat))
    # a 512-ping tick: same queries, clamped chunk, matching values
    zs, oks = (np.asarray(a) for a in r._resampler.resample(lon[:512], lat[:512]))
    assert oks.mean() >= okf[:512].mean()  # smaller boxes resolve no worse
    both = oks & okf[:512]
    np.testing.assert_allclose(zs[both], zf[:512][both], rtol=1e-6, atol=1e-4)


def test_router_auto_window_transposed():
    # BandRouter(auto_window, lerp_mode='hat_t') sizes wc to the 8-sublane
    # quantum instead of the 128-lane register; values match to 1 f32 ulp
    from auvtpu.ops.band import BandRouter

    elev = shelf_seamount(96, 160)
    grid = RegularGrid.dense(elev, EXT)
    lon, lat = _trajectory(grid, 2048, row_frac=0.4, row_width_frac=0.02)
    # wide-layout control (the pre-r5 defaults); hat_t+auto IS the default now
    r0 = BandRouter(grid, chunk=64, win_rows=48, win_cols=128,
                    auto_window=False, lerp_mode="hat")
    r0.prepare(lon, lat, method="idw")
    rt = BandRouter(grid, chunk=64, auto_window=True, lerp_mode="hat_t")
    rt.prepare(lon, lat, method="idw")
    assert rt._resampler.wc < 128 and rt._resampler.wc % 8 == 0
    z0, ok0 = (np.asarray(a) for a in r0._resampler.resample(lon, lat))
    z1, ok1 = (np.asarray(a) for a in rt._resampler.resample(lon, lat))
    assert ok1.mean() > 0.95
    both = ok0 & ok1
    np.testing.assert_allclose(z1[both], z0[both], rtol=1e-6, atol=1e-4)


def test_lerp_hat2_narrow_window_falls_back():
    # wc < 32 (or not 16-aligned) must transparently use the flat hat path
    elev = shelf_seamount(64, 96)
    grid = RegularGrid.dense(elev, EXT)
    band = fill_band(grid, 8, 32, 0, 96, method="idw")
    lon, lat = _trajectory(grid, 256, row_frac=0.35, row_width_frac=0.03)
    ref = BandResampler(grid, band, chunk=32, win_rows=16, win_cols=24)
    alt = BandResampler(grid, band, chunk=32, win_rows=16, win_cols=24,
                        lerp_mode="hat2")
    z0, ok0 = (np.asarray(a) for a in ref.resample(lon, lat))
    z1, ok1 = (np.asarray(a) for a in alt.resample(lon, lat))
    np.testing.assert_array_equal(ok1, ok0)
    np.testing.assert_array_equal(z1[ok0], z0[ok0])


def test_band_resample_masked_plane():
    # undefined band cells must yield unresolved (never silently 0-filled):
    # build a Band with a hole and query straight into it
    plane = np.ones((32, 128), np.float32) * 5.0
    vmask = np.ones((32, 128), np.float32)
    vmask[10:12, 40:44] = 0.0
    plane[10:12, 40:44] = 0.0
    grid = RegularGrid.dense(np.ones((32, 128)), EXT)
    band = Band(plane=jnp.asarray(plane), vmask=jnp.asarray(vmask),
                masked=True, row0=0, col0=0)
    rs = BandResampler(grid, band, chunk=64, win_rows=16, win_cols=64)
    # q0 inside the hole, q2 touches hole row 10; all four fit one 16x64
    # window based at the chunk min (col 20, row 5)
    xs = np.array([40.5, 20.5, 41.2, 70.0])
    ys = np.array([10.5, 5.5, 9.3, 14.0])
    lon = EXT.min_lon + xs * grid.lon_step
    lat = EXT.min_lat + ys * grid.lat_step
    z, ok = rs.resample(lon, lat)
    z, ok = np.asarray(z), np.asarray(ok)
    assert not ok[0] and np.isnan(z[0])
    assert not ok[2] and np.isnan(z[2])
    assert ok[1] and ok[3]
    assert np.allclose(z[[1, 3]], 5.0, atol=1e-5)


def test_band_resample_incoherent_chunks_unresolved():
    # a chunk spanning more columns than the window resolves only the queries
    # inside the clamped window; the rest report unresolved
    elev = shelf_seamount(64, 512)
    grid = RegularGrid.dense(elev, EXT)
    band = fill_band(grid, 0, 64, 0, 512, method="idw")
    rs = BandResampler(grid, band, chunk=32, win_rows=32, win_cols=64)
    rng = np.random.default_rng(1)
    xs = rng.uniform(1, 510, 256)  # random: spans >> 64-col window
    ys = rng.uniform(1, 62, 256)
    lon = EXT.min_lon + xs * grid.lon_step
    lat = EXT.min_lat + ys * grid.lat_step
    z, ok = rs.resample(lon, lat)
    ok = np.asarray(ok)
    assert ok.mean() < 0.9  # incoherent: plenty escalates
    # resolved ones are still CORRECT
    want = _ref_bilinear(band.plane, xs, ys)
    got = np.asarray(z)
    assert np.abs(got[ok] - want[ok]).max() < 1e-3


def test_band_router_end_to_end_and_escalation():
    elev = shelf_seamount(96, 160)
    reduced, rc, _ = mask_grid(elev, 0.15, seed=7)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    router = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    lon, lat = _trajectory(grid, 2000, seed=2)
    # coherent trajectory routes to band; result matches the band resample
    # with exact two-tier kriging at every unresolved query
    z = np.asarray(router.kriging(lon, lat, force="band"))
    assert np.isfinite(z).all()
    rs = router._resampler
    zr, ok = rs.resample(lon, lat)
    zr, ok = np.asarray(zr), np.asarray(ok)
    np.testing.assert_allclose(z[ok], zr[ok], atol=1e-5)
    if (~ok).any():
        want = np.asarray(router.two_tier.kriging(
            jnp.asarray(lon[~ok], jnp.float32), jnp.asarray(lat[~ok], jnp.float32)))
        np.testing.assert_allclose(z[~ok], want, atol=1e-4)
    # in-band values approximate exact kriging (band semantics: resample of
    # the cell-aligned fill) — sanity-bound the divergence on a smooth field
    exact = np.asarray(router.two_tier.kriging(
        jnp.asarray(lon, jnp.float32), jnp.asarray(lat, jnp.float32)))
    span = float(np.nanmax(elev) - np.nanmin(elev))
    assert np.nanmean(np.abs(z - exact)) < 0.05 * span


def test_band_router_routing_decisions():
    elev = shelf_seamount(96, 160)
    reduced, _, _ = mask_grid(elev, 0.15, seed=7)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    router = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    lon, lat = _trajectory(grid, 4096, row_width_frac=0.04)
    assert router.coherence(lon, lat) > 0.9
    rng = np.random.default_rng(0)
    rlon = rng.uniform(EXT.min_lon + 0.1, EXT.max_lon - 0.1, 4096)
    rlat = rng.uniform(EXT.min_lat + 0.1, EXT.max_lat - 0.1, 4096)
    assert router.coherence(rlon, rlat) < 0.2
    # random batches must route packed; a coherent batch with an amortized
    # band (serving mode) must route band
    assert router.route(rlon, rlat) == "packed"
    router.prepare(lon, lat)
    assert router.route(lon, lat, band_ready=True) == "band"


def test_band_bbox_snapping():
    elev = shelf_seamount(96, 512)
    grid = RegularGrid.dense(elev, EXT)
    router = BandRouter(grid, fill_backend="xla")
    lon, lat = _trajectory(grid, 500, row_frac=0.5, row_width_frac=0.03)
    r0, nr, c0, nc = router.band_bbox(lon, lat)
    assert nr % 8 == 0 and nc % 128 == 0
    assert 0 <= r0 and r0 + nr <= 96 and 0 <= c0 and c0 + nc <= 512
    x = (lon - EXT.min_lon) / grid.lon_step
    y = (lat - EXT.min_lat) / grid.lat_step
    assert (np.floor(y) >= r0).all() and (np.floor(y) + 1 <= r0 + nr - 1).all()
    assert (np.floor(x) >= c0).all() and (np.floor(x) + 1 <= c0 + nc - 1).all()


def _diagonal(grid, n, seed=0, width=3.0):
    """Diagonal survey crossing the whole grid: thin corridor, huge bbox."""
    H, W = grid.shape
    t = np.linspace(0.0, 1.0, n)
    x = 1.0 + t * (W - 3)
    y = 1.0 + t * (H - 3)
    rng = np.random.default_rng(seed)
    x = np.clip(x + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(y + width * np.sin(t * 20 * np.pi) + rng.normal(0, 0.05, n),
                0.5, H - 1.5)
    lon = EXT.min_lon + x * grid.lon_step
    lat = EXT.min_lat + y * grid.lat_step
    return lon, lat


def test_plan_segments_diagonal_vs_confined():
    from auvtpu.ops.band import plan_segments

    elev = shelf_seamount(512, 640)
    grid = RegularGrid.dense(elev, EXT)
    lon, lat = _diagonal(grid, 8192)
    x = (lon - EXT.min_lon) / grid.lon_step
    y = (lat - EXT.min_lat) / grid.lat_step
    segs = plan_segments(x, y, chunk=512, max_bands=8, grid_shape=grid.shape)
    assert 1 < len(segs) <= 8
    for r0, c0, nr, nc in segs:
        assert nr % 8 == 0 and nc % 128 == 0
        assert 0 <= r0 <= 512 - nr and 0 <= c0 <= 640 - nc
    # segmentation must beat the bbox band by a wide margin on a diagonal
    pr = max(s[2] for s in segs)
    pc = max(s[3] for s in segs)
    assert len(segs) * pr * pc < 0.55 * 512 * 640
    # a band-confined trajectory yields ONE segment (segmentation never
    # penalizes the confined case)
    lon2, lat2 = _trajectory(grid, 8192, row_frac=0.4, row_width_frac=0.02)
    x2 = (lon2 - EXT.min_lon) / grid.lon_step
    y2 = (lat2 - EXT.min_lat) / grid.lat_step
    assert len(plan_segments(x2, y2, chunk=512, max_bands=8,
                             grid_shape=grid.shape)) == 1


def test_atlas_resample_parity_dense():
    # atlas resample == direct f64 bilinear on the page planes, page routing
    # picks the right page for every chunk of a diagonal track
    from auvtpu.ops.band import AtlasResampler, build_atlas, plan_segments

    elev = shelf_seamount(256, 384)
    grid = RegularGrid.dense(elev, EXT)
    lon, lat = _diagonal(grid, 4096, width=2.0)
    x = (lon - EXT.min_lon) / grid.lon_step
    y = (lat - EXT.min_lat) / grid.lat_step
    segs = plan_segments(x, y, chunk=256, max_bands=6, grid_shape=grid.shape)
    assert len(segs) > 1
    atlas = build_atlas(grid, segs, method="idw")
    rs = AtlasResampler(grid, atlas, chunk=256, win_rows=48, win_cols=128)
    z, ok = rs.resample(lon, lat)
    z, ok = np.asarray(z), np.asarray(ok)
    assert ok.mean() > 0.9  # coherent: nearly everything resolves in-page
    # oracle: dense grid -> every page plane equals the elev crop, so the
    # resample must equal direct bilinear of elev at the query coords
    want = _ref_bilinear(elev, x, y)
    assert np.abs(z[ok] - want[ok]).max() < 1e-3
    assert np.isnan(z[~ok]).all()


def test_band_router_multiband_end_to_end():
    # masked grid + diagonal mission through max_bands>1: resolved queries
    # equal the bilinear resample of the whole-grid kriging fill; unresolved
    # escalate to exact two-tier kriging; refresh() keeps geometry and parity
    from auvtpu.ops import fill_kriging

    elev = shelf_seamount(192, 256)
    reduced, _, _ = mask_grid(elev, 0.12, seed=5)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    router = BandRouter(grid, chunk=128, win_rows=48, win_cols=128,
                        fill_backend="xla", max_bands=6)
    lon, lat = _diagonal(grid, 2048, width=2.0)
    out = router.prepare(lon, lat)
    assert hasattr(out, "origins")  # got an atlas, not a single band
    assert out.shape[0] > 1
    z = np.asarray(router.kriging(lon, lat, force="band"))
    assert np.isfinite(z).all()
    zr, ok = router._resampler.resample(lon, lat)
    zr, ok = np.asarray(zr), np.asarray(ok)
    np.testing.assert_allclose(z[ok], zr[ok], atol=1e-5)
    # resolved values match the whole-grid fill's bilinear resample (band
    # pages are crops of the same fill: test_fill_band_matches_whole_grid_fill)
    whole = np.asarray(fill_kriging(grid))
    keep = np.where(np.asarray(grid.valid) > 0.5, np.asarray(grid.elev), whole)
    x = (lon - EXT.min_lon) / grid.lon_step
    y = (lat - EXT.min_lat) / grid.lat_step
    want = _ref_bilinear(keep, x, y)
    fin = ok & np.isfinite(want)
    assert np.abs(z[fin] - want[fin]).max() < 5e-3
    if (~ok).any():
        tt = np.asarray(router.two_tier.kriging(
            jnp.asarray(lon[~ok], jnp.float32), jnp.asarray(lat[~ok], jnp.float32)))
        np.testing.assert_allclose(z[~ok], tt, atol=1e-4)
    # refresh keeps page geometry and stays parity-clean
    atlas2 = router.refresh()
    assert atlas2.shape == out.shape
    assert np.array_equal(np.asarray(atlas2.origins), np.asarray(out.origins))
    z2, ok2 = router._resampler.resample(lon, lat)
    assert np.array_equal(np.asarray(ok2), ok)
    np.testing.assert_allclose(np.asarray(z2)[ok], zr[ok], atol=1e-6)


def test_auto_window_shrinks_and_matches_fixed():
    # a dense low-weave trajectory must shrink the resample window (the
    # gather volume driver) without changing any resolved value
    elev = shelf_seamount(256, 512)
    grid = RegularGrid.dense(elev, EXT)
    H, W = grid.shape
    n = 4096
    t = np.linspace(0, 1, n)
    x = 1.0 + t * (W - 3)
    # gently sloped: the BAND spans ~100 rows but each 256-ping chunk only
    # ~8 — exactly the case where the fixed 48-row window over-gathers
    y = H * 0.2 + 0.2 * x + 2.0 * np.sin(t * 40 * np.pi)
    lon = EXT.min_lon + x * grid.lon_step
    lat = EXT.min_lat + y * grid.lat_step
    for mode in ("hat", "hat_t"):
        auto = BandRouter(grid, chunk=256, fill_backend="xla",
                          win_rows=48, auto_window=True, lerp_mode=mode)
        auto.prepare(lon, lat)
        fixed = BandRouter(grid, chunk=256, fill_backend="xla",
                           win_rows=48, auto_window=False, lerp_mode=mode)
        fixed.prepare(lon, lat)
        assert auto._resampler.wr < fixed._resampler.wr  # shrank below 48
        za, oka = auto._resampler.resample(lon, lat)
        zf, okf = fixed._resampler.resample(lon, lat)
        assert np.asarray(oka).all() and np.asarray(okf).all()
        if mode == "hat":
            # wide layout: window size never regroups the reductions
            np.testing.assert_array_equal(np.asarray(za), np.asarray(zf))
        else:
            # transposed row contraction: wr is a contraction dim, so the
            # backend may pick a different FMA pairing across sizes
            np.testing.assert_allclose(np.asarray(za), np.asarray(zf),
                                       rtol=1e-6, atol=1e-4)


def test_streaming_mission_loop():
    # the real-time AUV loop: streaming ingest -> router.refresh(si.grid())
    # -> resample the upcoming track.  New observations must propagate into
    # BOTH the band fill and the escalation engine.
    from auvtpu.streaming import StreamingInterpolator

    H, W = 96, 256
    ext = EXT
    si = StreamingInterpolator((H, W), ext, swath_cap=512, method="kriging",
                               backend="xla")
    rng = np.random.default_rng(3)

    def swath(c0, c1):
        """Observe a block of columns on every 2nd row (sonar-like)."""
        rows, cols = np.mgrid[0:H:2, c0:c1]
        rows, cols = rows.ravel(), cols.ravel()
        vals = (100.0 + rows * 0.5 + cols * 0.25).astype(np.float64)
        si.ingest(rows, cols, vals)
        return vals

    swath(0, 128)  # first half surveyed
    router = BandRouter(si.grid(), chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    n = 512
    t = np.linspace(0, 1, n)
    x = 2.0 + t * 120.0          # track inside the surveyed half
    y = H * 0.5 + 3 * np.sin(t * 20 * np.pi)
    lon = ext.min_lon + x * router.grid.lon_step
    lat = ext.min_lat + y * router.grid.lat_step
    router.prepare(lon, lat)
    z1 = np.asarray(router.kriging(lon, lat, force="band"))
    assert np.isfinite(z1).all()
    want = 100.0 + y * 0.5 + x * 0.25  # linear field: bilinear is exact
    np.testing.assert_allclose(z1, want, atol=1.0)  # odd rows are kriged

    # second half arrives; refresh must propagate to fill AND escalation
    swath(128, 256)
    router.refresh(grid=si.grid())
    x2 = 130.0 + t * 110.0       # track in the NEWLY surveyed half
    lon2 = ext.min_lon + x2 * router.grid.lon_step
    z2 = np.asarray(router.kriging(lon2, lat, force="band"))
    assert np.isfinite(z2).all()
    want2 = 100.0 + y * 0.5 + x2 * 0.25
    # band geometry was prepared on the OLD track; the new track largely
    # escalates — escalation must answer from the REFRESHED grid
    np.testing.assert_allclose(z2, want2, atol=1.0)
    assert router.two_tier.grid is router.grid  # no stale escalation engine


def test_refresh_lossy_grid_recomputes_masked():
    # refresh(grid=...) with a REPLACEMENT grid that lost observations must
    # not pin masked=False from the original build: the masked=False resample
    # fast path skips the vmask channel and would serve zero-filled undefined
    # cells as real depths (ADVICE r4, medium)
    H, W = 64, 256
    elev = shelf_seamount(H, W)
    grid = RegularGrid.dense(elev, EXT)
    router = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    lon, lat = _trajectory(grid, 1024, row_frac=0.5, row_width_frac=0.05)
    router.prepare(lon, lat)
    assert router._band.masked is False  # dense grid: fully defined fill
    # replacement grid: right 100 columns entirely unobserved — wider than
    # the 2*margin+1 kriging window, so central cells stay undefined
    lossy = np.asarray(elev, np.float64).copy()
    lossy[:, W - 100:] = np.nan
    g2 = RegularGrid.from_nan_array(lossy, EXT)
    router.refresh(grid=g2)
    assert router._band.masked is True  # recomputed, not pinned
    # a query deep inside the unobserved region must be unresolved (escalated
    # by kriging()), never a silent 0-filled depth
    x = np.full(8, W - 40.0)
    y = np.linspace(20.0, 40.0, 8)
    qlon = EXT.min_lon + x * grid.lon_step
    qlat = EXT.min_lat + y * grid.lat_step
    _, ok = router._resampler.resample(qlon, qlat)
    assert not np.asarray(ok).any()
    # assume_masked=False keeps the zero-sync pin (accumulate-only contract)
    router2 = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                         fill_backend="xla")
    router2.prepare(lon, lat)
    router2.refresh(grid=g2, assume_masked=False)
    assert router2._band.masked is False


def test_route_band_ready_requires_footprint():
    # serving mode: a coherent batch OUTSIDE the prepared band must route
    # packed — resample-then-escalate-everything costs ~2x packed (ADVICE r4)
    elev = shelf_seamount(192, 256)
    reduced, _, _ = mask_grid(elev, 0.1, seed=4)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    router = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    lon, lat = _trajectory(grid, 4096, row_frac=0.25, row_width_frac=0.03)
    router.prepare(lon, lat)
    assert router.route(lon, lat, band_ready=True) == "band"
    # same shape of trajectory, far outside the band
    lon2, lat2 = _trajectory(grid, 4096, row_frac=0.75, row_width_frac=0.03)
    assert router.coherence(lon2, lat2) > 0.9        # coherent per se
    assert router.coherence(lon2, lat2, within_footprint=True) < 0.1
    assert router.route(lon2, lat2, band_ready=True) == "packed"


def test_router_idw_serving():
    # idw() serves the IDW band fill with IDW escalation; method mismatch
    # with the prepared band raises instead of silently mixing fills
    import pytest

    elev = shelf_seamount(128, 256)
    reduced, _, _ = mask_grid(elev, 0.1, seed=2)
    grid = RegularGrid.from_nan_array(reduced, EXT)
    router = BandRouter(grid, chunk=64, win_rows=32, win_cols=128,
                        fill_backend="xla")
    lon, lat = _trajectory(grid, 1024, row_frac=0.5, row_width_frac=0.05)
    router.prepare(lon, lat, method="idw")
    z = np.asarray(router.idw(lon, lat, force="band"))
    assert np.isfinite(z).all()
    # resolved values equal the direct bilinear of the idw band plane
    band = router._band
    x = (lon - EXT.min_lon) / grid.lon_step - band.col0
    y = (lat - EXT.min_lat) / grid.lat_step - band.row0
    want = _ref_bilinear(np.asarray(band.plane, np.float64), x, y)
    zr, ok = router._resampler.resample(lon, lat)
    ok = np.asarray(ok)
    assert np.abs(z[ok] - want[ok]).max() < 1e-3
    with pytest.raises(ValueError, match="re-prepare"):
        router.kriging(lon, lat, force="band")
