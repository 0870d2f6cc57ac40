"""Streaming swath interpolation tests."""

import numpy as np
import pytest

from auvtpu.config import Extent
from auvtpu.streaming import StreamingInterpolator
from auvtpu.synthetic import shelf_seamount


@pytest.fixture()
def si():
    ext = Extent(0.0, 511.0, 0.0, 511.0)
    return StreamingInterpolator(
        (512, 512), ext, swath_cap=256, window=(64, 64), method="idw", k=4, max_radius=5
    )


def test_ingest_and_snapshot(si):
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(0)
    rows = r.randint(0, 512, 1000)
    cols = r.randint(0, 512, 1000)
    si.ingest(rows, cols, truth[rows, cols])
    snap = si.snapshot()
    obs = ~np.isnan(snap)
    assert obs.sum() == len(np.unique(rows * 512 + cols))
    np.testing.assert_allclose(snap[rows, cols], truth[rows, cols], rtol=1e-6)


def test_ingest_ragged_chunks(si):
    # 300 points with cap 256 -> two chunks incl. a padded one
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(1)
    rows = r.randint(0, 512, 300)
    cols = r.randint(0, 512, 300)
    n = si.ingest(rows, cols, truth[rows, cols])
    assert n == 300
    snap = si.snapshot()
    # padding lanes must not invent observations at cell (0,0)
    if (rows * 512 + cols == 0).sum() == 0:
        assert np.isnan(snap[0, 0])


def test_ragged_chunk_observation_at_cell_zero_survives(si):
    # regression: pad lanes used to scatter a stale value into flat index 0,
    # which could clobber a genuine observation at cell (0,0) in the same
    # ragged chunk (duplicate-index .at[].set order is undefined)
    rows = np.array([0, 5])
    cols = np.array([0, 7])
    vals = np.array([-123.5, -77.0], np.float32)
    si.ingest(rows, cols, vals)  # 2 live + 254 pad lanes in one chunk
    snap = si.snapshot()
    assert snap[0, 0] == pytest.approx(-123.5)
    assert snap[5, 7] == pytest.approx(-77.0)


def test_window_fill_recovers_surface(si):
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(2)
    # dense swath coverage around the "vehicle" at (256, 256)
    rows = r.randint(192, 320, 8000)
    cols = r.randint(192, 320, 8000)
    si.ingest(rows, cols, truth[rows, cols])
    tile, (r0, c0) = si.window_fill(256, 256)
    tile = np.asarray(tile)
    assert tile.shape == (64, 64)
    want = truth[r0 : r0 + 64, c0 : c0 + 64]
    finite = np.isfinite(tile)
    assert finite.mean() > 0.95  # nearly fully interpolated
    rmse = np.sqrt(np.nanmean((np.where(finite, tile, np.nan) - want) ** 2))
    span = truth.max() - truth.min()
    assert rmse / span < 0.05


def test_incremental_updates_change_result(si):
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(3)
    rows = r.randint(224, 288, 500)
    cols = r.randint(224, 288, 500)
    si.ingest(rows, cols, truth[rows, cols])
    t1, _ = si.window_fill(256, 256)
    rows2 = r.randint(224, 288, 500)
    cols2 = r.randint(224, 288, 500)
    si.ingest(rows2, cols2, truth[rows2, cols2])
    t2, _ = si.window_fill(256, 256)
    assert not np.array_equal(np.asarray(t1), np.asarray(t2))
    # observed cells pass through exactly
    snap = si.snapshot()
    np.testing.assert_allclose(snap[rows2, cols2], truth[rows2, cols2], rtol=1e-6)


def test_duplicate_cells_last_write_wins(si):
    # duplicates within ONE staged flush must resolve deterministically to
    # the most recently ingested value (arrival order), not XLA scatter luck
    rows = np.array([9, 9, 9, 10])
    cols = np.array([4, 4, 4, 4])
    vals = np.array([-1.0, -2.0, -3.0, -8.0], np.float32)
    si.ingest(rows, cols, vals)
    snap = si.snapshot()
    assert snap[9, 4] == pytest.approx(-3.0)
    assert snap[10, 4] == pytest.approx(-8.0)
    # a later ingest (separate flush) overwrites again
    si.ingest([9], [4], [-5.0])
    assert si.snapshot()[9, 4] == pytest.approx(-5.0)


def test_stage_overflow_flushes(si):
    # stage capacity is swath_cap * stage_slots = 256 * 16 = 4096; ingesting
    # more than that in one call must loop flushes without losing points
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(7)
    rows = r.randint(0, 512, 5000)
    cols = r.randint(0, 512, 5000)
    n = si.ingest(rows, cols, truth[rows, cols])
    assert n == 5000
    assert si._staged < si.stage_cap
    snap = si.snapshot()
    np.testing.assert_allclose(snap[rows, cols], truth[rows, cols], rtol=1e-6)


def test_flush_is_lazy_and_idempotent(si):
    si.ingest([1], [2], [-4.0])
    assert si._staged == 1
    assert si.flush() == 1
    assert si.flush() == 0
    assert si.snapshot()[1, 2] == pytest.approx(-4.0)


def test_window_clamps_at_edges(si):
    tile, (r0, c0) = si.window_fill(0, 0)
    assert (r0, c0) == (0, 0)
    tile, (r0, c0) = si.window_fill(511, 511)
    assert (r0, c0) == (512 - 64, 512 - 64)


def test_save_load_roundtrip(si, tmp_path):
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(8)
    rows = r.randint(0, 512, 800)
    cols = r.randint(0, 512, 800)
    si.ingest(rows, cols, truth[rows, cols])
    path = str(tmp_path / "mosaic.npz")
    si.save(path)

    from auvtpu.streaming import StreamingInterpolator

    si2 = StreamingInterpolator.load(path)
    assert si2.shape == si.shape
    assert si2.window == si.window and si2.method == si.method
    np.testing.assert_array_equal(si2.snapshot(), si.snapshot())
    # resumed instance keeps working: new observations land on the mosaic
    si2.ingest([3], [4], [-42.0])
    assert si2.snapshot()[3, 4] == pytest.approx(-42.0)


def test_fit_variogram_self_tunes_kriging_fill():
    ext = Extent(0.0, 255.0, 0.0, 255.0)
    si = StreamingInterpolator(
        (256, 256), ext, swath_cap=256, window=(64, 64),
        method="kriging", max_radius=5,
    )
    truth = shelf_seamount(256, 256)
    r = np.random.RandomState(4)
    rows = r.randint(96, 160, 3000)
    cols = r.randint(96, 160, 3000)
    si.ingest(rows, cols, truth[rows, cols])
    t_default, _ = si.window_fill(128, 128)
    vp = si.fit_variogram(max_lag=5, n_bins=5)
    assert all(float(v) > 0 for v in vp)
    t_fitted, _ = si.window_fill(128, 128)
    # the fitted params actually flow into the fill (different weights)
    assert not np.array_equal(np.asarray(t_default), np.asarray(t_fitted))
    assert np.isfinite(np.asarray(t_fitted)).any()


def test_window_uncertainty_surface(si):
    truth = shelf_seamount(512, 512)
    r = np.random.RandomState(6)
    rows = r.randint(240, 272, 3000)
    cols = r.randint(240, 272, 3000)
    si.ingest(rows, cols, truth[rows, cols])
    vmap_, (r0, c0) = si.window_uncertainty(256, 256)
    vmap_ = np.asarray(vmap_)
    assert vmap_.shape == (64, 64)
    obs = np.zeros((512, 512), bool)
    obs[rows, cols] = True
    w_obs = obs[r0 : r0 + 64, c0 : c0 + 64]
    # observed cells are certain; unobserved in-window cells are not
    assert (vmap_[w_obs] == 0).all()
    gaps = ~w_obs & np.isfinite(vmap_)
    assert gaps.any() and (vmap_[gaps] > 0).all()


def test_window_fill_fused_backend_matches_xla():
    """The kriging window fill (the default serving method) vs the f64 v2
    oracle over the same window crop, and its variance surface vs the
    plain sub-plane fill."""
    from auvtpu.config import Extent
    from auvtpu.golden.v2 import GoldenV2
    from auvtpu.grid import RegularGrid
    from auvtpu.ops import fill_kriging

    rng = np.random.RandomState(7)
    H, W = 64, 96
    ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
    rows = rng.randint(0, H, 2500)
    cols = rng.randint(0, W, 2500)
    vals = (-500.0 + 0.5 * cols + rng.normal(0.0, 3.0, 2500)).astype(np.float32)
    si = StreamingInterpolator((H, W), ext, window=(32, 48), method="kriging")
    si.ingest(rows, cols, vals)
    tile, (r0, c0) = si.window_fill(H // 2, W // 2)
    tile = np.asarray(tile)
    crop = si.snapshot()[r0:r0 + 32, c0:c0 + 48]
    gv2 = GoldenV2(crop, float(c0), float(c0 + 47), float(r0), float(r0 + 31))
    rr, cc = np.nonzero(np.isnan(crop))
    want = gv2.kriging(c0 + cc.astype(float), r0 + rr.astype(float))
    got = tile[rr, cc]
    assert (np.isnan(got) == np.isnan(want)).all()
    m = ~np.isnan(want)
    assert (np.abs(got[m] - want[m]) <= 0.15).mean() >= 0.99
    obs = ~np.isnan(crop)
    np.testing.assert_array_equal(tile[obs], crop[obs].astype(np.float32))

    var, _ = si.window_uncertainty(H // 2, W // 2)
    g = si.grid()
    sub = RegularGrid(elev=g.elev[r0:r0 + 32, c0:c0 + 48], valid=g.valid[r0:r0 + 32, c0:c0 + 48],
                      min_lon=g.min_lon, max_lon=g.max_lon, min_lat=g.min_lat, max_lat=g.max_lat)
    _, want_v = fill_kriging(sub, row0=r0, col0=c0, steps=si._steps, with_variance=True)
    want_v = np.where(obs, 0.0, np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(var), want_v.astype(np.float32))
