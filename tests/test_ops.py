"""Device-op parity tests: every XLA op vs the float64 golden oracles.

- main interpolation paths (bilinear / bicubic stencil / kriging system) are
  semantically identical to the reference -> compared against the bit-exact
  GoldenGrid;
- fallback-selection paths use v2 semantics -> compared against GoldenV2.

Tolerances account for f32 device compute vs f64 oracle on ~1e3-magnitude
bathymetry.  Dense tests use unit-step extents (lon_step = 1.0) so the
lon->x roundtrip is exact in both precisions and cell alignment is bitwise.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from auvtpu.golden import GoldenGrid
from auvtpu.golden.v2 import GoldenV2
from auvtpu.grid import RegularGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import (
    fill_bilinear,
    fill_idw,
    fill_kriging,
    fill_window_mean,
    scattered_bicubic,
    scattered_bilinear,
    scattered_idw,
    scattered_kriging,
    upsample2x_bicubic,
    upsample2x_bilinear,
)
from auvtpu.synthetic import shelf_seamount
from auvtpu.config import Extent

H, W = 60, 80
UNIT_EXT = Extent(min_lon=0.0, max_lon=float(W - 1), min_lat=0.0, max_lat=float(H - 1))
GEO_EXT = Extent(min_lon=-180.0, max_lon=-160.0, min_lat=20.0, max_lat=30.0)


def _mk(masked: bool, ext: Extent):
    elev = shelf_seamount(H, W)
    if masked:
        elev, _, _ = mask_grid(elev, 0.10, seed=7)
    grid = RegularGrid.from_nan_array(elev, ext)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    golden_v2 = GoldenV2(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    return elev, grid, golden, golden_v2


def _queries(ext: Extent, n=500, seed=3):
    r = np.random.RandomState(seed)
    eps = 1e-6
    lons = r.uniform(ext.min_lon + eps, ext.max_lon - eps, n)
    lats = r.uniform(ext.min_lat + eps, ext.max_lat - eps, n)
    return lons, lats


def assert_close(got, want, atol=2e-2, frac=1.0):
    """Allclose with NaN agreement; `frac` allows rare f32 tie-flip outliers."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nan_match = np.isnan(got) == np.isnan(want)
    both = ~np.isnan(got) & ~np.isnan(want)
    ok = nan_match & (~both | (np.abs(got - want) <= atol + 1e-5 * np.abs(want)))
    assert ok.mean() >= frac, f"{(~ok).sum()} mismatches of {ok.size}; worst={np.nanmax(np.abs(got - want))}"


# ---------------------------------------------------------------------------
# scattered ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_scattered_bilinear_parity(masked):
    _, grid, golden, _ = _mk(masked, GEO_EXT)
    lons, lats = _queries(GEO_EXT)
    got = scattered_bilinear(grid, lons, lats)
    want = golden.bilinear(lons, lats)
    assert_close(got, want)


def test_scattered_bilinear_oob():
    _, grid, _, _ = _mk(False, GEO_EXT)
    out = np.asarray(scattered_bilinear(grid, [-200.0, -150.0], [25.0, 25.0]))
    assert np.isnan(out).all()


@pytest.mark.parametrize("masked", [False, True])
def test_scattered_bicubic_parity(masked):
    _, grid, golden, golden_v2 = _mk(masked, GEO_EXT)
    lons, lats = _queries(GEO_EXT)
    got = scattered_bicubic(grid, lons, lats)
    # clean-stencil queries match the exact golden; fallback queries match v2
    want = golden_v2.cubic(lons, lats)
    assert_close(got, want, frac=0.995 if masked else 1.0)


def test_scattered_bicubic_never_fallback_matches_exact():
    _, grid, golden, _ = _mk(False, GEO_EXT)
    lons, lats = _queries(GEO_EXT)
    got = scattered_bicubic(grid, lons, lats, fallback="never")
    want = golden.cubic(lons, lats)
    assert_close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_scattered_kriging_parity(masked):
    _, grid, _, golden_v2 = _mk(masked, GEO_EXT)
    lons, lats = _queries(GEO_EXT, n=300)
    got = scattered_kriging(grid, lons, lats)
    want = golden_v2.kriging(lons, lats)
    # kriging solve in f32: looser value tolerance, allow rare tie flips
    assert_close(got, want, atol=0.15, frac=0.99)


@pytest.mark.parametrize("masked", [False, True])
def test_scattered_idw_parity(masked):
    _, grid, _, golden_v2 = _mk(masked, GEO_EXT)
    lons, lats = _queries(GEO_EXT)
    got = scattered_idw(grid, lons, lats, k=8)
    want = golden_v2.idw(lons, lats, k=8)
    assert_close(got, want, frac=0.995 if masked else 1.0)


def test_scattered_no_candidates_nan():
    elev = np.full((H, W), np.nan)
    grid = RegularGrid.from_nan_array(elev, GEO_EXT)
    lons, lats = _queries(GEO_EXT, n=16)
    for op in (scattered_kriging, scattered_idw, scattered_bicubic):
        assert np.isnan(np.asarray(op(grid, lons, lats))).all()


# ---------------------------------------------------------------------------
# dense fill ops (cell-aligned, unit steps => exact alignment)
# ---------------------------------------------------------------------------

def _masked_cells(elev):
    rr, cc = np.where(np.isnan(elev))
    return rr, cc


def test_fill_bilinear_matches_golden_at_cells():
    elev, grid, golden, _ = _mk(True, UNIT_EXT)
    rr, cc = _masked_cells(elev)
    plane = np.asarray(fill_bilinear(grid))
    want = golden.bilinear(cc.astype(float), rr.astype(float))
    assert_close(plane[rr, cc], want)


def test_fill_window_mean_matches_v2_cubic_at_masked_cells():
    elev, grid, _, golden_v2 = _mk(True, UNIT_EXT)
    rr, cc = _masked_cells(elev)
    plane = np.asarray(fill_window_mean(grid, k=4))
    want = golden_v2.cubic(cc.astype(float), rr.astype(float))
    assert_close(plane[rr, cc], want)


def test_fill_kriging_matches_v2_at_masked_cells():
    elev, grid, _, golden_v2 = _mk(True, UNIT_EXT)
    rr, cc = _masked_cells(elev)
    plane = np.asarray(fill_kriging(grid))
    want = golden_v2.kriging(cc.astype(float), rr.astype(float))
    assert_close(plane[rr, cc], want, atol=0.15)


def test_fill_idw_matches_v2_at_masked_cells():
    elev, grid, _, golden_v2 = _mk(True, UNIT_EXT)
    rr, cc = _masked_cells(elev)
    plane = np.asarray(fill_idw(grid, k=8))
    want = golden_v2.idw(cc.astype(float), rr.astype(float), k=8)
    assert_close(plane[rr, cc], want)


# ---------------------------------------------------------------------------
# dense upsample (Grid A expanded pass)
# ---------------------------------------------------------------------------

def _expanded_queries():
    # expanded grid spans the same extent with 2n-1 points per axis
    # (test_interpolation.cpp:91-109); unit-step extent => coords i/2 exactly
    nlon, nlat = 2 * W - 1, 2 * H - 1
    lons = np.arange(nlon) * (W - 1) / (nlon - 1)
    lats = np.arange(nlat) * (H - 1) / (nlat - 1)
    LO, LA = np.meshgrid(lons, lats)
    return LO.ravel(), LA.ravel()


def test_upsample2x_bilinear_matches_golden():
    _, grid, golden, _ = _mk(False, UNIT_EXT)
    got = np.asarray(upsample2x_bilinear(grid))
    lo, la = _expanded_queries()
    want = golden.bilinear(lo, la).reshape(got.shape)
    assert_close(got, want)


def test_upsample2x_bicubic_matches_golden():
    _, grid, golden, _ = _mk(False, UNIT_EXT)
    got = np.asarray(upsample2x_bicubic(grid))
    lo, la = _expanded_queries()
    want = golden.cubic(lo, la).reshape(got.shape)
    assert_close(got, want)


def test_upsample_shapes():
    _, grid, _, _ = _mk(False, UNIT_EXT)
    assert upsample2x_bilinear(grid).shape == (2 * H - 1, 2 * W - 1)
    assert upsample2x_bicubic(grid).shape == (2 * H - 1, 2 * W - 1)
    # even positions are exact copies
    up = np.asarray(upsample2x_bicubic(grid))
    np.testing.assert_allclose(up[::2, ::2], np.asarray(grid.elev), rtol=1e-6)


# ---------------------------------------------------------------------------
# centered distance convention (docs/SEMANTICS.md)
# ---------------------------------------------------------------------------

def test_centered_convention_parity_and_improvement():
    from auvtpu.golden.v2 import GoldenV2
    from auvtpu.ops import fill_idw, fill_window_mean

    elev = shelf_seamount(H, W)
    masked, rc, truth = __import__("auvtpu.masking", fromlist=["mask_grid"]).mask_grid(
        elev, 0.15, seed=21
    )
    grid = RegularGrid.from_nan_array(masked, UNIT_EXT)
    gv2c = GoldenV2(
        masked, UNIT_EXT.min_lon, UNIT_EXT.max_lon, UNIT_EXT.min_lat, UNIT_EXT.max_lat,
        convention="centered",
    )
    rr, cc = rc[:, 0], rc[:, 1]
    # parity: device centered ops match the centered float64 oracle
    got = np.asarray(fill_window_mean(grid, k=4, convention="centered"))[rr, cc]
    want = gv2c.cubic(cc.astype(float), rr.astype(float))
    assert_close(got, want)
    got_i = np.asarray(fill_idw(grid, k=8, convention="centered"))[rr, cc]
    want_i = gv2c.idw(cc.astype(float), rr.astype(float), k=8)
    assert_close(got_i, want_i)
    # improvement: centered beats the reference convention on held-out truth
    ref = np.asarray(fill_window_mean(grid, k=4, convention="reference"))[rr, cc]
    err_c = np.nanmean(np.abs(got - truth))
    err_r = np.nanmean(np.abs(ref - truth))
    assert err_c < err_r


def test_centered_kriging_matches_centered_oracle():
    from auvtpu.golden.v2 import GoldenV2
    from auvtpu.ops import kriging_at_cells
    import jax.numpy as jnp

    elev = shelf_seamount(H, W)
    masked, rc, truth = __import__("auvtpu.masking", fromlist=["mask_grid"]).mask_grid(
        elev, 0.15, seed=22
    )
    grid = RegularGrid.from_nan_array(masked, UNIT_EXT)
    gv2c = GoldenV2(
        masked, UNIT_EXT.min_lon, UNIT_EXT.max_lon, UNIT_EXT.min_lat, UNIT_EXT.max_lat,
        convention="centered",
    )
    rr, cc = rc[:, 0], rc[:, 1]
    got = np.asarray(
        kriging_at_cells(
            grid, jnp.asarray(rr, jnp.int32), jnp.asarray(cc, jnp.int32),
            convention="centered",
        )
    )
    want = gv2c.kriging(cc.astype(float), rr.astype(float))
    assert_close(got, want, atol=0.15)


def test_fill_kriging_variance_grows_with_distance_from_data():
    from auvtpu.config import Extent
    from auvtpu.grid import RegularGrid
    from auvtpu.ops import fill_kriging
    from auvtpu.synthetic import shelf_seamount

    H, W = 48, 64
    elev = shelf_seamount(H, W)
    # valid left half, masked right half
    elev[:, W // 2 :] = np.nan
    grid = RegularGrid.from_nan_array(elev, Extent(0.0, float(W - 1), 0.0, float(H - 1)))
    plane, var = fill_kriging(grid, max_radius=10, with_variance=True)
    var = np.asarray(var)
    # predicted columns near the data edge are more certain than deeper ones
    near = np.nanmean(var[:, W // 2 + 1])
    far = np.nanmean(var[:, W // 2 + 6])
    assert np.isfinite(near) and np.isfinite(far)
    assert far > near > 0
    # beyond max_radius the fallback path has no defined variance
    assert np.isnan(var[:, -1]).all()
