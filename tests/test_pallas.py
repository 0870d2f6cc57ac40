"""The fused kriging fill kernel (pallas/kriging_fill.py) vs the XLA path.

Here the kernel runs in the Pallas interpreter (backend="triton",
interpret=True); the `gpu`-marked test at the end compiles it for the card.
Selection must be identical to ops.dense (same offset order, first-k-valid,
ties); predictions agree to f32 rounding.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_kriging
from auvtpu.ops.dense import window_topk_planes
from auvtpu.pallas import fused_fill_kriging
from auvtpu.synthetic import shelf_seamount

H, W = 96, 80


def _grid(h=H, w=W, removal=0.2, seed=9):
    elev, _, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
    return RegularGrid.from_nan_array(elev, Extent(0.0, float(w - 1), 0.0, float(h - 1)))


@pytest.fixture(scope="module")
def grid():
    return _grid()


def _fused(grid, **kw):
    return fused_fill_kriging(grid, interpret=True, **kw)


def _assert_matches(got, want, rtol=1e-4, atol=0.05):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


def _counts(grid, **kw):
    return np.asarray(window_topk_planes(grid, k=4, **kw)[0])


def test_pallas_fill_kriging_fused_matches_xla(grid):
    a, cnt = _fused(grid, max_radius=5, with_count=True)
    np.testing.assert_array_equal(np.asarray(cnt), _counts(grid, max_radius=5))
    _assert_matches(a, fill_kriging(grid, max_radius=5))


def test_pallas_fused_kriging_centered_matches_xla(grid):
    a, cnt = _fused(grid, max_radius=5, convention="centered", with_count=True)
    np.testing.assert_array_equal(
        np.asarray(cnt), _counts(grid, max_radius=5, convention="centered")
    )
    _assert_matches(a, fill_kriging(grid, max_radius=5, convention="centered"))


@pytest.mark.parametrize("model", ["spherical", "gaussian", "linear"])
def test_pallas_fused_kriging_model_zoo_matches_xla(grid, model):
    vp = (0.5, 120.0, 6.0)
    _assert_matches(
        _fused(grid, max_radius=5, vparams=vp, model=model),
        fill_kriging(grid, max_radius=5, vparams=vp, model=model),
    )


def test_pallas_fill_kriging_variance_matches_xla(grid):
    a, av = _fused(grid, max_radius=5, with_variance=True)
    b, bv = fill_kriging(grid, max_radius=5, with_variance=True)
    _assert_matches(a, b)
    _assert_matches(av, bv, rtol=1e-3)
    assert (np.asarray(av)[~np.isnan(np.asarray(av))] >= 0).all()
    # the prediction plane is the same whether or not variance is requested
    assert np.array_equal(np.asarray(_fused(grid, max_radius=5)), np.asarray(a), equal_nan=True)


def test_pallas_fill_kriging_subplane_matches_xla(grid):
    """row0/col0/steps (sharded-block and streaming-window geometry)."""
    kw = dict(max_radius=5, row0=7, col0=13, steps=(0.021, 0.037))
    _assert_matches(_fused(grid, **kw), fill_kriging(grid, **kw))


def test_pallas_fitted_vparams_traced(grid):
    """Traced (fitted) variogram parameters flow through the kernel's
    parameter vector."""
    vp = (jnp.float32(0.05), jnp.float32(120.0), jnp.float32(0.8))
    got = jax.jit(lambda g, v: _fused(g, max_radius=5, vparams=v))(grid, vp)
    _assert_matches(got, fill_kriging(grid, max_radius=5, vparams=vp))


@pytest.mark.parametrize("shape", [(45, 70), (17, 33), (16, 64)])
def test_pallas_ragged_edge_tiles(shape):
    """Grids that are not multiples of the (16, 64) tile (and one exactly
    one tile): the padded tail starts saturated and is sliced off."""
    g = _grid(*shape, removal=0.25, seed=5)
    a, cnt = _fused(g, max_radius=5, with_count=True)
    assert np.asarray(a).shape == shape
    np.testing.assert_array_equal(np.asarray(cnt), _counts(g, max_radius=5))
    _assert_matches(a, fill_kriging(g, max_radius=5))


def test_pallas_heavy_mask_defeats_early_exit():
    """60% removal: tiles keep scanning far past the first chunks, and
    cells with no 4 valid neighbours inside the radius take the mean
    fallback (or NaN with none at all)."""
    g = _grid(64, 64, removal=0.6, seed=3)
    a, cnt = _fused(g, max_radius=2, with_count=True)
    want_cnt = _counts(g, max_radius=2)
    np.testing.assert_array_equal(np.asarray(cnt), want_cnt)
    assert (want_cnt < 4).any()
    _assert_matches(a, fill_kriging(g, max_radius=2))


def test_pallas_radius1_single_chunk(grid):
    """max_radius=1: the whole offset table is one chunk."""
    a, cnt = _fused(grid, max_radius=1, with_count=True)
    np.testing.assert_array_equal(np.asarray(cnt), _counts(grid, max_radius=1))
    _assert_matches(a, fill_kriging(grid, max_radius=1))


def test_pallas_rejects_f64(grid):
    jax.config.update("jax_enable_x64", True)
    try:
        g64 = RegularGrid.from_nan_array(grid.to_nan_array(), grid.extent, dtype=np.float64)
        with pytest.raises(ValueError, match="f32"):
            fused_fill_kriging(g64, interpret=True)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_fused_backend_lowers_to_one_triton_call(grid):
    """fill_kriging(backend='fused') lowered for CUDA (no card needed) is
    one Triton kernel call; the xla backend has none."""
    fused = jax.jit(lambda g: fill_kriging(g, backend="fused"))
    txt = fused.trace(grid).lower(lowering_platforms=("cuda",)).as_text()
    assert txt.count("__gpu$xla.gpu.triton") == 1
    xla = jax.jit(lambda g: fill_kriging(g, backend="xla"))
    assert "triton" not in xla.trace(grid).lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.gpu
def test_fused_kernel_compiled_matches_xla_on_gpu(gpu):
    """The kernel as compiled for the card (no interpreter) vs the XLA path."""
    g = _grid(300, 500, removal=0.1, seed=1)
    a, cnt = fused_fill_kriging(g, with_count=True)
    np.testing.assert_array_equal(np.asarray(cnt), _counts(g))
    got, want = np.asarray(a), np.asarray(fill_kriging(g, backend="xla"))
    assert (np.isnan(got) == np.isnan(want)).all()
    m = ~np.isnan(want)
    err = np.abs(got[m] - want[m])
    assert (err <= 1e-3).mean() >= 0.999 and err.max() <= 0.05
