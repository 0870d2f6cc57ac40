"""The backend resolver (ops/backend.py) and the precision pin on every f32
contraction of the scattered, windowed and variogram paths."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid
from auvtpu.masking import mask_grid
from auvtpu.ops.backend import pick, resolve
from auvtpu.synthetic import shelf_seamount


@pytest.mark.parametrize("platform,dtype,want", [
    ("gpu", np.float32, "fused"),
    ("gpu", np.float64, "xla"),
    ("cpu", np.float32, "xla"),
    ("cpu", np.float64, "xla"),
])
def test_resolve_table(platform, dtype, want):
    assert resolve(platform, dtype) == want


@pytest.mark.parametrize("platform", ["cuda", "rocm", "METAL", ""])
def test_resolve_rejects_other_platforms(platform):
    with pytest.raises(ValueError, match="no dense-fill backend"):
        resolve(platform, np.float32)


def test_pick_passes_explicit_and_resolves_auto():
    assert pick("xla", np.float32) == "xla"
    assert pick("fused", np.float32) == "fused"
    # the suite runs on the CPU
    assert pick("auto", np.float32) == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        pick("pallas", np.float32)


def test_fill_kriging_rejects_unknown_backend():
    from auvtpu.ops import fill_kriging

    g = RegularGrid.dense(shelf_seamount(8, 8), Extent(0.0, 7.0, 0.0, 7.0))
    with pytest.raises(ValueError, match="unknown backend"):
        fill_kriging(g, backend="pallas")


def test_streaming_and_sharded_take_the_resolver():
    from auvtpu.streaming import StreamingInterpolator

    si = StreamingInterpolator((16, 16), Extent(0.0, 15.0, 0.0, 15.0))
    assert si.backend == "xla"
    with pytest.raises(ValueError):
        StreamingInterpolator((16, 16), Extent(0.0, 15.0, 0.0, 15.0), backend="transposed")


# ---------------------------------------------------------------------------
# precision: every dot_general of the f32 paths carries Precision.HIGHEST
# (one-hot value picks and small solves; TF32 would round them on a GPU)
# ---------------------------------------------------------------------------

H, W = 40, 50
EXT = Extent(0.0, W - 1.0, 0.0, H - 1.0)


def _inputs():
    from auvtpu.ops.packs import StencilPack, build_valid16_pack

    elev, _, _ = mask_grid(shelf_seamount(H, W), 0.1, seed=1)
    g = RegularGrid.from_nan_array(elev, EXT)
    gd = RegularGrid.dense(shelf_seamount(H, W), EXT)
    lo = jnp.linspace(1.0, 40.0, 64, dtype=jnp.float32)
    la = jnp.linspace(1.0, 30.0, 64, dtype=jnp.float32)
    pts = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (300, 2)), jnp.float32)
    return g, gd, lo, la, StencilPack(g, window_radius=2), build_valid16_pack(gd), pts


def _entry(name):
    from auvtpu import scattered as sc
    from auvtpu import variogram as vg
    from auvtpu.ops import scattered_idw, scattered_kriging, tiled_kriging
    from auvtpu.ops.band import _band_resample
    from auvtpu.ops.packs import packed_idw, packed_kriging, packed_kriging_valid

    g, gd, lo, la, sp, p16, pts = _inputs()
    vals, tg = pts[:, 0] * 3.0, pts[:50] + 0.01
    h = jnp.linspace(0.1, 1.0, 10)
    plane = jnp.asarray(shelf_seamount(64, 128), jnp.float32)
    bx = jnp.linspace(1.0, 120.0, 512, dtype=jnp.float32)
    by = jnp.linspace(1.0, 60.0, 512, dtype=jnp.float32)
    return {
        "packed_kriging": (lambda g, a, b: packed_kriging(sp.window, g, a, b), (g, lo, la)),
        "packed_idw": (lambda g, a, b: packed_idw(sp.window, g, a, b), (g, lo, la)),
        "packed_kriging_valid": (lambda g, a, b: packed_kriging_valid(p16, g, a, b), (gd, lo, la)),
        "window_kriging": (scattered_kriging, (g, lo, la)),
        "window_idw": (scattered_idw, (g, lo, la)),
        "tiled_kriging": (lambda g, a, b: tiled_kriging(g, a, b), (g, lo, la)),
        "band_resample": (lambda p, x, y: _band_resample(
            p, None, x, y, chunk=256, wr=32, wc=128, masked=False, lerp_mode="hat_t"),
            (plane, bx, by)),
        "knn_search": (lambda t, p: sc.knn_search(t, p, k=8), (tg, pts)),
        "linear_knn": (lambda p, v, t: sc.linear_knn(p, v, t, k=8), (pts, vals, tg)),
        "kriging_knn_aniso": (lambda p, v, t: sc.kriging_knn(
            p, v, t, k=8, aniso=(0.1, 1.0, 0.3, 0.2, 0.5)), (pts, vals, tg)),
        "variogram_fit_model": (lambda a, b, c: vg.fit_model(a, b, c), (h, h, jnp.ones(10))),
        "variogram_fit_directional": (vg.fit_variogram_directional, (g,)),
    }[name]


@pytest.mark.parametrize("name", [
    "packed_kriging", "packed_idw", "packed_kriging_valid", "window_kriging",
    "window_idw", "tiled_kriging", "band_resample", "knn_search", "linear_knn",
    "kriging_knn_aniso", "variogram_fit_model", "variogram_fit_directional",
])
def test_every_contraction_is_highest(name):
    fn, args = _entry(name)
    text = jax.jit(fn).lower(*args).as_text()
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", text)
    assert dots, f"{name}: no contraction found (entry point changed?)"
    unpinned = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not unpinned, unpinned[0]
