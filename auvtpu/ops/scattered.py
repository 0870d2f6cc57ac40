"""Scattered-query interpolation ops (arbitrary lon/lat batches).

Device rebuild of the per-point CUDA kernels:
- bilinear  <- bilinearInterpolationKernel (kernels.cu:173-234)
- bicubic   <- cubicInterpolationKernel    (kernels.cu:275-372)
- kriging   <- krigingInterpolationKernel  (kernels.cu:403-546)
- idw       <- new (BASELINE.json configs): distance-weighted generalization
               of the reference's top-4-average fallback.

One thread per point becomes one lane per point: bounds masks instead of early
returns, gathers instead of pointer arithmetic, ``lax.top_k`` instead of the
ring walk, and a vectorized unpivoted Gauss-Jordan over (N,5,6) instead of the
per-thread solver.  All functions are jit-compatible with static grid
geometry; NaN appears only in outputs (out-of-bounds / no-candidates), never
in grid state.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid
from .window import masked_mean, window_select


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _normalize(grid: RegularGrid, lons, lats):
    """lon/lat -> grid coords + strict out-of-bounds mask (GridH.cpp:162-168).
    OOB coords are zeroed so downstream gathers stay in range."""
    lons = jnp.asarray(lons, grid.dtype)
    lats = jnp.asarray(lats, grid.dtype)
    oob = (
        (lons < grid.min_lon)
        | (lons > grid.max_lon)
        | (lats < grid.min_lat)
        | (lats > grid.max_lat)
    )
    x = (lons - grid.min_lon) / jnp.asarray(grid.lon_step, grid.dtype)
    y = (lats - grid.min_lat) / jnp.asarray(grid.lat_step, grid.dtype)
    x = jnp.where(oob, 0.0, x)
    y = jnp.where(oob, 0.0, y)
    return x, y, oob


def _fetch(grid: RegularGrid, jj, ii):
    """Gather (value, validity) at integer cells; indices must be in range.

    One NaN-encoded fetch instead of two plane gathers; see ops.gathers."""
    from .gathers import fetch_masked, nan_plane

    nanp = nan_plane(grid)  # CSE'd across fetches within one jit
    v, ok = fetch_masked(nanp, jj.reshape(-1), ii.reshape(-1), grid.num_lon)
    return v.reshape(jj.shape), ok.reshape(jj.shape)


# ---------------------------------------------------------------------------
# bilinear
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=())
def scattered_bilinear(grid: RegularGrid, lons, lats):
    x, y, oob = _normalize(grid, lons, lats)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, grid.num_lon - 1)
    y1 = jnp.minimum(y0 + 1, grid.num_lat - 1)
    wx = x - x0
    wy = y - y0

    z00, m00 = _fetch(grid, y0, x0)
    z01, m01 = _fetch(grid, y0, x1)
    z10, m10 = _fetch(grid, y1, x0)
    z11, m11 = _fetch(grid, y1, x1)

    z0 = (1 - wx) * z00 + wx * z01
    z1 = (1 - wx) * z10 + wx * z11
    z = (1 - wy) * z0 + wy * z1

    cnt = (
        m00.astype(grid.dtype)
        + m01.astype(grid.dtype)
        + m10.astype(grid.dtype)
        + m11.astype(grid.dtype)
    )
    s = (
        jnp.where(m00, z00, 0.0)
        + jnp.where(m01, z01, 0.0)
        + jnp.where(m10, z10, 0.0)
        + jnp.where(m11, z11, 0.0)
    )
    fb = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), jnp.nan)
    any_invalid = cnt < 4
    out = jnp.where(any_invalid, fb, z)
    return jnp.where(oob, jnp.nan, out)


# ---------------------------------------------------------------------------
# bicubic (Catmull-Rom)
# ---------------------------------------------------------------------------

def _catmull_rom(p0, p1, p2, p3, t):
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
    )


@partial(jax.jit, static_argnames=("fallback", "max_radius", "convention"))
def scattered_bicubic(grid: RegularGrid, lons, lats, *, fallback: str = "auto", max_radius: int = 10, convention: str = "reference"):
    """4x4 Catmull-Rom stencil with clamped edges; window fallback when any of
    the 16 cells is invalid (kernels.cu:305-371).

    fallback: 'auto' (compute window path, select per query), 'never' (skip the
    window entirely — correct for fully-valid grids, e.g. Grid A).
    """
    x, y, oob = _normalize(grid, lons, lats)
    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    tx = x - xi
    ty = y - yi

    rows = []
    all_valid = None
    for m in range(-1, 3):
        jj = jnp.clip(yi + m, 0, grid.num_lat - 1)
        ps = []
        for n in range(-1, 3):
            ii = jnp.clip(xi + n, 0, grid.num_lon - 1)
            v, ok = _fetch(grid, jj, ii)
            ps.append(v)
            all_valid = ok if all_valid is None else (all_valid & ok)
        rows.append(_catmull_rom(ps[0], ps[1], ps[2], ps[3], tx))
    smooth = _catmull_rom(rows[0], rows[1], rows[2], rows[3], ty)

    if fallback == "never":
        out = smooth
    else:
        sel = window_select(grid, x, y, xi, yi, k=4, max_radius=max_radius, convention=convention)
        fb = masked_mean(sel["val"], sel["slot_ok"])
        out = jnp.where(all_valid, smooth, fb)
    return jnp.where(oob, jnp.nan, out)


# ---------------------------------------------------------------------------
# ordinary kriging
# ---------------------------------------------------------------------------

def variogram(h, params):
    """gamma(h) = nugget + sill (1 - exp(-h/range)), h in degrees
    (GridH.cpp:371-376).  ``params`` is (nugget, sill, range) — static floats
    or traced scalars (fitted variograms)."""
    nugget, sill, rng = params
    return nugget + sill * (1.0 - jnp.exp(-h / rng))


def krige_solve(qlon, qlat, vals, cx, cy, cfg: KrigingConfig = KrigingConfig(), vparams=None, model: str = "exponential", with_variance: bool = False):
    """Vectorized unpivoted Gauss-Jordan on the (N,5,6) ordinary-kriging system
    (GridH.cpp:378-419).  Neighbors at cell-center coords (cx, cy); query at
    its raw coordinate — the reference's half-cell offset is intentional.

    vparams: optional traced (nugget, sill, range) overriding cfg.variogram.
    model: static variogram model name (the reference hardcodes exponential,
    GridH.cpp:371-376; the zoo in variogram.variogram_model extends it).
    Returns (pred, singular): prediction and the singular-pivot bailout mask;
    with_variance=True (static) appends the ordinary-kriging prediction
    variance sigma^2 = sum_i w_i gamma(h_i0) + mu — the uncertainty surface
    the reference never exposes, and the natural 'survey here next' signal
    for an AUV mission.
    """
    return krige_solve_cols(
        qlon, qlat,
        [vals[:, a] for a in range(4)],
        [cx[:, a] for a in range(4)],
        [cy[:, a] for a in range(4)],
        cfg, vparams=vparams, model=model, with_variance=with_variance,
    )


def gj56(M, pivot_tol):
    """Unpivoted Gauss-Jordan on a 5x6 system held as 30 (N,) vectors
    (GridH.cpp:378-419 elimination order).  Shared by the coordinate-form
    solve below and the lattice-gamma solve (ops/exact_fast.py).  Returns
    (M, singular) with column 5 holding the solution on non-singular rows."""
    n = M[0][0].shape[0]
    singular = jnp.zeros((n,), dtype=bool)
    for i in range(5):
        pivot = M[i][i]
        singular = singular | (jnp.abs(pivot) < pivot_tol)
        safe = jnp.where(singular, 1.0, pivot)
        for q in range(i, 6):
            M[i][q] = M[i][q] / safe
        for r in range(5):
            if r == i:
                continue
            f = M[r][i]
            for q in range(i, 6):
                M[r][q] = M[r][q] - f * M[i][q]
    return M, singular


def krige_solve_cols(qlon, qlat, vals, cx, cy, cfg: KrigingConfig = KrigingConfig(), vparams=None, model: str = "exponential", with_variance: bool = False):
    """Column-form krige_solve core: ``vals``/``cx``/``cy`` are length-4
    sequences of (N,) arrays.  Lets transposed producers (the Pallas
    valid-grid select emits a (13, N) tensor whose rows ARE the per-slot
    vectors) feed the solve with zero relayout; krige_solve slices (N, 4)
    inputs into this form."""
    vg = (
        vparams
        if vparams is not None
        else (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    )
    if model == "exponential":
        vf = lambda h: variogram(h, vg)
    else:
        from ..variogram import variogram_model

        vf = lambda h: variogram_model(h, vg, model)
    n = vals[0].shape[0]
    dt = vals[0].dtype

    # Scalar-register formulation: the 5x6 system lives in 30 (N,) vectors so
    # the whole build + unpivoted Gauss-Jordan fuses into one elementwise XLA
    # kernel (a (N,5,6) tensor version materializes the matrix ~12x in HBM).
    M = [[None] * 6 for _ in range(5)]
    for a in range(4):
        for b in range(4):
            if b < a:
                M[a][b] = M[b][a]  # symmetric distances
                continue
            dx = cx[a] - cx[b]
            dy = cy[a] - cy[b]
            M[a][b] = vf(jnp.sqrt(dx * dx + dy * dy))
        M[a][4] = jnp.ones((n,), dt)
        ddx = cx[a] - qlon
        ddy = cy[a] - qlat
        M[a][5] = vf(jnp.sqrt(ddx * ddx + ddy * ddy))
    gamma0 = [M[a][5] for a in range(4)]  # gamma(h_i0), pre-elimination
    M[4] = [jnp.ones((n,), dt)] * 4 + [jnp.zeros((n,), dt), jnp.ones((n,), dt)]
    # symmetric aliasing above shares arrays; make row 4 entries independent
    # is unnecessary (they are fresh arrays already)

    M, singular = gj56(M, cfg.pivot_tol)

    pred = (
        M[0][5] * vals[0]
        + M[1][5] * vals[1]
        + M[2][5] * vals[2]
        + M[3][5] * vals[3]
    )
    if not with_variance:
        return pred, singular
    # after elimination column 5 holds the solution: w_i = M[i][5] (i<4),
    # Lagrange multiplier mu = M[4][5]
    var = sum(M[a][5] * gamma0[a] for a in range(4)) + M[4][5]
    return pred, singular, jnp.maximum(var, 0.0)


@partial(jax.jit, static_argnames=("max_radius", "convention", "with_variance"))
def scattered_kriging(grid: RegularGrid, lons, lats, *, max_radius: int = 10, convention: str = "reference", with_variance: bool = False):
    """Window top-4 + exponential variogram + batched 5x5 solve
    (krigingInterpolationKernel, kernels.cu:403-546).

    with_variance=True also returns the ordinary-kriging prediction
    variance (NaN at fallback/out-of-bounds queries)."""
    cfg = KrigingConfig()
    x, y, oob = _normalize(grid, lons, lats)
    # center = round half away from zero, clamped (kernels.cu:425-432)
    ci = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, grid.num_lon - 1)
    cj = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, grid.num_lat - 1)

    sel = window_select(grid, x, y, ci, cj, k=4, max_radius=max_radius, convention=convention)
    half = 0.5 if convention == "reference" else 0.0
    lon_step = jnp.asarray(grid.lon_step, grid.dtype)
    lat_step = jnp.asarray(grid.lat_step, grid.dtype)
    cx = grid.min_lon + (sel["ii"].astype(grid.dtype) + half) * lon_step
    cy = grid.min_lat + (sel["jj"].astype(grid.dtype) + half) * lat_step

    vals = jnp.where(sel["slot_ok"], sel["val"], 0.0)
    solved = krige_solve(
        jnp.asarray(lons, grid.dtype), jnp.asarray(lats, grid.dtype), vals, cx, cy, cfg,
        with_variance=with_variance,
    )
    pred, singular = solved[0], solved[1]
    fb = masked_mean(sel["val"], sel["slot_ok"])
    bail = singular | (sel["found"] < 4)
    out = jnp.where(oob, jnp.nan, jnp.where(bail, fb, pred))
    if not with_variance:
        return out
    var = jnp.where(oob | bail, jnp.nan, solved[2])
    return out, var


# ---------------------------------------------------------------------------
# IDW (k-nearest inverse-distance weighting)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "power", "max_radius", "convention"))
def scattered_idw(grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference"):
    """k-nearest masked IDW in index space; weights 1/(d^p + eps).

    Not in the C++ reference (it is the BASELINE.json north-star kernel); the
    distance convention matches the fallback search so IDW(k=4, p=0) equals the
    reference's fallback average.
    """
    cfg = IDWConfig(k=k, power=power, max_radius=max_radius)
    x, y, oob = _normalize(grid, lons, lats)
    ci = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, grid.num_lon - 1)
    cj = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, grid.num_lat - 1)
    sel = window_select(grid, x, y, ci, cj, k=cfg.k, max_radius=cfg.max_radius, convention=convention)
    w = jnp.where(
        sel["slot_ok"],
        1.0 / (jnp.power(sel["d2"], cfg.power / 2.0) + cfg.eps),
        0.0,
    )
    ws = w.sum(axis=1)
    out = jnp.where(ws > 0, (w * sel["val"]).sum(axis=1) / jnp.maximum(ws, cfg.eps), jnp.nan)
    return jnp.where(oob, jnp.nan, out)
