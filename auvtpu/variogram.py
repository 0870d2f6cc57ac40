"""Variogram estimation and fitting — the framework's 'model fitting' step.

The reference hardcodes the exponential variogram (nugget 1, sill 100,
range 10; GridH.cpp:371-376), while its Python prototype fits a linear
variogram via PyKrige (test_interpolation.py:61-68).  Here both become
first-class and jittable:

- :func:`empirical_variogram` computes the isotropic empirical semivariance of
  a masked grid from shifted-plane pair sums (no gathers; Matheron estimator
  binned by integer lag distance),
- :func:`fit_exponential` fits (nugget, sill, range) by fixed-iteration
  Gauss-Newton on the exponential model — compiler-friendly (static loop),
  differentiable, and shardable (the pair sums are plane reductions that
  ``psum`` cleanly across a row-sharded mesh).

Together with a kriging fill these form the framework's train->predict step
(see __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .grid import RegularGrid


@lru_cache(maxsize=8)
def _lag_offsets(max_lag: int):
    """Unique half-plane offsets (dy, dx) with 0 < ||.|| <= max_lag.

    Half-plane (dy > 0) | (dy == 0 & dx > 0) counts each pair once."""
    offs = []
    for dy in range(0, max_lag + 1):
        for dx in range(-max_lag, max_lag + 1):
            if dy == 0 and dx <= 0:
                continue
            h = np.hypot(dx, dy)
            if 0 < h <= max_lag:
                offs.append((dy, dx, h))
    arr = np.asarray(offs, dtype=np.float64)
    return (
        arr[:, 0].astype(np.int32),
        arr[:, 1].astype(np.int32),
        arr[:, 2].astype(np.float32),
    )


def _bin_table(max_lag: int, n_bins: int):
    dys, dxs, hs = _lag_offsets(max_lag)
    edges = np.linspace(0.0, float(max_lag), n_bins + 1)
    bin_of = np.clip(np.digitize(np.asarray(hs), edges) - 1, 0, n_bins - 1).astype(np.int32)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return dys, dxs, bin_of, centers


def _pair_sums_binned(elev, valid, n_base_rows: int, dys, dxs, bin_of, n_out: int, max_lag: int):
    """Shared shifted-plane pair accumulator over an arbitrary offset->bin
    table (isotropic lag bins or (sector, lag) flat bins)."""
    H = n_base_rows
    W = elev.shape[1]
    R = max_lag
    pe = jnp.pad(elev, ((0, 0), (R, R)))
    pv = jnp.pad(valid, ((0, 0), (R, R)))
    base_e = elev[:H]
    base_v = valid[:H]

    def body(carry, xs):
        s, c = carry
        dy, dx, b = xs
        zv = jax.lax.dynamic_slice(pe, (dy, R + dx), (H, W))
        mv = jax.lax.dynamic_slice(pv, (dy, R + dx), (H, W))
        both = base_v * mv
        d = (base_e - zv) * both
        s = s.at[b].add(jnp.sum(d * d))
        c = c.at[b].add(jnp.sum(both))
        return (s, c), None

    # derive the carry init FROM the (possibly device-varying) planes: under
    # shard_map a plain jnp.zeros is 'invariant' while the body's outputs are
    # 'varying' over the mesh axis, and scan rejects the carry type mismatch
    zero = jnp.broadcast_to(base_v[0, 0] * 0, (n_out,)).astype(elev.dtype)
    (s, c), _ = jax.lax.scan(
        body, (zero, zero), (jnp.asarray(dys), jnp.asarray(dxs), jnp.asarray(bin_of))
    )
    return s, c


def pair_sums(elev, valid, n_base_rows: int, *, max_lag: int = 10, n_bins: int = 10):
    """Binned (sum of squared diffs, pair counts) with base cells in the first
    ``n_base_rows`` rows and half-plane offsets (dy >= 0), so every pair is
    counted exactly once even when the plane is a row band of a larger grid
    whose bottom ``max_lag`` rows are the next band's halo.

    elev/valid: (n_base_rows + max_lag, W).  Returns (s (n_bins,), c (n_bins,)).
    """
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    return _pair_sums_binned(elev, valid, n_base_rows, dys, dxs, bin_of, n_bins, max_lag)


@partial(jax.jit, static_argnames=("max_lag", "n_bins"))
def empirical_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10):
    """Binned Matheron semivariance of the valid cells.

    Returns (lag_centers (n_bins,), gamma (n_bins,), counts (n_bins,)) with
    lags in index space (convert with grid steps for geographic units).
    gamma(h) = sum (z_i - z_j)^2 / (2 N_h) over pairs at |h| in the bin.
    """
    H, W = grid.shape
    R = max_lag
    elev = jnp.pad(grid.elev, ((0, R), (0, 0)))
    valid = jnp.pad(grid.valid, ((0, R), (0, 0)))
    s, c = pair_sums(elev, valid, H, max_lag=max_lag, n_bins=n_bins)
    gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
    _, _, _, centers = _bin_table(max_lag, n_bins)
    return jnp.asarray(centers, grid.dtype), gamma, c


# ---------------------------------------------------------------------------
# directional / anisotropic variograms
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _sector_bin_table(max_lag: int, n_bins: int, n_sectors: int, aspect: float = 1.0):
    """Offset -> (sector, lag-bin) flat table.  Half-plane offsets cover
    azimuths [0, pi); sector s spans [s, s+1) * pi/n_sectors.

    ``aspect`` = lat_step/lon_step converts index offsets to PHYSICAL
    geometry (dy rows are ``aspect`` times as long as dx columns): without
    it, any grid whose steps differ reports a pure aspect artifact as
    anisotropy (measured: every GEBCO tile 'fit' rx/ry = 2.00, theta = 0 —
    exactly the step ratio, not geology).  Lags are in lon-step units.
    """
    dys, dxs, _ = _lag_offsets(max_lag)
    dyp = dys.astype(np.float64) * aspect
    dxp = dxs.astype(np.float64)
    hs = np.hypot(dxp, dyp)
    hmax = float(max_lag) * max(1.0, aspect)
    edges = np.linspace(0.0, hmax, n_bins + 1)
    bin_of = np.clip(np.digitize(hs, edges) - 1, 0, n_bins - 1)
    ang = np.mod(np.arctan2(dyp, dxp), np.pi)
    sector_of = np.clip(
        np.floor(ang / (np.pi / n_sectors)).astype(np.int64), 0, n_sectors - 1
    )
    flat = (sector_of * n_bins + bin_of).astype(np.int32)
    centers = 0.5 * (edges[:-1] + edges[1:])
    angles = (np.arange(n_sectors) + 0.5) * np.pi / n_sectors
    return dys, dxs, flat, centers, angles


@partial(jax.jit, static_argnames=("max_lag", "n_bins", "n_sectors", "aspect"))
def empirical_variogram_directional(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, n_sectors: int = 4, aspect: float = 1.0):
    """Directional Matheron semivariance: gamma binned by (azimuth sector,
    lag).  Returns (lag_centers (n_bins,), sector_angles (n_sectors,),
    gamma (n_sectors, n_bins), counts (n_sectors, n_bins)), lags in
    lon-step units under the physical ``aspect`` = lat_step/lon_step (1.0 =
    index space).  The isotropic :func:`empirical_variogram` is the
    n_sectors=1 marginal.  (The reference is isotropic-only —
    GridH.cpp:371-376 — this is the standard geostatistics extension for
    sheet-flow / channelized bathymetry where along- and across-strike
    correlation lengths differ.)
    """
    H, W = grid.shape
    R = max_lag
    dys, dxs, flat, centers, angles = _sector_bin_table(
        max_lag, n_bins, n_sectors, aspect
    )
    elev = jnp.pad(grid.elev, ((0, R), (0, 0)))
    valid = jnp.pad(grid.valid, ((0, R), (0, 0)))
    s, c = _pair_sums_binned(elev, valid, H, dys, dxs, flat, n_sectors * n_bins, R)
    s = s.reshape(n_sectors, n_bins)
    c = c.reshape(n_sectors, n_bins)
    gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
    return (
        jnp.asarray(centers, grid.dtype),
        jnp.asarray(angles, grid.dtype),
        gamma,
        c,
    )


def _aniso_h(h, ang, rx, ry, theta):
    """Reduced (dimensionless) lag: the ellipse metric ||T h_vec|| with
    principal ranges (rx, ry) and major-axis azimuth theta."""
    ca = jnp.cos(ang - theta)
    sa = jnp.sin(ang - theta)
    return h * jnp.sqrt((ca / rx) ** 2 + (sa / ry) ** 2)


@partial(jax.jit, static_argnames=("iters", "model"))
def fit_anisotropic(lags, angles, gamma, counts, *, model: str = "exponential", iters: int = 40, init=None):
    """Weighted Gauss-Newton fit of (nugget, sill, rx, ry, theta) on the
    directional empirical variogram.  gamma(h, phi) = iso_model(h', 1) with
    h' the ellipse-reduced lag; ranges are fit in log space (positive),
    theta free (period pi — use :func:`normalize_aniso` for a canonical
    form).  Returns five traced scalars."""
    dt = gamma.dtype
    S, B = gamma.shape
    hh = jnp.broadcast_to(lags[None, :], (S, B)).reshape(-1)
    aa = jnp.broadcast_to(angles[:, None], (S, B)).reshape(-1)
    gg = gamma.reshape(-1)
    w = counts.reshape(-1)
    w = w / jnp.maximum(w.sum(), 1.0)
    if init is None:
        sill0 = jnp.maximum(jnp.max(gg), 1e-3)
        maxlag = jnp.maximum(jnp.max(lags), 1e-9)
        init_log = jnp.log(
            jnp.stack([0.01 * sill0, sill0, maxlag / 3.0, maxlag / 6.0]).astype(dt)
        )
        # the SSE landscape is multimodal in theta (period pi): multi-start
        # four orientations and keep the best converged fit
        theta0s = jnp.asarray([0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4], dt)
    else:
        nug0, sill0, rx0, ry0, th0 = init
        init_log = jnp.log(jnp.stack([nug0, sill0, rx0, ry0]).astype(dt))
        theta0s = jnp.asarray(th0, dt).reshape(1)

    sw = jnp.sqrt(w)

    def resid(tv):
        nugget, sill, rx, ry = jnp.exp(tv[0]), jnp.exp(tv[1]), jnp.exp(tv[2]), jnp.exp(tv[3])
        hp = _aniso_h(hh, aa, rx, ry, tv[4])
        return (variogram_model(hp, (nugget, sill, jnp.asarray(1.0, dt)), model) - gg) * sw

    jac = jax.jacfwd(resid)

    # Levenberg-Marquardt with DIAGONAL (Marquardt) damping: the plain-GN
    # fixed damping stalled at real-data scale (gamma ~ 2e4, lags ~ 0.04:
    # every step was rejected and the 'fit' returned its init verbatim —
    # caught because two different GEBCO tiles both 'fit' rx/ry at exactly
    # the init ratio).  diag(A) scaling makes the step scale-invariant and
    # the accept/reject lambda schedule recovers from bad curvature.
    # ranges are only identified within the observed lag support; outside it
    # the SSE optimum of a misspecified model is degenerate (measured: a
    # hole-effect sinusoid drives rx -> 5e8 'optimally' and kriging falls
    # apart).  Box-constrain log-ranges to [hmax/50, 3 hmax].
    hmax = jnp.maximum(jnp.max(lags), 1e-9)
    lr_lo = jnp.log(hmax / 50.0)
    lr_hi = jnp.log(3.0 * hmax)

    def clamp(tv):
        return jnp.concatenate([tv[:2], jnp.clip(tv[2:4], lr_lo, lr_hi), tv[4:5]])

    def step(carry, _):
        tv, lam = carry
        r = resid(tv)
        J = jac(tv)
        A = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
        g = jnp.matmul(J.T, r, precision=jax.lax.Precision.HIGHEST)
        dA = jnp.diag(jnp.maximum(jnp.diag(A), 1e-12))
        delta = jnp.linalg.solve(A + lam * dA, g)
        delta = jnp.clip(delta, -1.0, 1.0)
        new = clamp(tv - delta)
        better = jnp.sum(resid(new) ** 2) <= jnp.sum(r**2)
        tv = jnp.where(better, new, tv)
        lam = jnp.where(better, jnp.maximum(lam / 3.0, 1e-9), jnp.minimum(lam * 10.0, 1e9))
        return (tv, lam), None

    def fit_from(theta0):
        tv0 = jnp.concatenate([init_log, theta0[None]])
        (tv, _), _ = jax.lax.scan(step, (tv0, jnp.asarray(1e-3, dt)), None, length=iters)
        return tv, jnp.sum(resid(tv) ** 2)

    tvs, sses = jax.vmap(fit_from)(theta0s)
    tv = tvs[jnp.argmin(sses)]
    return (
        jnp.exp(tv[0]), jnp.exp(tv[1]), jnp.exp(tv[2]), jnp.exp(tv[3]), tv[4],
    )


def normalize_aniso(params):
    """Canonical host-side form: rx >= ry (major axis first) and theta in
    [0, pi).  params = (nugget, sill, rx, ry, theta) as floats."""
    nugget, sill, rx, ry, theta = (float(v) for v in params)
    if ry > rx:
        rx, ry = ry, rx
        theta += np.pi / 2.0
    return nugget, sill, rx, ry, float(np.mod(theta, np.pi))


def anisotropy_matrix(rx, ry, theta, dtype=np.float64):
    """2x2 T with ||T h_vec|| = reduced lag: rotate azimuth theta onto +x,
    then scale axes by (1/rx, 1/ry).  Transforming coordinates by T turns
    anisotropic kriging into isotropic kriging with unit range (pass
    vparams=(nugget, sill, 1.0))."""
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c / rx, s / rx], [-s / ry, c / ry]], dtype)


def fit_variogram_directional(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, n_sectors: int = 4, model: str = "exponential", iters: int = 40):
    """Convenience: directional empirical variogram + anisotropic fit in
    PHYSICAL geometry (per-axis grid steps, so a non-square cell cannot
    masquerade as anisotropy).  Returns (nugget, sill, rx, ry, theta)
    traced scalars, ranges in degrees, theta measured from the lon axis."""
    aspect = float(round(abs(grid.lat_step) / max(abs(grid.lon_step), 1e-300), 6))
    lags, angles, gamma, counts = empirical_variogram_directional(
        grid, max_lag=max_lag, n_bins=n_bins, n_sectors=n_sectors, aspect=aspect
    )
    step = abs(grid.lon_step)
    return fit_anisotropic(lags * step, angles, gamma, counts, model=model, iters=iters)


def exponential_model(h, params):
    nugget, sill, rng = params
    return nugget + sill * (1.0 - jnp.exp(-h / jnp.maximum(rng, 1e-6)))


def variogram_model(h, params, model: str = "exponential"):
    """Model zoo (static ``model`` string, jit-friendly).

    params is always (nugget, p1, p2):
      exponential: gamma = nugget + p1 (1 - e^(-h/p2))    (the reference's
                   hardcoded model, GridH.cpp:371-376)
      linear:      gamma = nugget + p1 h                  (the prototype's
                   PyKrige model, test_interpolation.py:61-68; p2 unused)
      spherical:   gamma = nugget + p1 (1.5 m - 0.5 m^3), m = min(h/p2, 1)
      gaussian:    gamma = nugget + p1 (1 - e^(-(h/p2)^2))
    """
    nugget, p1, p2 = params
    p2 = jnp.maximum(p2, 1e-6)
    if model == "exponential":
        return nugget + p1 * (1.0 - jnp.exp(-h / p2))
    if model == "linear":
        return nugget + p1 * h
    if model == "spherical":
        m = jnp.minimum(h / p2, 1.0)
        return nugget + p1 * (1.5 * m - 0.5 * m**3)
    if model == "gaussian":
        return nugget + p1 * (1.0 - jnp.exp(-((h / p2) ** 2)))
    raise ValueError(model)


@partial(jax.jit, static_argnames=("iters", "model"))
def fit_model(lags, gamma, counts, *, model: str = "exponential", iters: int = 30, init=None):
    """Weighted Gauss-Newton fit of a variogram model in log-parameter space
    (positivity by construction, no boundary stalls: a trend-dominated gamma
    drives the exponential's range large, recovering the linear-variogram
    regime the reference prototype used via PyKrige).

    Fixed iteration count and Levenberg damping keep it jit/scan-friendly;
    weights are the pair counts (more pairs -> more trust).  Returns
    (nugget, p1, p2) as traced scalars (see :func:`variogram_model`).
    """
    dt = gamma.dtype
    w = counts / jnp.maximum(counts.sum(), 1.0)
    if init is None:
        # data-driven init: sill ~ max gamma, range ~ a third of max lag,
        # nugget ~ 1% of sill (avoids scale mismatch across datasets)
        sill0 = jnp.maximum(jnp.max(gamma), 1e-3)
        maxlag = jnp.maximum(jnp.max(lags), 1e-9)
        p1_0 = sill0 / maxlag if model == "linear" else sill0
        init = jnp.stack([0.01 * sill0, p1_0, maxlag / 3.0]).astype(dt)
    else:
        init = jnp.asarray(init, dt)
    theta = jnp.log(init)

    def resid(theta):
        return (variogram_model(lags, jnp.exp(theta), model) - gamma) * jnp.sqrt(w)

    jac = jax.jacfwd(resid)

    def step(theta, _):
        r = resid(theta)
        J = jac(theta)
        A = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
        damp = 1e-4 * jnp.maximum(jnp.trace(A) / 3.0, 1e-12)
        g = jnp.matmul(J.T, r, precision=jax.lax.Precision.HIGHEST)
        delta = jnp.linalg.solve(A + damp * jnp.eye(3, dtype=dt), g)
        # trust region on the log step keeps early iterations stable
        delta = jnp.clip(delta, -2.0, 2.0)
        new = theta - delta
        better = jnp.sum(resid(new) ** 2) <= jnp.sum(r**2)
        theta = jnp.where(better, new, theta)
        return theta, None

    theta, _ = jax.lax.scan(step, theta, None, length=iters)
    p = jnp.exp(theta)
    return p[0], p[1], p[2]


def fit_exponential(lags, gamma, counts, *, iters: int = 30, init=None):
    """Exponential-model fit (the reference's model); see :func:`fit_model`."""
    return fit_model(lags, gamma, counts, model="exponential", iters=iters, init=init)


def fit_best_model(lags, gamma, counts, *, models=("exponential", "linear", "spherical", "gaussian"), iters: int = 30):
    """Fit every candidate model and pick the lowest weighted SSE.

    Returns (model_name, (nugget, p1, p2), sse) with params as numpy floats —
    model choice is data-dependent, so this is a host-level step (one scalar
    readback per candidate), like PyKrige's per-dataset model argument.
    """
    best = None
    w = np.asarray(counts, np.float64)
    w = w / max(w.sum(), 1.0)
    g = np.asarray(gamma, np.float64)
    h = np.asarray(lags, np.float64)
    for m in models:
        p = tuple(float(v) for v in fit_model(lags, gamma, counts, model=m, iters=iters))
        r = np.asarray(variogram_model(jnp.asarray(h), p, m), np.float64) - g
        sse = float((w * r * r).sum())
        if best is None or sse < best[2]:
            best = (m, p, sse)
    return best


def fit_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, iters: int = 25):
    """Convenience: empirical variogram + exponential fit, lags in index
    space scaled to degrees by the mean grid step (isotropic approximation,
    matching the reference's isotropic variogram use)."""
    lags, gamma, counts = empirical_variogram(grid, max_lag=max_lag, n_bins=n_bins)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    return fit_exponential(lags * step, gamma, counts, iters=iters)


def pair_sums_2d(elev, valid, n_base_rows: int, n_base_cols: int, *, max_lag: int = 10, n_bins: int = 10):
    """pair_sums for a 2-D block of a larger grid.

    The half-plane offsets have dy >= 0 but dx in [-max_lag, max_lag], so a
    block that does NOT own full rows needs column halos on BOTH sides (the
    1-D row-band case gets away with zero column padding only because its
    left/right edges are true global edges).  Expected layout::

        elev/valid: (n_base_rows + max_lag, n_base_cols + 2*max_lag)
        base cells: [:n_base_rows, max_lag : max_lag + n_base_cols]

    with the bottom strip (and bottom-right/bottom-left corners) supplied by
    the neighbors' halos; pairs are still counted exactly once globally (the
    block owning the pair's FIRST point counts it).
    """
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    H, Wb, R = n_base_rows, n_base_cols, max_lag
    base_e = elev[:H, R : R + Wb]
    base_v = valid[:H, R : R + Wb]

    def body(carry, xs):
        s, c = carry
        dy, dx, b = xs
        zv = jax.lax.dynamic_slice(elev, (dy, R + dx), (H, Wb))
        mv = jax.lax.dynamic_slice(valid, (dy, R + dx), (H, Wb))
        both = base_v * mv
        d = (base_e - zv) * both
        s = s.at[b].add(jnp.sum(d * d))
        c = c.at[b].add(jnp.sum(both))
        return (s, c), None

    zero = jnp.broadcast_to(base_v[0, 0] * 0, (n_bins,)).astype(elev.dtype)
    (s, c), _ = jax.lax.scan(
        body, (zero, zero), (jnp.asarray(dys), jnp.asarray(dxs), jnp.asarray(bin_of))
    )
    return s, c
