"""Scattered-data -> grid interpolation (rebuild of the Python prototype
pipeline, code/test_interpolation.py + code/main.py).

The prototype samples ~1% of a GEBCO tile and re-predicts the full grid with
scipy ``griddata`` (Delaunay linear/cubic) and PyKrige moving-window ordinary
kriging (n_closest_points=50, backend='loop').  Spatial trees and Delaunay
triangulations don't map to matrix units; the reformulation here is tiled
brute-force distance matrices (one matmul per tile pair) with streaming top-k
merge, then per-target models over the k neighbors:

- idw_knn      — inverse-distance weighting (griddata-'linear'-class accuracy)
- linear_knn   — weighted local plane fit (closer analog of Delaunay linear)
- kriging_knn  — moving-window ordinary kriging with a fitted variogram
                 (PyKrige equivalent; batched (k+1)x(k+1) solves)
- fit_variogram_scattered — empirical semivariance from sampled point pairs +
                 the shared exponential fitter

All distances are Euclidean in (lon, lat) degrees, like the reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .variogram import fit_best_model, fit_model, variogram_model


def _pairwise_d2(a, b):
    """Squared distances (|A|^2 + |B|^2 - 2 A.B) — one matmul does the A.B term.
    a: (n, 2), b: (m, 2) -> (n, m).

    Callers MUST center coordinates first: with raw geographic coords the
    |A|^2 terms (~5e3 for lon ~ -73) swamp the ~1e-4 squared distances of
    interest below f32 resolution (catastrophic cancellation).

    precision=HIGHEST is load-bearing: a reduced-precision f32 matmul
    (TF32's 10-bit mantissa on a GPU) puts ~1e-3 absolute error on the A.B
    term (coords ~1 after centering) — larger than the ~1e-4 squared
    distances being computed, which silently scrambles neighbor selection
    on the device (CPU tests never see it)."""
    aa = jnp.sum(a * a, axis=1, keepdims=True)
    bb = jnp.sum(b * b, axis=1, keepdims=True)
    ab = jnp.dot(a, b.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(aa + bb.T - 2.0 * ab, 0.0)


@partial(jax.jit, static_argnames=("k", "pt_chunk"))
def knn_search(targets_xy, points_xy, *, k: int, pt_chunk: int = 8192):
    """Streaming k-nearest-neighbor search: (N, k) squared distances + indices.

    Point set is processed in chunks; a running top-k is merged per chunk so
    memory is O(N * (k + chunk)) regardless of point count.
    """
    n = targets_xy.shape[0]
    m = points_xy.shape[0]
    # translate to the point-cloud centroid so squared distances survive f32
    center = jnp.mean(points_xy, axis=0, keepdims=True)
    targets_xy = targets_xy - center
    points_xy = points_xy - center
    pad = (-m) % pt_chunk
    pts = jnp.pad(points_xy, ((0, pad), (0, 0)), constant_values=jnp.inf)
    n_chunks = (m + pad) // pt_chunk

    def body(carry, c):
        best_d2, best_idx = carry
        blk = jax.lax.dynamic_slice(
            pts, (c * pt_chunk, jnp.zeros((), c.dtype)), (pt_chunk, 2)
        )
        d2 = _pairwise_d2(targets_xy, blk)  # (n, chunk); padded pts -> inf/nan
        d2 = jnp.where(jnp.isfinite(d2), d2, jnp.inf)
        idx = c * pt_chunk + jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        cat_d2 = jnp.concatenate([best_d2, d2], axis=1)
        cat_idx = jnp.concatenate([best_idx, idx], axis=1)
        neg, sel = jax.lax.top_k(-cat_d2, k)
        return (-neg, jnp.take_along_axis(cat_idx, sel, axis=1)), None

    init = (
        jnp.full((n, k), jnp.inf, targets_xy.dtype),
        jnp.full((n, k), -1, jnp.int32),
    )
    (d2, idx), _ = jax.lax.scan(body, init, jnp.arange(n_chunks, dtype=jnp.int32))
    return d2, idx


@partial(jax.jit, static_argnames=("k", "power"))
def _idw_from_knn(d2, vals_k, *, k: int, power: float = 2.0, eps: float = 1e-12):
    w = 1.0 / (d2 ** (power / 2.0) + eps)
    return jnp.sum(w * vals_k, axis=1) / jnp.sum(w, axis=1)


def idw_knn(points_xy, points_val, targets_xy, *, k: int = 50, power: float = 2.0):
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    vals_k = jnp.take(points_val, jnp.clip(idx, 0, None))
    return _idw_from_knn(d2, vals_k, k=k, power=power)


@partial(jax.jit, static_argnames=("k", "alpha_min", "alpha_max"))
def _aidw_from_knn(d2, vals_k, area_per_point, *, k: int, alpha_min: float = 1.0, alpha_max: float = 5.0, eps: float = 1e-12):
    """Adaptive-power IDW weights (Lu & Wong 2008; the retrieved GPU-AIDW
    literature: arxiv 1511.02186 / 1601.05904 accelerate exactly this).

    Per-query power: the observed mean k-NN distance over the expected
    nearest-neighbor spacing of a uniform layout (r_exp = 0.5 sqrt(A/n))
    gives a local density ratio R; sparse neighborhoods (R >> 1) get a high
    power (local spike preservation), dense ones (R << 1) a low power
    (smoothing) — mapped through the standard S-curve membership on
    normalized R in [0, 1] with clamp points 0.0/2.0.  Vectorizes as one
    exp/log per lane (no data-dependent branching)."""
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    r_obs = jnp.mean(d, axis=1)
    # expected MEAN k-NN distance under uniform (Poisson) density: E[d_j]
    # ~= sqrt(j/(pi rho)), so mean over j=1..k ~= (2/3) sqrt(k/pi) sqrt(A/n).
    # (Comparing the k-NN mean against the SINGLE-NN spacing made R ~= 3 at
    # uniform density and saturated alpha at alpha_max everywhere — the
    # 'adaptive' power never adapted.)
    r_exp = (2.0 / 3.0) * jnp.sqrt(
        k * jnp.maximum(area_per_point, 1e-30) / np.pi
    )
    R = r_obs / jnp.maximum(r_exp, 1e-30)
    # normalized density measure: 0 (very dense) .. 1 (very sparse);
    # R ~= 1 at uniform density maps to the midpoint
    mu = jnp.clip(R / 2.0, 0.0, 1.0)
    # smoothstep membership (continuous version of Lu & Wong's 5-level
    # triangular fuzzy classes)
    s = mu * mu * (3.0 - 2.0 * mu)
    alpha = alpha_min + (alpha_max - alpha_min) * s  # (n,)
    # scale-invariant weights: normalize distances per query before the
    # power so the absolute eps cannot swamp d^alpha at small coordinate
    # scales (degree units: one GEBCO cell ~ 0.004, 0.004^5 ~ eps)
    dn = d / jnp.maximum(r_obs[:, None], 1e-30)
    w = 1.0 / (jnp.exp(alpha[:, None] * jnp.log(jnp.maximum(dn, 1e-30))) + eps)
    return jnp.sum(w * vals_k, axis=1) / jnp.sum(w, axis=1)


def adaptive_idw_knn(points_xy, points_val, targets_xy, *, k: int = 16, alpha_min: float = 1.0, alpha_max: float = 5.0):
    """Adaptive IDW (AIDW): per-query power from local sampling density."""
    points_xy = jnp.asarray(points_xy)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    vals_k = jnp.take(jnp.asarray(points_val), jnp.clip(idx, 0, None))
    span = jnp.max(points_xy, axis=0) - jnp.min(points_xy, axis=0)
    area_per_point = (span[0] * span[1]) / points_xy.shape[0]
    return _aidw_from_knn(
        d2, vals_k, area_per_point, k=k, alpha_min=alpha_min, alpha_max=alpha_max
    )


@partial(jax.jit, static_argnames=("k",))
def _plane_coefs(d2, xy_k, vals_k, targets_xy, *, k: int):
    """Weighted least-squares plane z = a x + b y + c over the k neighbors in
    target-centered coordinates (Gaussian distance weights scaled to the kth
    neighbor).  Returns (coef (n, 3), rel (n, k, 2))."""
    # pad lanes (kNN found < k points: d2=+inf) get weight 0; without the
    # mask, scale=inf makes inf/inf=NaN weights that poison the normal
    # equations for every query with any pad lane
    ok = jnp.isfinite(d2)
    d2s = jnp.where(ok, d2, 0.0)
    scale = jnp.maximum(jnp.max(d2s, axis=1, keepdims=True), 1e-12)
    w = jnp.where(ok, jnp.exp(-d2s / scale), 0.0)  # (n, k)
    rel = xy_k - targets_xy[:, None, :]  # center coords at the target
    X = jnp.concatenate([rel, jnp.ones_like(rel[..., :1])], axis=-1)  # (n,k,3)
    Xw = X * w[..., None]
    A = jnp.einsum("nki,nkj->nij", Xw, X, precision=jax.lax.Precision.HIGHEST)
    b = jnp.einsum("nki,nk->ni", Xw, vals_k, precision=jax.lax.Precision.HIGHEST)
    A = A + 1e-8 * jnp.eye(3, dtype=A.dtype)
    coef = jnp.linalg.solve(A, b[..., None])[..., 0]
    return coef, rel


def _plane_fit(d2, xy_k, vals_k, targets_xy, *, k: int):
    coef, _ = _plane_coefs(d2, xy_k, vals_k, targets_xy, k=k)
    return coef[:, 2]  # plane value at rel=(0,0)


def linear_knn(points_xy, points_val, targets_xy, *, k: int = 12):
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    idxc = jnp.clip(idx, 0, None)
    vals_k = jnp.take(points_val, idxc)
    xy_k = jnp.take(points_xy, idxc, axis=0)
    return _plane_fit(d2, xy_k, vals_k, targets_xy, k=k)


@partial(jax.jit, static_argnames=("k", "model", "with_variance"))
def _ok_from_knn(d2, xy_k, vals_k, targets_xy, vparams, *, k: int, model: str = "exponential", with_variance: bool = False):
    """Moving-window ordinary kriging over the k nearest neighbors.

    The GAUSSIAN model solves in COVARIANCE form with a Cholesky
    factorization: C(h) = (nugget + sill) - gamma(h) is a positive-definite
    kernel block, and the Lagrange constraint reduces to two triangular
    solves (w = v + lam u with u = C^-1 1, v = C^-1 c0).  The indefinite
    (k+1)-square variogram form is catastrophically ill-conditioned for this
    very smooth kernel — measured on a 1200-point synthetic: variogram-form
    RMSE 2.1-38 (erratic across jitter choices, even in f64) vs
    covariance-form 0.19-0.27 across FOUR decades of diagonal
    regularization; the 1e-3 floor is the center of that plateau
    (docs/NEXTSTEPS.md round-2 item 8).

    Exponential/spherical/linear keep the normalized variogram-form solve:
    they are well-conditioned there, and the covariance form degrades in the
    fitted large-range (trend-dominated) regime where total-sill dwarfs the
    in-window variation (measured: fitted exponential RMSE 0.38 variogram
    form vs 1.4 covariance form on the same synthetic).
    """
    n = d2.shape[0]
    dt = d2.dtype
    # pad lanes (kNN found < k points: idx=-1 clipped to 0, d2=+inf) must not
    # enter the system as phantom duplicates of point 0 — they get weight 0
    # via identity rows/cols (variogram form) or zeroed ones/c0 entries
    # (covariance form).  Before this mask, only the diagonal jitter kept the
    # duplicated-row solve alive and results silently degraded (ADVICE r2).
    ok = jnp.isfinite(d2)  # (n, k)
    okf = ok.astype(dt)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    dx = xy_k[:, :, None, 0] - xy_k[:, None, :, 0]
    dy = xy_k[:, :, None, 1] - xy_k[:, None, :, 1]
    vf = lambda h: variogram_model(h, vparams, model)
    h_kk = jnp.sqrt(dx * dx + dy * dy)
    h_t = jnp.sqrt(jnp.where(ok, d2, 1.0))  # pad: any finite value, masked out
    if model != "gaussian":
        # Ordinary-kriging weights are invariant to scaling gamma (only the
        # Lagrange multiplier rescales), so normalize the system to O(1):
        # raw gammas reach ~1e5+ for trend-dominated fields, which wrecks
        # the f32 (k+1)x(k+1) solve against the all-ones Lagrange row.
        scale = vf(jnp.sqrt(jnp.maximum(jnp.max(jnp.where(ok, d2, 0.0)), 1e-12)))
        G = jnp.where(pair_ok, vf(h_kk) / scale, 0.0)  # (n,k,k)
        A = jnp.zeros((n, k + 1, k + 1), dt)
        A = A.at[:, :k, :k].set(G)
        A = A.at[:, :k, k].set(okf)
        A = A.at[:, k, :k].set(okf)
        rhs = jnp.concatenate([okf * vf(h_t) / scale, jnp.ones((n, 1), dt)], axis=1)
        # valid lanes: conditioning jitter; pad lanes: unit diagonal so the
        # decoupled row solves to exactly w_i = 0
        diag = jnp.where(ok, jnp.asarray(1e-4, dt), jnp.asarray(1.0, dt))
        A = A.at[:, :k, :k].add(diag[:, :, None] * jnp.eye(k, dtype=dt))
        w = jnp.linalg.solve(A, rhs[..., None])[..., 0]  # (n, k+1)
        pred = jnp.sum(w[:, :k] * vals_k * okf, axis=1)
        pred = jnp.where(ok.any(axis=1), pred, jnp.nan)
        if not with_variance:
            return pred
        # sigma^2 = sum_i w_i gamma_i0 + mu; the system was scaled by
        # 'scale' (weights invariant, mu' = mu/scale)
        var = jnp.sum(w[:, :k] * okf * vf(h_t), axis=1) + w[:, k] * scale
        return pred, jnp.maximum(var, 0.0)

    total = vparams[0] + vparams[1]  # gamma(inf) = nugget + sill
    C = jnp.where(pair_ok, (total - vf(h_kk)) / total, 0.0)
    c0 = okf * (total - vf(h_t)) / total
    # valid lanes: PD jitter; pad lanes: unit diagonal (decoupled, u_i=v_i=0
    # because their ones/c0 entries are zeroed below)
    diag = jnp.where(ok, jnp.asarray(1e-3, dt), jnp.asarray(1.0, dt))
    C = C + diag[:, :, None] * jnp.eye(k, dtype=dt)
    L = jnp.linalg.cholesky(C)
    ones = okf[..., None]
    u = jax.scipy.linalg.cho_solve((L, True), ones)
    v = jax.scipy.linalg.cho_solve((L, True), c0[..., None])
    lam = (1.0 - jnp.sum(v, axis=(1, 2))) / jnp.maximum(
        jnp.sum(u, axis=(1, 2)), jnp.asarray(1e-30, dt)
    )
    w = (v + lam[:, None, None] * u)[..., 0]
    pred = jnp.sum(w * vals_k * okf, axis=1)
    pred = jnp.where(ok.any(axis=1), pred, jnp.nan)
    if not with_variance:
        return pred
    # variogram-form multiplier mu = +lambda: substituting gamma = ct - C
    # into the gamma system with sum w = 1 gives sum_j C_ij w_j = C_i0 + mu,
    # which is exactly the solved system C w = c0 + lam 1.  (Verified
    # numerically against a direct f64 solve of the OK system; the earlier
    # '-lam' sign underestimated extrapolation variance ~3x.)  lam is in
    # C/total units.
    var = jnp.sum(w * vf(h_t), axis=1) + lam * total
    return pred, jnp.maximum(var, 0.0)


@partial(jax.jit, static_argnames=("k", "model", "with_variance"))
def _ok_trend_from_knn(d2, xy_k, vals_k, targets_xy, vparams, *, k: int, model: str = "exponential", with_variance: bool = False):
    """Residual (trend-removed) moving-window kriging: fit the local weighted
    plane over the neighbors, krige the *residuals*, add the plane back at
    the target.  This is the standard fix for trend-dominated fields (the
    round-1 failure mode: the short-lag nugget absorbed real roughness and
    plain OK over-smoothed, RMSE 80.9 m vs plane-fit 27.8 m on US-East)."""
    coef, rel = _plane_coefs(d2, xy_k, vals_k, targets_xy, k=k)
    plane_at_nb = coef[:, None, 0] * rel[..., 0] + coef[:, None, 1] * rel[..., 1] + coef[:, None, 2]
    resid = vals_k - plane_at_nb
    out = _ok_from_knn(
        d2, xy_k, resid, targets_xy, vparams, k=k, model=model,
        with_variance=with_variance,
    )
    if with_variance:
        # residual-kriging variance (plane-fit uncertainty not included)
        pred_resid, var = out
        return coef[:, 2] + pred_resid, var
    return coef[:, 2] + out


def kriging_knn(points_xy, points_val, targets_xy, *, k: int = 50, vparams=None, model: str = "exponential", trend: str = "plane", aniso=None, return_variance: bool = False):
    """Moving-window ordinary kriging (PyKrige n_closest_points equivalent).

    model: variogram model ('exponential' | 'linear' | 'spherical' |
    'gaussian'; the prototype used PyKrige's linear).  trend='plane' kriges
    residuals about a local weighted plane (recommended; trend=None is plain
    OK, the reference prototype's configuration).

    aniso: optional (nugget, sill, rx, ry, theta) from
    variogram.fit_anisotropic / fit_variogram_scattered_aniso, or the string
    'fit' to fit it from the data — coordinates are transformed by the
    ellipse metric (variogram.anisotropy_matrix) so both the kNN search and
    the kriging system use correlation distance; vparams becomes
    (nugget, sill, 1).  Mutually exclusive with vparams.
    """
    if aniso is not None and vparams is not None:
        raise ValueError("pass either vparams or aniso, not both (aniso carries "
                         "its own (nugget, sill) and implies unit range)")
    if isinstance(aniso, str):
        if aniso != "fit":
            raise ValueError(aniso)
        aniso = tuple(
            float(v) for v in fit_variogram_scattered_aniso(
                jnp.asarray(points_xy), jnp.asarray(points_val), model=model
            )
        )
    if aniso is not None:
        from .variogram import anisotropy_matrix

        nugget, sill, rx, ry, theta = aniso
        T = jnp.asarray(
            anisotropy_matrix(float(rx), float(ry), float(theta)),
            jnp.asarray(points_xy).dtype,
        )
        points_xy = jnp.matmul(jnp.asarray(points_xy), T.T, precision=jax.lax.Precision.HIGHEST)
        targets_xy = jnp.matmul(jnp.asarray(targets_xy), T.T, precision=jax.lax.Precision.HIGHEST)
        vparams = (nugget, sill, jnp.asarray(1.0, T.dtype))
    elif vparams is None:
        vparams = fit_variogram_scattered(points_xy, points_val, model=model)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    idxc = jnp.clip(idx, 0, None)
    vals_k = jnp.take(points_val, idxc)
    xy_k = jnp.take(points_xy, idxc, axis=0)
    fn = _ok_trend_from_knn if trend == "plane" else _ok_from_knn
    return fn(
        d2, xy_k, vals_k, targets_xy, vparams, k=k, model=model,
        with_variance=return_variance,
    )


@partial(jax.jit, static_argnames=("n_bins", "max_pairs_sqrt", "short_frac"))
def _scattered_semivariance(
    points_xy, points_val, *, n_bins: int = 12, max_pairs_sqrt: int = 4096,
    short_frac: float = 0.1,
):
    """Empirical semivariance over sampled point pairs, restricted to SHORT
    lags (<= short_frac of the max pair distance): moving-window kriging only
    evaluates gamma at neighbor distances, so fitting tile-scale lags lets
    long-range trend dominate and wrecks the short-range weights."""
    m = min(points_xy.shape[0], max_pairs_sqrt)
    xy = points_xy[:m]
    xy = xy - jnp.mean(xy, axis=0, keepdims=True)
    v = points_val[:m]
    d2 = _pairwise_d2(xy, xy)
    d = jnp.sqrt(d2)
    dv = (v[:, None] - v[None, :]) ** 2
    dmax = jnp.max(jnp.where(jnp.isfinite(d), d, 0.0)) * short_frac
    edges = jnp.linspace(0.0, dmax + 1e-9, n_bins + 1)
    bins = jnp.clip(jnp.searchsorted(edges, d) - 1, 0, n_bins - 1)
    off_diag = ~jnp.eye(m, dtype=bool) & (d < dmax)
    s = jnp.zeros((n_bins,), d.dtype).at[bins].add(jnp.where(off_diag, dv, 0.0))
    c = jnp.zeros((n_bins,), d.dtype).at[bins].add(off_diag.astype(d.dtype))
    gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, gamma, c


@partial(jax.jit, static_argnames=("n_bins", "n_sectors", "max_pairs_sqrt", "short_frac"))
def _scattered_semivariance_directional(
    points_xy, points_val, *, n_bins: int = 10, n_sectors: int = 4,
    max_pairs_sqrt: int = 2048, short_frac: float = 0.1,
):
    """Directional (azimuth-sector x lag) semivariance over sampled point
    pairs — the scattered analog of variogram.empirical_variogram_directional
    (short-lag restriction as in _scattered_semivariance)."""
    m = min(points_xy.shape[0], max_pairs_sqrt)
    xy = points_xy[:m]
    xy = xy - jnp.mean(xy, axis=0, keepdims=True)
    v = points_val[:m]
    dx = xy[:, None, 0] - xy[None, :, 0]
    dy = xy[:, None, 1] - xy[None, :, 1]
    d = jnp.sqrt(dx * dx + dy * dy)
    dv = (v[:, None] - v[None, :]) ** 2
    dmax = jnp.max(jnp.where(jnp.isfinite(d), d, 0.0)) * short_frac
    edges = jnp.linspace(0.0, dmax + 1e-9, n_bins + 1)
    lag_bin = jnp.clip(jnp.searchsorted(edges, d) - 1, 0, n_bins - 1)
    ang = jnp.mod(jnp.arctan2(dy, dx), np.pi)
    sector = jnp.clip(
        jnp.floor(ang / (np.pi / n_sectors)).astype(jnp.int32), 0, n_sectors - 1
    )
    flat = sector * n_bins + lag_bin
    off_diag = ~jnp.eye(m, dtype=bool) & (d < dmax)
    n_out = n_sectors * n_bins
    s = jnp.zeros((n_out,), d.dtype).at[flat].add(jnp.where(off_diag, dv, 0.0))
    c = jnp.zeros((n_out,), d.dtype).at[flat].add(off_diag.astype(d.dtype))
    s = s.reshape(n_sectors, n_bins)
    c = c.reshape(n_sectors, n_bins)
    gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    angles = jnp.asarray((np.arange(n_sectors) + 0.5) * np.pi / n_sectors, d.dtype)
    return centers, angles, gamma, c


def fit_variogram_scattered_aniso(
    points_xy, points_val, *, n_bins: int = 10, n_sectors: int = 4,
    model: str = "exponential", iters: int = 40,
):
    """Directional semivariance + anisotropic ellipse fit for a scattered
    point cloud.  Returns (nugget, sill, rx, ry, theta) — feed straight into
    kriging_knn(aniso=...)."""
    from .variogram import fit_anisotropic

    lags, angles, gamma, counts = _scattered_semivariance_directional(
        points_xy, points_val, n_bins=n_bins, n_sectors=n_sectors
    )
    return fit_anisotropic(lags, angles, gamma, counts, model=model, iters=iters)


def fit_variogram_scattered(points_xy, points_val, *, n_bins: int = 12, model: str = "exponential"):
    """Empirical semivariance over (subsampled) point pairs + model fit
    — the PyKrige 'fit a variogram model to the data' step
    (test_interpolation.py:61-68) on the device.  model='best' fits the whole
    zoo and returns the lowest weighted-SSE winner's params (host-level
    choice); otherwise fits the named model."""
    lags, gamma, c = _scattered_semivariance(points_xy, points_val, n_bins=n_bins)
    if model == "best":
        name, params, _ = fit_best_model(lags, gamma, c)
        return name, params
    return fit_model(lags, gamma, c, model=model)


# ---------------------------------------------------------------------------
# pipeline: sample -> predict full grid (main.py / test_interpolation.py flow)
# ---------------------------------------------------------------------------

def sample_and_reconstruct(
    elev: np.ndarray,
    extent,
    *,
    subset_fraction: float = 0.01,
    method: str = "kriging",
    k: int = 50,
    seed: int = 42,
    target_chunk: int = 1 << 16,
    model: str = "exponential",
    trend: str = "plane",
    aniso: bool = False,
    density: str = "uniform",
):
    """Sample ``subset_fraction`` of the grid cells (seeded, like
    interpolate()'s df.sample(random_state=42), test_interpolation.py:49) and
    re-predict every grid cell from the samples.  Returns (pred (H, W),
    sample_mask (H, W) bool).  aniso=True (kriging only) fits a directional
    ellipse and kriges in correlation distance.

    density='strip' draws the samples non-uniformly — 10x the sampling odds
    inside the central 20% of rows (a survey-track analog: one densely
    mapped corridor, sparse context elsewhere).  This is the variable-
    density regime adaptive IDW's per-query power matching targets."""
    H, W = elev.shape
    # a chunk larger than the grid only pads (the whole grid is one chunk
    # anyway); keep it 512-aligned so the compiled shape stays friendly
    target_chunk = min(target_chunk, -(-H * W // 512) * 512)
    rng = np.random.RandomState(seed)
    n = int(H * W * subset_fraction)
    if density == "uniform":
        flat = rng.choice(H * W, size=n, replace=False)
    elif density == "strip":
        w = np.ones(H * W, np.float64)
        w.reshape(H, W)[int(0.4 * H) : int(0.6 * H)] = 10.0
        flat = rng.choice(H * W, size=n, replace=False, p=w / w.sum())
    else:
        raise ValueError(density)
    rr, cc = np.divmod(flat, W)
    lat_step, lon_step = extent.steps(H, W)
    pts_xy = np.stack(
        [extent.min_lon + cc * lon_step, extent.min_lat + rr * lat_step], axis=1
    ).astype(np.float32)
    pts_val = elev[rr, cc].astype(np.float32)

    jj, ii = np.mgrid[0:H, 0:W]
    tgt_xy = np.stack(
        [extent.min_lon + ii.ravel() * lon_step, extent.min_lat + jj.ravel() * lat_step],
        axis=1,
    ).astype(np.float32)

    fn = {
        "idw": lambda t: idw_knn(pts_xy, pts_val, t, k=k),
        "aidw": lambda t: adaptive_idw_knn(pts_xy, pts_val, t, k=min(k, 16)),
        "linear": lambda t: linear_knn(pts_xy, pts_val, t, k=min(k, 16)),
        "kriging": None,
    }[method]
    if method == "kriging":
        if aniso:
            ap = tuple(
                float(v) for v in fit_variogram_scattered_aniso(
                    jnp.asarray(pts_xy), jnp.asarray(pts_val),
                    model=model if model != "best" else "exponential",
                )
            )
            fn = lambda t: kriging_knn(
                pts_xy, pts_val, t, k=k,
                model=model if model != "best" else "exponential",
                trend=trend, aniso=ap,
            )
        else:
            fitted = fit_variogram_scattered(
                jnp.asarray(pts_xy), jnp.asarray(pts_val), model=model
            )
            if model == "best":
                model, vparams = fitted
            else:
                vparams = fitted
            fn = lambda t: kriging_knn(
                pts_xy, pts_val, t, k=k, vparams=vparams, model=model, trend=trend
            )

    out = np.empty(H * W, np.float32)
    for s in range(0, H * W, target_chunk):
        e = min(s + target_chunk, H * W)
        chunk = tgt_xy[s:e]
        if e - s < target_chunk:  # pad to keep one compiled shape
            chunk = np.concatenate(
                [chunk, np.broadcast_to(chunk[:1], (target_chunk - (e - s), 2))]
            )
        out[s:e] = np.asarray(fn(jnp.asarray(chunk)))[: e - s]
    mask = np.zeros((H, W), bool)
    mask[rr, cc] = True
    return out.reshape(H, W), mask
