"""Spatially-sharded dense fills: 1-D row-band and 2-D block grid sharding
with multi-hop halo exchange.

The dense fill ops (auvtpu.ops.dense) only look max_radius rows/cols away, so
a sharded grid needs just a max_radius-deep halo from each neighbor.  Halos
move between devices via ``jax.lax.ppermute`` inside ``shard_map`` (devices with no
neighbor receive zeros — exactly the zero-validity padding the global edges
want), each block runs the unchanged single-device fill on its halo-extended
block, and the halo is sliced off.  This is the stencil analog of sequence
parallelism and the scale-up path for grids larger than one device's memory
(SURVEY.md §5 'Long-context').

Two generalizations over the round-1 row-band version:

- **multi-hop halos**: a halo deeper than the local band is assembled by
  iterated one-hop ppermutes (hop h pulls the needed rows from the band h
  away), so blocks may be *shorter than max_radius* — no band-height floor;
- **2-D meshes**: blocks shard over (rows x cols); halos exchange along the
  row axis first, then the column axis on the *row-extended* block, which
  carries the corner cells without a separate diagonal exchange.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..grid import RegularGrid
from ..ops import dense as dense_ops
from ..ops.backend import pick as pick_backend


def _neighbor_perms(n: int):
    fwd = [(i, i + 1) for i in range(n - 1)]  # send downward (to next band)
    bwd = [(i + 1, i) for i in range(n - 1)]  # send upward (to previous band)
    return fwd, bwd


def _collect_halo(x, R: int, axis_name: str, n: int, side: str, axis: int = 0):
    """R-deep halo along ``axis`` assembled from up to ceil(R/blk) neighbor
    hops over the named mesh axis.

    side='before': the R rows/cols immediately before this block (from
    preceding blocks); side='after': immediately after.  Blocks past the mesh
    edge contribute zeros (= invalid cells, the global-edge convention).
    """
    x = jnp.moveaxis(x, axis, 0)
    blk = x.shape[0]
    hops = -(-R // blk)
    parts = []
    for h in range(1, hops + 1):
        take = min(blk, R - (h - 1) * blk)
        if side == "before":
            sl = x[blk - take :]  # trailing rows of the block h before mine
            perm = [(j, j + h) for j in range(n - h)]
        else:
            sl = x[:take]  # leading rows of the block h after mine
            perm = [(j + h, j) for j in range(n - h)]
        parts.append(jax.lax.ppermute(sl, axis_name, perm))
    out = jnp.concatenate(parts[::-1] if side == "before" else parts, axis=0)
    return jnp.moveaxis(out, 0, axis)


def _halo_extend(e, v, R: int, axis_name: str, n: int, axis: int = 0):
    """Block extended by R-deep halos on both sides along ``axis``."""
    eb = _collect_halo(e, R, axis_name, n, "before", axis)
    ea = _collect_halo(e, R, axis_name, n, "after", axis)
    vb = _collect_halo(v, R, axis_name, n, "before", axis)
    va = _collect_halo(v, R, axis_name, n, "after", axis)
    return (
        jnp.concatenate([eb, e, ea], axis=axis),
        jnp.concatenate([vb, v, va], axis=axis),
    )


def _fill_block(g, method, *, k, power, R, row0=0, col0=0, steps, vparams=None, backend="xla"):
    """Per-shard dense fill used inside the shard_map bodies — one switch so
    every sharded path offers the same backends as the single-device ops
    (the fused kriging kernel runs per device block; idw/mean are
    geometry-free, kriging threads the block origin + global steps)."""
    if method == "idw":
        return dense_ops.fill_idw(g, k=k, power=power, max_radius=R)
    if method == "window_mean":
        return dense_ops.fill_window_mean(g, k=k, max_radius=R)
    if method == "kriging":
        return dense_ops.fill_kriging(
            g, max_radius=R, row0=row0, col0=col0, steps=steps, vparams=vparams,
            backend=backend,
        )
    # 'bilinear' intentionally unsupported: its far-edge semantics are
    # clamp-*duplicate* (GridH.cpp:170-173), which a zero-validity halo
    # cannot represent; and at <1 us/plane it has nothing to gain
    raise ValueError(method)


@partial(
    jax.jit,
    static_argnames=("mesh", "method", "k", "power", "max_radius", "n_rows", "meta", "backend"),
)
def _sharded_fill_impl(elev, valid, mesh, method, k, power, max_radius, n_rows, meta, backend="xla"):
    n = len(mesh.devices.flat)
    R = max_radius
    min_lon, max_lon, min_lat, max_lat, lat_step, lon_step = meta
    blk = elev.shape[0] // n

    def local(e, v):
        # e, v: (blk, W) local band; multi-hop halos lift any blk >= R floor
        idx = jax.lax.axis_index("dp")
        big_e, big_v = _halo_extend(e, v, R, "dp", n, axis=0)
        g = RegularGrid(
            elev=big_e,
            valid=big_v,
            min_lon=min_lon,
            max_lon=max_lon,
            min_lat=min_lat,
            max_lat=max_lat,
        )
        out = _fill_block(
            g, method, k=k, power=power, R=R, row0=idx * blk - R,
            steps=(lat_step, lon_step), backend=backend,
        )
        return out[R : R + blk]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
        # pallas_call outputs carry no varying-mesh-axes info
        check_vma=(backend != "fused"),
    )
    return fn(elev, valid)[:n_rows]


@partial(
    jax.jit,
    static_argnames=("mesh", "method", "k", "power", "max_radius", "n_rows", "n_cols", "meta", "backend"),
)
def _sharded_fill2d_impl(elev, valid, mesh, method, k, power, max_radius, n_rows, n_cols, meta, backend="xla"):
    ny, nx = mesh.devices.shape
    R = max_radius
    min_lon, max_lon, min_lat, max_lat, lat_step, lon_step = meta
    blk_r = elev.shape[0] // ny
    blk_c = elev.shape[1] // nx

    def local(e, v):
        # rows first, then columns on the row-extended block: the column
        # exchange of already-row-haloed data carries the corner cells
        iy = jax.lax.axis_index("dy")
        ix = jax.lax.axis_index("dx")
        e2, v2 = _halo_extend(e, v, R, "dy", ny, axis=0)
        big_e, big_v = _halo_extend(e2, v2, R, "dx", nx, axis=1)
        g = RegularGrid(
            elev=big_e, valid=big_v,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        out = _fill_block(
            g, method, k=k, power=power, R=R,
            row0=iy * blk_r - R, col0=ix * blk_c - R,
            steps=(lat_step, lon_step), backend=backend,
        )
        return out[R : R + blk_r, R : R + blk_c]

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dy", "dx"), P("dy", "dx")),
        out_specs=P("dy", "dx"),
        check_vma=(backend != "fused"),
    )
    return fn(elev, valid)[:n_rows, :n_cols]


@partial(
    jax.jit,
    static_argnames=("mesh", "max_radius", "max_lag", "n_bins", "n_rows", "meta", "backend"),
)
def _sharded_fit_fill_impl(elev, valid, mesh, max_radius, max_lag, n_bins, n_rows, meta, backend="xla"):
    from ..variogram import fit_exponential, pair_sums, _bin_table

    n = len(mesh.devices.flat)
    R = max(max_radius, max_lag)
    min_lon, max_lon, min_lat, max_lat, lat_step, lon_step = meta
    blk = elev.shape[0] // n
    _, _, _, centers = _bin_table(max_lag, n_bins)

    def local(e, v):
        idx = jax.lax.axis_index("dp")

        # --- fit: distributed variogram pair sums (pairs counted once via the
        # half-plane convention; the 'after' halo supplies cross-band partners)
        bot_e = _collect_halo(e, max_lag, "dp", n, "after", axis=0)
        bot_v = _collect_halo(v, max_lag, "dp", n, "after", axis=0)
        band_e = jnp.concatenate([e, bot_e], axis=0)
        band_v = jnp.concatenate([v, bot_v], axis=0)
        s, c = pair_sums(band_e, band_v, blk, max_lag=max_lag, n_bins=n_bins)
        s = jax.lax.psum(s, "dp")
        c = jax.lax.psum(c, "dp")
        gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
        step = jnp.asarray(0.5 * (abs(lat_step) + abs(lon_step)), e.dtype)
        lags = jnp.asarray(centers, e.dtype) * step
        vparams = fit_exponential(lags, gamma, c)

        # --- predict: kriging fill with the fitted variogram
        big_e, big_v = _halo_extend(e, v, R, "dp", n, axis=0)
        g = RegularGrid(
            elev=big_e, valid=big_v,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        out = _fill_block(
            g, "kriging", k=4, power=2.0, R=max_radius, row0=idx * blk - R,
            steps=(lat_step, lon_step), vparams=vparams, backend=backend,
        )
        return out[R : R + blk], vparams

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=(P("dp", None), P()),
        check_vma=(backend != "fused"),
    )
    plane, vparams = fn(elev, valid)
    return plane[:n_rows], vparams


def sharded_fit_fill(
    mesh: Mesh,
    grid: RegularGrid,
    *,
    max_radius: int = 10,
    max_lag: int = 10,
    n_bins: int = 10,
    backend: str = "auto",
):
    """Full distributed 'training step': fit the exponential variogram from
    the observed cells (pair sums psum'd over the mesh) and krige-fill the
    grid with the fitted parameters.  Returns (plane (H, W), (nugget, sill,
    range)).  This is the step __graft_entry__.dryrun_multichip exercises."""
    n = len(mesh.devices.flat)
    H, W = grid.shape
    pad = (-H) % n
    elev, valid = grid.elev, grid.valid
    if pad:
        elev = jnp.concatenate([elev, jnp.zeros((pad, W), elev.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad, W), valid.dtype)])
    sh = NamedSharding(mesh, P("dp", None))
    elev = jax.device_put(elev, sh)
    valid = jax.device_put(valid, sh)
    meta = (grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat,
            grid.lat_step, grid.lon_step)
    return _sharded_fit_fill_impl(
        elev, valid, mesh, max_radius, max_lag, n_bins, H, meta,
        backend=pick_backend(backend, grid.dtype),
    )


def sharded_fill(
    mesh: Mesh,
    grid: RegularGrid,
    method: str = "idw",
    *,
    k: int = 8,
    power: float = 2.0,
    max_radius: int = 10,
    backend: str = "auto",
):
    """Dense fill of a row-band-sharded grid; returns the (H, W) plane.

    The grid is padded with invalid rows to a multiple of the mesh size.
    Bands may be shorter than max_radius: the halo is assembled by iterated
    one-hop ppermutes (see :func:`_collect_halo`).
    """
    n = len(mesh.devices.flat)
    H, W = grid.shape
    pad = (-H) % n
    elev = grid.elev
    valid = grid.valid
    if pad:
        elev = jnp.concatenate([elev, jnp.zeros((pad, W), elev.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad, W), valid.dtype)])
    sh = NamedSharding(mesh, P("dp", None))
    elev = jax.device_put(elev, sh)
    valid = jax.device_put(valid, sh)
    meta = (
        grid.min_lon,
        grid.max_lon,
        grid.min_lat,
        grid.max_lat,
        grid.lat_step,
        grid.lon_step,
    )
    return _sharded_fill_impl(
        elev, valid, mesh, method, k, power, max_radius, H, meta,
        backend=pick_backend(backend, grid.dtype),
    )


def sharded_fill2d(
    mesh: Mesh,
    grid: RegularGrid,
    method: str = "idw",
    *,
    k: int = 8,
    power: float = 2.0,
    max_radius: int = 10,
    backend: str = "auto",
):
    """Dense fill over a 2-D (dy, dx) block-sharded grid; returns the (H, W)
    plane.  Blocks exchange row halos, then column halos of the row-extended
    block (corners ride along); blocks smaller than max_radius in either axis
    use multi-hop halos.  The scale-out path when a grid is too *wide* for
    row bands alone, and the layout that keeps halo bytes minimal (perimeter
    ~ 4*R*sqrt(HW/n) per device instead of 2*R*W)."""
    ny, nx = mesh.devices.shape
    H, W = grid.shape
    pad_r = (-H) % ny
    pad_c = (-W) % nx
    elev = grid.elev
    valid = grid.valid
    if pad_r:
        elev = jnp.concatenate([elev, jnp.zeros((pad_r, elev.shape[1]), elev.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad_r, valid.shape[1]), valid.dtype)])
    if pad_c:
        elev = jnp.concatenate([elev, jnp.zeros((elev.shape[0], pad_c), elev.dtype)], axis=1)
        valid = jnp.concatenate([valid, jnp.zeros((valid.shape[0], pad_c), valid.dtype)], axis=1)
    sh = NamedSharding(mesh, P("dy", "dx"))
    elev = jax.device_put(elev, sh)
    valid = jax.device_put(valid, sh)
    meta = (
        grid.min_lon,
        grid.max_lon,
        grid.min_lat,
        grid.max_lat,
        grid.lat_step,
        grid.lon_step,
    )
    return _sharded_fill2d_impl(
        elev, valid, mesh, method, k, power, max_radius, H, W, meta,
        backend=pick_backend(backend, grid.dtype),
    )
