"""Trajectory-band router: dense band fill + windowed matmul bilinear resample.

Motivation: every scattered path pays one stencil-row gather per query.
For band-confined AUV trajectories the way past that floor is switching
algorithm: densely fill the trajectory's band ONCE with the cell-aligned
gather-free kriging/IDW pipeline (ops/dense.py), then serve queries by
*resampling* the filled band — and do the resample without per-query gathers
at all:

- queries are processed in fixed-size chunks of consecutive samples (an AUV
  trajectory is spatially coherent by construction: consecutive pings are
  meters apart);
- each chunk extracts ONE static-shape window of the band around the chunk's
  bounding cell (``lax.dynamic_slice`` with a dynamic base — vmapped over
  chunks this lowers to a row-block gather of window rows: ~wr rows per
  *chunk*, not per query, ~80x fewer gathered rows than the packed path at
  chunk=512/wr=48);
- the bilinear row interpolation is folded into a row-weight matrix
  (chunk, wr) — entries (1-wy)/wy at rows y0/y0+1 — and applied as a batched
  matmul against the (wr, wc) window: matrix work instead of gathers;  the
  column pick + x-lerp is one fused (chunk, wc) weighted reduce.

Queries whose corner cells fall outside their chunk's window (trajectory
jumps, chunk straddling a window boundary) are returned unresolved and
escalate to the caller's scattered path — same two-tier shape as
ops/two_tier.py.  :class:`BandRouter` wires that escalation to the full-grid
:class:`~auvtpu.ops.two_tier.TwoTierInterpolator` and adds the measured-cost
crossover heuristic (``route()``).

Semantics: in-band queries receive the *bilinear resample of the cell-aligned
kriging (or IDW) fill* — NOT per-query kriging.  At observed cells the band
keeps the observed value, so the resample interpolates measurements near data
and kriged estimates inside holes.  The divergence from per-query kriging is
documented and bounded in docs/SEMANTICS.md; out-of-band/unresolved queries
keep exact two-tier kriging semantics via escalation.

No reference analog: the reference serves every query through its per-point
CUDA kernels (kernels.cu:173-546).
"""

from __future__ import annotations

import dataclasses
import weakref
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import RegularGrid
from .backend import pick as pick_backend

_LANES = 128


def _effective_chunk(n: int, chunk: int) -> int:
    """Clamp the static chunk to the batch: a small batch otherwise pads into
    one full default-size chunk and pays its per-query work (a 512-ping nav
    tick at the c2048 serving default would do 4x the resample math).
    Smaller chunks
    have smaller bounding boxes, so resolution can only improve; power-of-two
    buckets (>=256) bound the number of compile keys per resampler.
    """
    if n >= chunk:
        return chunk
    c = 256
    while c < n:
        c <<= 1
    return min(c, chunk)


def _ceil_to(v: int, m: int) -> int:
    return -(-int(v) // m) * m


@partial(jax.jit, static_argnames=("chunk", "wr", "wc", "masked", "lerp_mode"))
def _band_resample(plane, vmask, x, y, *, chunk: int, wr: int, wc: int, masked: bool, lerp_mode: str = "onehot"):
    """Chunked windowed bilinear over a dense band plane.

    plane: (R, C) band values, NaN-free (NaN cells carry 0 with vmask=0).
    vmask: (R, C) 1.0 where the band value is defined (None when the band is
      fully defined — the common case after a kriging fill; `masked` static).
    x, y:  (N,) continuous band-frame coords (x=col, y=row); N % chunk == 0.

    Returns (z, ok): z NaN where a query is unresolved (corner outside the
    chunk window, outside the band, or touching an undefined cell); ok is the
    resolved mask.  One-hot row weights NEVER multiply NaN (0*NaN would
    poison the matmul — CLAUDE.md): undefined cells are zero-filled and
    accounted through the vmask channel instead.
    """
    R, C = plane.shape
    dt = plane.dtype
    n = x.shape[0]
    nch = n // chunk
    xc = x.reshape(nch, chunk)
    yc = y.reshape(nch, chunk)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    wx = (xc - x0).astype(dt)
    wy = (yc - y0).astype(dt)

    # per-chunk window base, clamped so the static window stays in-bounds
    bx = jnp.clip(jnp.min(x0, axis=1), 0, max(C - wc, 0))
    by = jnp.clip(jnp.min(y0, axis=1), 0, max(R - wr, 0))
    lx0 = x0 - bx[:, None]
    ly0 = y0 - by[:, None]
    ok = (
        (lx0 >= 0) & (lx0 <= wc - 2) & (ly0 >= 0) & (ly0 <= wr - 2)
        & (x0 >= 0) & (x0 <= C - 2) & (y0 >= 0) & (y0 <= R - 2)
    )
    lx0c = jnp.clip(lx0, 0, wc - 2)
    ly0c = jnp.clip(ly0, 0, wr - 2)

    if masked:
        stacked = jnp.concatenate([plane, vmask], axis=1)  # (R, 2C)
        win = jax.vmap(
            lambda byi, bxi: jax.lax.dynamic_slice(stacked, (byi, bxi), (wr, wc))
        )(by, bx)
        winm = jax.vmap(
            lambda byi, bxi: jax.lax.dynamic_slice(stacked, (byi, bxi + C), (wr, wc))
        )(by, bx)
    else:
        win = jax.vmap(
            lambda byi, bxi: jax.lax.dynamic_slice(plane, (byi, bxi), (wr, wc))
        )(by, bx)

    return _lerp_window(win, winm if masked else None, ly0c, lx0c, wy, wx, ok,
                        mode=lerp_mode)


def _lerp_onehot(iota, i0, frac, dt):
    """Linear-interpolation weight vector: (1-frac) at lane i0, frac at lane
    i0+1, 0 elsewhere.  mode='onehot' build: two iota compares."""
    return (
        (iota == i0[:, :, None]).astype(dt) * (1 - frac)[:, :, None]
        + (iota == (i0 + 1)[:, :, None]).astype(dt) * frac[:, :, None]
    )


def _lerp_hat(iota, i0, frac, dt):
    """Same weight vector as _lerp_onehot, built as the hat function
    relu(1 - |(iota - i0) - frac|): 5 ops/lane vs the compare build's 7.
    The integer subtraction happens BEFORE the float cast so every lane value
    is exact ((i0 + frac) itself can round at 24 mantissa bits): lane i0
    yields 1-frac and lane i0+1 yields 1-(1-frac) = frac, both exact by
    Sterbenz — bit-identical weights to _lerp_onehot."""
    d = (iota - i0[:, :, None]).astype(dt) - frac[:, :, None]
    return jnp.maximum(1 - jnp.abs(d), 0)


def _col_pick(rows, lx0c, wx, mode):
    """Column pick + x-lerp of a (nch, chunk, wc) row-lerped tensor.

    mode='onehot'/'hat': one wc-lane weighted reduce (builds differ, weights
    bit-identical).  mode='hat2': two-level hi/lo decomposition — an
    (nb-1)-lane block one-hot picks the 32-wide slab (stride 16) containing
    both columns, then one 32-lane hat reduce: ~2x fewer per-query lanes
    than the flat wc-lane stage (the measured bound, NEXTSTEPS 4d).  hat2
    regroups the summation so results can differ from onehot/hat in the last
    ulp."""
    dt = rows.dtype
    nch, chunk, wc = rows.shape
    if mode in ("onehot", "hat"):
        ciota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, wc), 2)
        build = _lerp_onehot if mode == "onehot" else _lerp_hat
        mcol = build(ciota, lx0c, wx, dt)
        return (rows * mcol).sum(axis=2)
    if mode != "hat2":
        raise ValueError(mode)
    if wc % 16 or wc < 32:
        return _col_pick(rows, lx0c, wx, "hat")
    nb = wc // 16
    s = jnp.clip(lx0c >> 4, 0, nb - 2)  # 32-wide slab [16s, 16s+32) holds lx0c, lx0c+1
    blocks = rows.reshape(nch, chunk, nb, 16)
    biota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, nb), 2)
    hb0 = (biota == s[:, :, None]).astype(dt)
    hb1 = (biota == (s + 1)[:, :, None]).astype(dt)
    slab_a = (blocks * hb0[..., None]).sum(axis=2)  # (nch, chunk, 16)
    slab_b = (blocks * hb1[..., None]).sum(axis=2)
    lo = lx0c - (s << 4)  # in [0, 30]
    liota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 32), 2)
    hat = _lerp_hat(liota, lo, wx, dt)
    return (slab_a * hat[..., :16]).sum(axis=2) + (slab_b * hat[..., 16:]).sum(axis=2)


def _lerp_window_t(win, winm, ly0c, lx0c, wy, wx, ok):
    """Transposed-layout bilinear-from-window: queries on LANES, window
    rows/cols on sublanes.  Same arithmetic as the 'hat' build — the hat
    weight vectors have exactly two nonzero entries, so every reduction is
    a two-term sum plus exact zeros; the only divergence from the wide
    layout is the FMA pairing the backend picks for the row contraction
    (<= 1 f32 ulp, ~1e-7 relative; pinned by tests).  The per-query tensors
    are (nch, w*, chunk) instead of (nch, chunk, w*), which frees the
    window width from the 128-lane register: with auto-sized windows
    (wr, wc down to 8) the per-query vector work shrinks proportionally,
    where the wide layout pads wc to 128 lanes regardless (the measured
    resample bound)."""
    dt = win.dtype
    wr, wc = win.shape[1], win.shape[2]
    riota = jax.lax.broadcasted_iota(jnp.int32, (1, wr, 1), 1)
    dr = (riota - ly0c[:, None, :]).astype(dt) - wy[:, None, :]
    mrow = jnp.maximum(1 - jnp.abs(dr), 0)  # (nch, wr, chunk)
    # precision=HIGHEST is load-bearing here too (see _lerp_window)
    rows_t = jnp.einsum("nrw,nrc->nwc", win, mrow,
                        precision=jax.lax.Precision.HIGHEST)  # (nch, wc, chunk)
    ciota = jax.lax.broadcasted_iota(jnp.int32, (1, wc, 1), 1)
    dc = (ciota - lx0c[:, None, :]).astype(dt) - wx[:, None, :]
    mcol = jnp.maximum(1 - jnp.abs(dc), 0)  # (nch, wc, chunk)
    z = (rows_t * mcol).sum(axis=1)  # (nch, chunk)
    if winm is not None:
        rows_m = jnp.einsum("nrw,nrc->nwc", winm, mrow,
                            precision=jax.lax.Precision.HIGHEST)
        wsum = (rows_m * mcol).sum(axis=1)
        ok = ok & (wsum > 1.0 - 1e-3)
    z = jnp.where(ok, z, jnp.nan)
    return z.reshape(-1), ok.reshape(-1)


def _lerp_window(win, winm, ly0c, lx0c, wy, wx, ok, mode: str = "onehot"):
    """Shared bilinear-from-window block: row-lerp folded into the extraction
    matmul (nch, chunk, wr) @ (nch, wr, wc), column pick + x-lerp as one fused
    weighted reduce (see _col_pick for the mode variants; mode='hat_t' is the
    transposed queries-on-lanes layout, _lerp_window_t).  winm=None means
    the band/atlas is fully defined."""
    if mode == "hat_t":
        return _lerp_window_t(win, winm, ly0c, lx0c, wy, wx, ok)
    dt = win.dtype
    wr = win.shape[1]
    riota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, wr), 2)
    build = _lerp_hat if mode in ("hat", "hat2") else _lerp_onehot
    mrow = build(riota, ly0c, wy, dt)
    # precision=HIGHEST is load-bearing: a reduced-precision f32 matmul
    # (TF32 keeps 10 mantissa bits) quantizes 4 km elevations by metres
    rows_v = jnp.einsum("ncr,nrw->ncw", mrow, win,
                        precision=jax.lax.Precision.HIGHEST)
    z = _col_pick(rows_v, lx0c, wx, mode)
    if winm is not None:
        rows_m = jnp.einsum("ncr,nrw->ncw", mrow, winm,
                            precision=jax.lax.Precision.HIGHEST)
        wsum = _col_pick(rows_m, lx0c, wx, mode)
        ok = ok & (wsum > 1.0 - 1e-3)
    z = jnp.where(ok, z, jnp.nan)
    return z.reshape(-1), ok.reshape(-1)


# default lerp-weight build for the resample stages; 'hat' is bit-identical
# to 'onehot' (see _lerp_hat's Sterbenz argument)
LERP_MODE_DEFAULT = "hat"


@dataclasses.dataclass(frozen=True)
class Band:
    """A filled rectangular sub-band of a grid (device-resident)."""

    plane: jax.Array      # (R, C) NaN-free values (0 at undefined cells)
    vmask: jax.Array      # (R, C) 1.0 where defined
    masked: bool          # static: any undefined cell in the band?
    row0: int
    col0: int

    @property
    def shape(self):
        return self.plane.shape

    @property
    def cells(self) -> int:
        return int(self.plane.shape[0] * self.plane.shape[1])


def fill_band(
    grid: RegularGrid,
    row0: int,
    nrows: int,
    col0: int,
    ncols: int,
    *,
    method: str = "kriging",
    margin: int = 10,
    fill_backend: str = "xla",
    convention: str = "reference",
    vparams=None,
    model: str = "exponential",
    assume_masked: bool | None = None,
) -> Band:
    """Dense-fill a [row0:row0+nrows, col0:col0+ncols] band of ``grid``.

    The fill runs on a margin-expanded block (default margin = the fill's
    max_radius) so band-edge cells see the same candidate window they would
    in a whole-grid fill, then crops back; ``row0/col0/steps`` keep the
    variogram geometry global (fill_kriging's sharded-execution support).
    Observed cells keep their observed value; only invalid cells take the
    fill.  Cells the fill cannot resolve (empty candidate window) stay
    undefined and are tracked in the band's vmask.
    """
    from .dense import fill_idw, fill_kriging

    H, W = grid.shape
    row0, col0 = int(row0), int(col0)
    nrows, ncols = int(nrows), int(ncols)
    if not (0 <= row0 and row0 + nrows <= H and 0 <= col0 and col0 + ncols <= W):
        raise ValueError(f"band [{row0}:{row0+nrows}, {col0}:{col0+ncols}] outside grid {grid.shape}")
    r0 = max(0, row0 - margin)
    r1 = min(H, row0 + nrows + margin)
    c0 = max(0, col0 - margin)
    c1 = min(W, col0 + ncols + margin)
    sub = RegularGrid(
        elev=jax.lax.slice(grid.elev, (r0, c0), (r1, c1)),
        valid=jax.lax.slice(grid.valid, (r0, c0), (r1, c1)),
        # bounds only shift the variogram's absolute coords; keep them global
        # via min_* plus the block offset so row0/col0 semantics match
        min_lon=grid.min_lon,
        max_lon=grid.max_lon,
        min_lat=grid.min_lat,
        max_lat=grid.max_lat,
    )
    steps = (grid.lat_step, grid.lon_step)
    if method == "kriging":
        filled = fill_kriging(
            sub, row0=r0, col0=c0, steps=steps, vparams=vparams,
            convention=convention, backend=fill_backend, model=model,
        )
    elif method == "idw":
        filled = fill_idw(sub, convention=convention)
    else:
        raise ValueError(method)
    # crop the margin back to the requested band
    fr, fc = row0 - r0, col0 - c0
    filled = jax.lax.slice(filled, (fr, fc), (fr + nrows, fc + ncols))
    ev = jax.lax.slice(grid.elev, (row0, col0), (row0 + nrows, col0 + ncols))
    va = jax.lax.slice(grid.valid, (row0, col0), (row0 + nrows, col0 + ncols))
    plane = jnp.where(va > 0.5, ev, filled)
    vmask = jnp.where(jnp.isnan(plane), 0.0, 1.0).astype(grid.dtype)
    plane = jnp.where(jnp.isnan(plane), 0.0, plane)
    if assume_masked is None:
        masked = bool(jnp.min(vmask) < 0.5)  # static fast-path pick; 1 sync
    else:
        # caller-pinned (refresh/benchmark path, no device sync); True is
        # always-correct (the vmask channel rides along), False asserts the
        # fill covers everything — only pin False after a synced build said so
        masked = bool(assume_masked)
    return Band(plane=plane, vmask=vmask, masked=masked, row0=row0, col0=col0)


class BandResampler:
    """Serve scattered queries from a filled band via the chunked matmul resample.

    chunk/wr/wc are static kernel parameters: chunk consecutive queries share
    one (wr, wc) window.  Defaults suit survey trajectories sampled densely
    relative to the grid step; a chunk whose bounding box exceeds the window
    resolves only the queries that fit and reports the rest unresolved.
    """

    def __init__(self, grid: RegularGrid, band: Band, *, chunk: int = 512,
                 win_rows: int = 48, win_cols: int = 128,
                 lerp_mode: str = LERP_MODE_DEFAULT):
        R, C = band.shape
        self.grid = grid
        self.band = band
        self.chunk = int(chunk)
        self.wr = min(int(win_rows), R)
        self.wc = min(int(win_cols), C)
        self.dtype = band.plane.dtype
        self.lerp_mode = lerp_mode

    def resample(self, lons, lats):
        """Returns (values, resolved_mask); unresolved entries are NaN."""
        lons = jnp.asarray(lons, self.dtype)
        lats = jnp.asarray(lats, self.dtype)
        n = lons.shape[0]
        x, y = self.grid.lonlat_to_xy(lons, lats)
        x = x - self.band.col0
        y = y - self.band.row0
        chunk = _effective_chunk(n, self.chunk)
        pad = (-n) % chunk
        if pad:
            # pad with the LAST query so the tail chunk stays coherent
            x = jnp.concatenate([x, jnp.broadcast_to(x[-1], (pad,))])
            y = jnp.concatenate([y, jnp.broadcast_to(y[-1], (pad,))])
        z, ok = _band_resample(
            self.band.plane, self.band.vmask, x, y,
            chunk=chunk, wr=self.wr, wc=self.wc,
            masked=self.band.masked, lerp_mode=self.lerp_mode,
        )
        return z[:n], ok[:n]


@partial(jax.jit, static_argnames=("chunk", "wr", "wc", "masked", "pick", "lerp_mode"))
def _atlas_resample(planes, vmasks, origins, x, y, *, chunk: int, wr: int,
                    wc: int, masked: bool, pick: bool = True,
                    lerp_mode: str = "onehot"):
    """Chunked windowed bilinear over a K-page band atlas.

    planes:  (K, R, C) filled page values (NaN-free; undefined cells carry 0
             with vmask=0).  All pages share one shape — the page index is a
             per-chunk coordinate of ONE 3-D dynamic slice, so serving cost
             is identical to the single-band `_band_resample` regardless of K.
    vmasks:  (K, R, C) definedness (used when ``masked``).
    origins: (K, 2) page (row0, col0) in grid-frame cells (planes' dtype).
    x, y:    (N,) continuous GRID-frame coords, N % chunk == 0.
    pick:    static; False skips the page-containment test (K == 1 fast path,
             bit-compatible with `_band_resample`).

    Each chunk is routed to the page containing its bounding-box center;
    queries are then checked per-corner against that page exactly as the
    single-band kernel does, so straddling queries report unresolved and
    escalate rather than read a wrong page.
    """
    K, R, C = planes.shape
    dt = planes.dtype
    n = x.shape[0]
    nch = n // chunk
    xc = x.reshape(nch, chunk)
    yc = y.reshape(nch, chunk)

    if pick:
        cx = 0.5 * (jnp.min(xc, axis=1) + jnp.max(xc, axis=1))   # (nch,)
        cy = 0.5 * (jnp.min(yc, axis=1) + jnp.max(yc, axis=1))
        r0 = origins[:, 0][None, :]                              # (1, K)
        c0 = origins[:, 1][None, :]
        fits = (
            (cx[:, None] >= c0) & (cx[:, None] <= c0 + (C - 1))
            & (cy[:, None] >= r0) & (cy[:, None] <= r0 + (R - 1))
        )                                                        # (nch, K)
        any_fit = jnp.any(fits, axis=1)
        page = jnp.argmax(fits, axis=1).astype(jnp.int32)        # first fit
    else:
        any_fit = jnp.ones((nch,), bool)
        page = jnp.zeros((nch,), jnp.int32)
    org = origins[page]                                          # (nch, 2)
    xb = xc - org[:, 1][:, None]
    yb = yc - org[:, 0][:, None]

    x0 = jnp.floor(xb).astype(jnp.int32)
    y0 = jnp.floor(yb).astype(jnp.int32)
    wx = (xb - x0).astype(dt)
    wy = (yb - y0).astype(dt)
    bx = jnp.clip(jnp.min(x0, axis=1), 0, max(C - wc, 0))
    by = jnp.clip(jnp.min(y0, axis=1), 0, max(R - wr, 0))
    lx0 = x0 - bx[:, None]
    ly0 = y0 - by[:, None]
    ok = (
        (lx0 >= 0) & (lx0 <= wc - 2) & (ly0 >= 0) & (ly0 <= wr - 2)
        & (x0 >= 0) & (x0 <= C - 2) & (y0 >= 0) & (y0 <= R - 2)
        & any_fit[:, None]
    )
    lx0c = jnp.clip(lx0, 0, wc - 2)
    ly0c = jnp.clip(ly0, 0, wr - 2)

    if masked:
        stacked = jnp.concatenate([planes, vmasks], axis=2)      # (K, R, 2C)
        win = jax.vmap(
            lambda pi, byi, bxi: jax.lax.dynamic_slice(
                stacked, (pi, byi, bxi), (1, wr, wc))[0]
        )(page, by, bx)
        winm = jax.vmap(
            lambda pi, byi, bxi: jax.lax.dynamic_slice(
                stacked, (pi, byi, bxi + C), (1, wr, wc))[0]
        )(page, by, bx)
    else:
        win = jax.vmap(
            lambda pi, byi, bxi: jax.lax.dynamic_slice(
                planes, (pi, byi, bxi), (1, wr, wc))[0]
        )(page, by, bx)
        winm = None
    return _lerp_window(win, winm, ly0c, lx0c, wy, wx, ok, mode=lerp_mode)


@partial(jax.jit, static_argnames=("chunk",))
def _chunk_boxes_device(x, y, *, chunk: int):
    """Per-chunk bbox reduction on device: (nch, 4) [xmin, xmax, ymin, ymax].
    Avoids shipping the full trajectory (40 MB of f32 coords at 5M queries)
    to the host for planning; the (nch, 4) boxes are ~150 KB."""
    nch = x.shape[0] // chunk
    xc = x[: nch * chunk].reshape(nch, chunk)
    yc = y[: nch * chunk].reshape(nch, chunk)
    return jnp.stack(
        [xc.min(axis=1), xc.max(axis=1), yc.min(axis=1), yc.max(axis=1)],
        axis=1,
    )


def _trajectory_boxes(x, y, chunk: int) -> np.ndarray:
    """Integer chunk bboxes [x0, x1, y0, y1] with the +1 bilinear-support
    cell, from device arrays (device reduction + small readback) or host
    arrays (numpy).  The tail partial chunk gets its own box."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("empty trajectory")
    if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
        nch = n // chunk
        parts = []
        if nch:
            parts.append(np.asarray(_chunk_boxes_device(x, y, chunk=chunk),
                                    np.float64))
        if n % chunk:
            xt, yt = x[nch * chunk:], y[nch * chunk:]
            parts.append(np.asarray(
                jnp.stack([xt.min(), xt.max(), yt.min(), yt.max()])[None, :],
                np.float64))
        raw = np.concatenate(parts, axis=0)
    else:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        pad = (-n) % chunk
        if pad:
            x = np.concatenate([x, np.broadcast_to(x[-1], (pad,))])
            y = np.concatenate([y, np.broadcast_to(y[-1], (pad,))])
        xc = x.reshape(-1, chunk)
        yc = y.reshape(-1, chunk)
        raw = np.stack([xc.min(1), xc.max(1), yc.min(1), yc.max(1)], axis=1)
    return np.stack([
        np.floor(raw[:, 0]), np.floor(raw[:, 1]) + 1,
        np.floor(raw[:, 2]), np.floor(raw[:, 3]) + 1,
    ], axis=1).astype(np.int64)


def plan_segments(x, y, *, chunk: int = 512, max_bands: int = 8,
                  page_overhead_cells: int = 8192, grid_shape=None,
                  boxes=None):
    """Greedy segmentation of an ORDERED trajectory into tile-snapped bands.

    A single bbox band pays for the whole query hull: a diagonal or L-shaped
    mission with a thin corridor fills bbox_area >> corridor_area cells.
    Splitting the (spatially coherent) trajectory into consecutive segments
    makes total fill cost track the corridor instead.  Greedy rule: extend
    the current segment while the snapped-area increase of absorbing the
    next chunk is no larger than opening a fresh band for it (its own
    snapped area + ``page_overhead_cells`` of fixed per-band cost); then cut.
    Adjacent segments are re-merged cheapest-first down to ``max_bands``.

    x, y are grid-frame continuous coords (device or host arrays).  Returns a
    list of (r0, c0, nrows, ncols) snapped exactly like
    ``BandRouter.band_bbox`` (rows x8, cols x128, +1-cell bilinear support),
    clipped to ``grid_shape`` when given.  A band-confined trajectory yields
    one segment — segmentation never hurts the confined case.
    """
    # chunk bboxes as ints with the +1 bilinear-support cell included;
    # device arrays reduce on device and read back only the boxes
    if boxes is None:
        boxes = _trajectory_boxes(x, y, chunk)

    def snapped_area(b):
        nr = _ceil_to(max(int(b[3] - b[2]) + 1, 8), 8)
        nc = _ceil_to(max(int(b[1] - b[0]) + 1, 128), _LANES)
        return nr * nc

    def union(a, b):
        return (min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3]))

    segs = []
    cur = tuple(boxes[0])
    for b in boxes[1:]:
        b = tuple(b)
        merged = union(cur, b)
        if snapped_area(merged) - snapped_area(cur) <= snapped_area(b) + page_overhead_cells:
            cur = merged
        else:
            segs.append(cur)
            cur = b
    segs.append(cur)

    # cap the page count: merge the adjacent pair with the smallest area cost
    while len(segs) > max_bands:
        costs = [
            snapped_area(union(segs[i], segs[i + 1]))
            - snapped_area(segs[i]) - snapped_area(segs[i + 1])
            for i in range(len(segs) - 1)
        ]
        i = int(np.argmin(costs))
        segs[i : i + 2] = [union(segs[i], segs[i + 1])]

    out = []
    for (x0, x1, y0, y1) in segs:
        nr = _ceil_to(max(int(y1 - y0) + 1, 8), 8)
        nc = _ceil_to(max(int(x1 - x0) + 1, 128), _LANES)
        r0, c0 = int(y0), int(x0)
        if grid_shape is not None:
            H, W = grid_shape
            nr, nc = min(nr, H), min(nc, W)
            r0 = max(0, min(r0, H - nr))
            c0 = max(0, min(c0, W - nc))
        out.append((r0, c0, nr, nc))
    return out


@dataclasses.dataclass(frozen=True)
class BandAtlas:
    """K same-shape filled band pages stacked for one-pass resampling."""

    planes: jax.Array    # (K, R, C) NaN-free page values
    vmasks: jax.Array    # (K, R, C) 1.0 where defined
    origins: jax.Array   # (K, 2) page (row0, col0), planes' dtype
    masked: bool         # static: any undefined cell in any page?
    placed: tuple = ()   # host copy of the (row0, col0) origins — lets
                         # refresh() redo the fill with ZERO device readbacks

    @property
    def shape(self):
        return self.planes.shape

    @property
    def cells(self) -> int:
        k, r, c = self.planes.shape
        return int(k * r * c)


@partial(jax.jit, static_argnames=("placed", "pr", "pc", "method", "margin",
                                   "fill_backend", "convention", "model"))
def _fill_pages(grid: RegularGrid, vparams, *, placed, pr: int, pc: int,
                method: str, margin: int, fill_backend: str, convention: str,
                model: str):
    """All K page fills in ONE dispatch: a Python loop over K fill_band
    calls pays K host dispatches of un-jitted op chains; one jit collapses
    that to a single dispatch and lets XLA schedule the page fills
    back-to-back on device."""
    bands = [
        fill_band(grid, rp, pr, cp, pc, method=method, margin=margin,
                  fill_backend=fill_backend, convention=convention,
                  vparams=vparams, model=model, assume_masked=True)
        for (rp, cp) in placed
    ]
    return (jnp.stack([b.plane for b in bands]),
            jnp.stack([b.vmask for b in bands]))


def place_segments(segments, shape):
    """Re-place planned segments to a common snapped page shape (the max
    over segments, centered on each segment, shifted inside the grid).
    Returns (placed (row0, col0) tuples, pr, pc)."""
    H, W = shape
    pr = max(nr for (_, _, nr, _) in segments)
    pc = max(nc for (_, _, _, nc) in segments)
    pr, pc = min(pr, H), min(pc, W)
    placed = []
    for (r0, c0, nr, nc) in segments:
        # center the segment in the common page, clipped to the grid
        rp = max(0, min(r0 - (pr - nr) // 2, H - pr))
        cp = max(0, min(c0 - (pc - nc) // 2, W - pc))
        placed.append((rp, cp))
    return tuple(placed), pr, pc


def build_atlas(grid: RegularGrid, segments, *, method: str = "kriging",
                margin: int = 10, fill_backend: str = "xla",
                convention: str = "reference", vparams=None,
                model: str = "exponential",
                assume_masked: bool | None = None) -> BandAtlas:
    """Fill one page per planned segment, all re-placed to a common snapped
    shape (place_segments).  Equal shapes mean ONE fill compilation serves
    every page, and all pages fill in one jitted dispatch (`_fill_pages`)."""
    placed, pr, pc = place_segments(segments, grid.shape)
    planes, vmasks = _fill_pages(
        grid, vparams, placed=tuple(placed), pr=pr, pc=pc, method=method,
        margin=margin, fill_backend=fill_backend, convention=convention,
        model=model,
    )
    if assume_masked is None:
        masked = bool(jnp.min(vmasks) < 0.5)  # static fast-path pick; 1 sync
    else:
        masked = bool(assume_masked)
    return BandAtlas(
        planes=planes,
        vmasks=vmasks,
        origins=jnp.asarray(np.asarray(placed), grid.dtype),
        masked=masked,
        placed=tuple(placed),
    )


class AtlasResampler:
    """Serve scattered queries from a band atlas (same API as BandResampler;
    cost is one `_band_resample`-shaped pass regardless of page count)."""

    def __init__(self, grid: RegularGrid, atlas: BandAtlas, *, chunk: int = 512,
                 win_rows: int = 48, win_cols: int = 128,
                 lerp_mode: str = LERP_MODE_DEFAULT):
        _, R, C = atlas.shape
        self.grid = grid
        self.atlas = atlas
        self.chunk = int(chunk)
        self.wr = min(int(win_rows), R)
        self.wc = min(int(win_cols), C)
        self.dtype = atlas.planes.dtype
        self.lerp_mode = lerp_mode

    def resample(self, lons, lats):
        """Returns (values, resolved_mask); unresolved entries are NaN."""
        lons = jnp.asarray(lons, self.dtype)
        lats = jnp.asarray(lats, self.dtype)
        n = lons.shape[0]
        x, y = self.grid.lonlat_to_xy(lons, lats)
        chunk = _effective_chunk(n, self.chunk)
        pad = (-n) % chunk
        if pad:
            x = jnp.concatenate([x, jnp.broadcast_to(x[-1], (pad,))])
            y = jnp.concatenate([y, jnp.broadcast_to(y[-1], (pad,))])
        z, ok = _atlas_resample(
            self.atlas.planes, self.atlas.vmasks, self.atlas.origins,
            x, y, chunk=chunk, wr=self.wr, wc=self.wc,
            masked=self.atlas.masked,
            pick=self.atlas.planes.shape[0] > 1,
            lerp_mode=self.lerp_mode,
        )
        return z[:n], ok[:n]


# Routing cost model (ns per unit), used only for ROUTING decisions:
#   packed = packed_per_query * n
#   band   = dispatch + fill_per_cell * cells       (omitted when band_ready)
#            + resample_per_query * n + packed_per_query * n * (1 - coherence)
# Calibrated by scripts/band_probe.py (5M-ping survey trajectory on the
# Kerguelen-shaped stand-in) on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit.  The probe's band refreshes (293k and 14k cells) both took ~1.4 ms:
# the fill is dispatch-bound at band sizes, so fill_per_cell is the fused
# whole-plane fill's device time instead (0.196 ms per 5.01M cells, bench.py
# trace on the same card).
COST_NS = {
    "packed_per_query": 3.739,
    "dispatch": 1.4525e6,
    "fill_per_cell": 0.04,
    "resample_per_query": 1.128,
}


@partial(jax.jit, static_argnames=("chunk", "wr", "wc", "pr", "pc"))
def _chunk_fit_frac(x, y, origins, *, chunk, wr, wc, pr, pc):
    """Fraction of query chunks whose bbox fits a (wr, wc) resample window,
    and — when ``origins`` (K,2 page row/col corners of (pr, pc) pages) is
    given — lies inside at least one page.  One jit: routing runs per served
    batch, so it costs one dispatch."""
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1], (pad,))])
        y = jnp.concatenate([y, jnp.broadcast_to(y[-1], (pad,))])
    xc = x.reshape(-1, chunk)
    yc = y.reshape(-1, chunk)
    xmin, xmax = jnp.min(xc, axis=1), jnp.max(xc, axis=1)
    ymin, ymax = jnp.min(yc, axis=1), jnp.max(yc, axis=1)
    fit = (xmax - xmin < wc - 2) & (ymax - ymin < wr - 2)
    if origins is not None:
        orow = origins[:, 0].astype(x.dtype)[:, None]
        ocol = origins[:, 1].astype(x.dtype)[:, None]
        # bilinear support: floor(x)+1 must stay inside the page
        inside = (
            (xmin[None, :] >= ocol) & (xmax[None, :] < ocol + (pc - 1))
            & (ymin[None, :] >= orow) & (ymax[None, :] < orow + (pr - 1))
        )
        fit &= jnp.any(inside, axis=0)
    return jnp.mean(fit.astype(jnp.float32))


class BandRouter:
    """Crossover router: band fill+resample vs the packed two-tier path.

    ``route(lons, lats)`` picks the cheaper algorithm from the measured cost
    model + a device-computed coherence statistic; ``kriging()`` executes the
    choice, escalating band-unresolved queries to exact two-tier kriging.
    """

    def __init__(self, grid: RegularGrid, *, convention: str = "reference",
                 chunk: int = 2048, win_rows: int = 112, win_cols: int = 128,
                 margin: int = 10, fill_backend: str = "auto",
                 two_tier=None, cost_ns=None, max_bands: int = 1,
                 auto_window: bool = True, lerp_mode: str = "hat_t"):
        from .two_tier import TwoTierInterpolator

        self.grid = grid
        self.convention = convention
        self.chunk = int(chunk)
        self.win_rows = int(win_rows)
        self.win_cols = int(win_cols)
        self.margin = int(margin)
        self.lerp_mode = lerp_mode
        # auto_window shrinks the resample window to the measured max chunk
        # span at prepare() time (win_rows/win_cols become upper bounds,
        # i.e. the coherence threshold routing still uses).  With the
        # transposed 'hat_t' default the window width IS the per-query work.
        # Never affects correctness — chunks that exceed the window escalate.
        self.auto_window = bool(auto_window)
        # max_bands > 1 enables trajectory segmentation (plan_segments): a
        # diagonal/L-shaped mission fills K thin pages instead of its bbox
        self.max_bands = int(max_bands)
        self.fill_backend = pick_backend(fill_backend, grid.dtype)
        self.two_tier = two_tier or TwoTierInterpolator(grid, convention=convention)
        self.cost_ns = dict(COST_NS, **(cost_ns or {}))
        self._band = None
        self._atlas = None
        self._resampler = None
        self._plan_cache = None
        self.last_coherence = None   # set by route()
        self.last_unresolved = None  # set by the band serve path
        self._band_method = None     # fill method the band/atlas holds

    # -- band management ---------------------------------------------------
    def _plan(self, lons, lats, mb: int):
        """Chunk boxes + (mb>1) segment plan, cached on the query arrays so
        route() and the prepare() that usually follows share ONE device
        reduction + host plan.  The cache holds weakrefs to the arrays: a
        hit requires the SAME live objects (ids alone can be recycled by the
        allocator after gc, which could hand a different same-length batch a
        stale plan).  Unweakreffable inputs (e.g. lists) simply skip the
        cache.  prepare() consumes (clears) it."""
        key = (int(np.shape(lons)[0]), int(mb))
        if self._plan_cache is not None:
            ckey, rlons, rlats, boxes, segs = self._plan_cache
            if ckey == key and rlons() is lons and rlats() is lats:
                return boxes, segs
        x, y = self.grid.lonlat_to_xy(
            jnp.asarray(lons, self.grid.dtype),
            jnp.asarray(lats, self.grid.dtype),
        )
        boxes = _trajectory_boxes(x, y, self.chunk)
        segs = (
            plan_segments(x, y, chunk=self.chunk, max_bands=mb,
                          grid_shape=self.grid.shape, boxes=boxes)
            if mb > 1 else None
        )
        try:
            self._plan_cache = (
                key, weakref.ref(lons), weakref.ref(lats), boxes, segs)
        except TypeError:
            self._plan_cache = None
        return boxes, segs

    def band_bbox(self, lons, lats, *, boxes=None):
        """Snap the query bbox (+1 cell bilinear support) to a band shape:
        rows to multiples of 8, cols to multiples of 128 (tile-aligned fills),
        clipped to the grid.  ``boxes`` (per-chunk int bboxes from
        _trajectory_boxes) skips the device reduction when already known."""
        H, W = self.grid.shape
        if boxes is not None:
            x0, x1 = int(boxes[:, 0].min()), int(boxes[:, 1].max())
            y0, y1 = int(boxes[:, 2].min()), int(boxes[:, 3].max())
        else:
            x, y = self.grid.lonlat_to_xy(jnp.asarray(lons, self.grid.dtype),
                                          jnp.asarray(lats, self.grid.dtype))
            # ONE device round trip for all 4 scalars
            ext = np.asarray(jnp.stack([
                jnp.floor(jnp.min(x)), jnp.floor(jnp.max(x)),
                jnp.floor(jnp.min(y)), jnp.floor(jnp.max(y)),
            ]))
            x0, x1 = int(ext[0]), int(ext[1]) + 1
            y0, y1 = int(ext[2]), int(ext[3]) + 1
        r0 = max(0, min(y0, H - 2))
        c0 = max(0, min(x0, W - 2))
        nrows = min(_ceil_to(max(y1 - r0 + 1, 8), 8), H)
        ncols = min(_ceil_to(max(x1 - c0 + 1, 128), 128), W)
        # keep the snapped size by shifting the origin down at the grid edge
        # (alignment only degrades when the whole axis is smaller than one
        # snap unit)
        r0 = min(r0, H - nrows)
        c0 = min(c0, W - ncols)
        return r0, nrows, c0, ncols

    def prepare(self, lons, lats, *, max_bands: int | None = None, **fill_kw):
        """Fill the band — or, with max_bands > 1 and a spread-out
        trajectory, the segmented band atlas — covering these queries.
        With auto_window, also size the resample window from the measured
        chunk spans (one small device readback on this cold path)."""
        mb = self.max_bands if max_bands is None else int(max_bands)
        self._band_method = fill_kw.get("method", "kriging")
        segs = None
        boxes = None
        wr, wc = self.win_rows, self.win_cols
        if mb > 1 or self.auto_window:
            boxes, segs = self._plan(lons, lats, mb)
            self._plan_cache = None  # consumed; see _plan
        if self.auto_window:
            # window must hold the chunk's [floor(min), floor(max)+1] support:
            # boxes already carry the +1 cell, so the requirement is
            # (b[3]-b[2])+1 rows; +1 slack absorbs refresh-time drift.
            # The wide layouts keep wc 128-quantized (the query tensors are
            # (chunk, wc)); the transposed layout ('hat_t') puts window
            # columns on the reduced axis, so wc shrinks in steps of 8 and
            # per-query work drops proportionally.
            wr = min(wr, max(8, _ceil_to(int((boxes[:, 3] - boxes[:, 2]).max()) + 2, 8)))
            wcq = 8 if self.lerp_mode == "hat_t" else _LANES
            wc = min(wc, max(wcq, _ceil_to(int((boxes[:, 1] - boxes[:, 0]).max()) + 2, wcq)))
        if segs is not None and len(segs) > 1:
            self._atlas = build_atlas(
                self.grid, segs, margin=self.margin,
                fill_backend=self.fill_backend, convention=self.convention,
                **fill_kw,
            )
            self._band = None
            self._resampler = AtlasResampler(
                self.grid, self._atlas, chunk=self.chunk,
                win_rows=wr, win_cols=wc, lerp_mode=self.lerp_mode,
            )
            return self._atlas
        r0, nr, c0, nc = self.band_bbox(lons, lats, boxes=boxes)
        self._band = self._fill_one(r0, nr, c0, nc, None, **fill_kw)
        self._atlas = None
        self._resampler = BandResampler(
            self.grid, self._band, chunk=self.chunk,
            win_rows=wr, win_cols=wc, lerp_mode=self.lerp_mode,
        )
        return self._band

    def _fill_one(self, row0, nrows, col0, ncols, masked, **fill_kw):
        """Single-band fill through the one-dispatch jitted path (K=1
        `_fill_pages`).  masked=None syncs once to pick the resample fast path (callers may
        pre-pin it via assume_masked, same as fill_band)."""
        vparams = fill_kw.pop("vparams", None)
        method = fill_kw.pop("method", "kriging")
        model = fill_kw.pop("model", "exponential")
        if masked is None:
            masked = fill_kw.pop("assume_masked", None)
        else:
            fill_kw.pop("assume_masked", None)
        if fill_kw:
            raise TypeError(f"unsupported fill kwargs: {sorted(fill_kw)}")
        planes, vmasks = _fill_pages(
            self.grid, vparams,
            placed=((int(row0), int(col0)),), pr=int(nrows), pc=int(ncols),
            method=method, margin=self.margin,
            fill_backend=self.fill_backend, convention=self.convention,
            model=model,
        )
        if masked is None:
            masked = bool(jnp.min(vmasks) < 0.5)  # 1 sync (prepare only)
        return Band(plane=planes[0], vmask=vmasks[0], masked=bool(masked),
                    row0=int(row0), col0=int(col0))

    def refresh(self, grid: RegularGrid | None = None, **fill_kw):
        """Refill the CURRENT band/atlas geometry (serving mode: new
        observations arrived, queries stay band-confined).  Skips the bbox
        readback/planning.  The masked flag is pinned from the synced build
        (zero extra host round trips) EXCEPT when a new ``grid`` is supplied
        and the pinned flag is False: a replacement grid may have *lost*
        observations, and serving undefined cells through the masked=False
        fast path (which skips the vmask channel) would return zero-filled
        depths as real values.  That case pays one sync to recompute the
        flag; pass ``assume_masked=False`` to assert the new grid's
        observations cover the old ones (accumulate-only streaming) and keep
        the zero-sync path."""
        if self._band is None and self._atlas is None:
            raise RuntimeError("refresh() before prepare()")
        if grid is not None:
            # new observations (e.g. a streaming mosaic snapshot): the
            # escalation engine must see the SAME grid the band is filled
            # from, or escalated queries would answer from stale data
            self.grid = grid
            # rebuild with type() so a caller-supplied TwoTier SUBCLASS is
            # preserved; engines with richer state must be refreshed by the
            # caller and passed back via BandRouter.two_tier before refresh
            self.two_tier = type(self.two_tier)(
                grid, convention=self.convention,
                escalate_cap=self.two_tier.escalate_cap,
            )
            if self._resampler is not None:
                self._resampler.grid = grid
        if self._atlas is not None:
            _, pr, pc = self._atlas.shape
            placed = self._atlas.placed or tuple(
                (int(r), int(c))
                for r, c in np.asarray(self._atlas.origins, np.int64)
            )
            # fill dispatch ONLY: reuse the atlas geometry (origins stay on
            # device, placed tuple is host-cached) — no readbacks/uploads
            vparams = fill_kw.pop("vparams", None)
            method = fill_kw.pop("method", "kriging")
            model = fill_kw.pop("model", "exponential")
            am = fill_kw.pop("assume_masked", None)
            if fill_kw:
                raise TypeError(f"unsupported refresh kwargs: {sorted(fill_kw)}")
            planes, vmasks = _fill_pages(
                self.grid, vparams, placed=placed,
                pr=pr, pc=pc, method=method,
                margin=self.margin, fill_backend=self.fill_backend,
                convention=self.convention, model=model,
            )
            if am is not None:
                masked = bool(am)
            elif grid is not None and not self._atlas.masked:
                masked = bool(jnp.min(vmasks) < 0.5)  # 1 sync; see docstring
            else:
                masked = self._atlas.masked
            self._atlas = dataclasses.replace(
                self._atlas, planes=planes, vmasks=vmasks, placed=placed,
                masked=masked)
            self._resampler.atlas = self._atlas
            return self._atlas
        b = self._band
        pinned = None if (grid is not None and not b.masked) else b.masked
        self._band = self._fill_one(
            b.row0, b.shape[0], b.col0, b.shape[1], pinned, **fill_kw)
        self._resampler.band = self._band
        return self._band

    # -- routing -----------------------------------------------------------
    def _footprint(self):
        """(origins (K,2) int32 device array, page_rows, page_cols) of the
        live band/atlas, or None.  A band is a 1-page atlas here."""
        if self._band is not None:
            b = self._band
            return (jnp.asarray([[b.row0, b.col0]], jnp.int32),
                    int(b.shape[0]), int(b.shape[1]))
        if self._atlas is not None:
            _, pr, pc = self._atlas.shape
            return (jnp.asarray(self._atlas.origins, jnp.int32),
                    int(pr), int(pc))
        return None

    def coherence(self, lons, lats, *, within_footprint: bool = False):
        """Fraction of chunks whose bounding box fits the resample window —
        ONE scalar readback (one jitted reduction).  Uses the LIVE
        resampler's window when one exists (auto_window may have shrunk it
        below the configured win_rows/win_cols).  within_footprint=True
        additionally requires each chunk box to lie inside a live band/atlas
        page (serving mode: a coherent batch OUTSIDE the prepared band would
        resample then escalate ~100% of its queries — correct but ~2x the
        packed cost, so the router must see those chunks as non-fitting)."""
        if self._resampler is not None:
            wr, wc = self._resampler.wr, self._resampler.wc
        else:
            wr, wc = self.win_rows, self.win_cols
        x, y = self.grid.lonlat_to_xy(jnp.asarray(lons, self.grid.dtype),
                                      jnp.asarray(lats, self.grid.dtype))
        fp = self._footprint() if within_footprint else None
        if fp is not None:
            frac = _chunk_fit_frac(x, y, fp[0], chunk=self.chunk, wr=wr,
                                   wc=wc, pr=fp[1], pc=fp[2])
        else:
            frac = _chunk_fit_frac(x, y, None, chunk=self.chunk, wr=wr,
                                   wc=wc, pr=0, pc=0)
        return float(frac)

    def route(self, lons, lats, *, band_ready: bool = False) -> str:
        """'band' or 'packed' from the measured cost model.  band_ready=True
        amortizes the fill (serving mode: many batches per band) and gates
        coherence on the live band/atlas footprint."""
        n = int(np.shape(lons)[0])
        live = self._band is not None or self._atlas is not None
        frac = self.coherence(lons, lats,
                              within_footprint=band_ready and live)
        self.last_coherence = frac
        c = self.cost_ns
        packed = c["packed_per_query"] * n
        if band_ready and (self._band is not None or self._atlas is not None):
            fill = 0.0
            cells = (self._band or self._atlas).cells
        else:
            boxes, segs = self._plan(lons, lats, self.max_bands)
            if segs is not None and len(segs) > 1:
                # pages share the max segment shape (build_atlas)
                pr = max(nr for (_, _, nr, _) in segs)
                pc = max(nc for (_, _, _, nc) in segs)
                cells = len(segs) * pr * pc
            else:
                r0, nr, c0, nc = self.band_bbox(lons, lats, boxes=boxes)
                cells = nr * nc
            fill = c["dispatch"] + c["fill_per_cell"] * cells
        band = (
            fill
            + c["resample_per_query"] * n
            + c["packed_per_query"] * n * (1.0 - frac)
        )
        return "band" if band < packed else "packed"

    # -- execution ---------------------------------------------------------
    def kriging(self, lons, lats, *, force: str | None = None):
        """Serve a batch: band resample with exact-kriging escalation, or the
        packed two-tier path, whichever routes cheaper (or ``force``d)."""
        return self._serve("kriging", lons, lats, force=force)

    def idw(self, lons, lats, *, force: str | None = None):
        """IDW twin of :meth:`kriging` — requires the band/atlas to have
        been prepared with ``method="idw"`` (the resample serves whatever
        fill the band holds; escalation uses the matching two-tier method)."""
        return self._serve("idw", lons, lats, force=force)

    def _serve(self, method: str, lons, lats, *, force: str | None = None):
        choice = force or self.route(lons, lats, band_ready=self._resampler is not None)
        escalate = getattr(self.two_tier, method)
        if choice == "packed":
            return escalate(lons, lats)
        if self._resampler is None:
            self.prepare(lons, lats, method=method)
        elif self._band_method != method:
            raise ValueError(
                f"band/atlas holds a {self._band_method!r} fill; re-prepare "
                f"with method={method!r} before serving {method}")
        z, ok = self._resampler.resample(lons, lats)
        n_bad = int(jnp.sum(~ok))
        self.last_unresolved = n_bad
        if n_bad == 0:
            return z
        # escalate unresolved queries to the exact two-tier path (same padded
        # size-bucketed nonzero scheme as two_tier._run)
        pad_n = max(64, 1 << (n_bad - 1).bit_length())
        pad_n = min(pad_n, int(ok.shape[0]))
        n_chunks = -(-n_bad // pad_n)
        idx = jnp.nonzero(~ok, size=n_chunks * pad_n, fill_value=0)[0]
        lons = jnp.asarray(lons, self.grid.dtype)
        lats = jnp.asarray(lats, self.grid.dtype)
        out = z
        for ci in range(n_chunks):
            sl = jax.lax.dynamic_slice_in_dim(idx, ci * pad_n, pad_n)
            vals = escalate(jnp.take(lons, sl), jnp.take(lats, sl))
            out = out.at[sl].set(vals)
        # the nonzero padding indexes slot 0: restore band values at resolved
        # queries the padded scatter may have overwritten (unlike two_tier the
        # escalated value differs from the fast one here — band semantics)
        return jnp.where(ok, z, out)
