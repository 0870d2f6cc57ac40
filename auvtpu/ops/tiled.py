"""Tile-streaming scattered ops: sort queries by grid tile, stream one slab
per block of queries, extract stencils with one-hot matmuls.

The round-1 scattered path (ops/packs.py) pays 4-32x grid bytes of HBM for
pre-packed neighborhoods and is bound by the gather unit (~one row-block
fetch per query).  This path replaces gathers with *compute*:

1. queries are bucketed by the grid tile containing their anchor cell and
   sorted (one XLA sort of N keys);
2. each tile's queries are padded to fixed-size blocks, giving a static
   (n_blocks, qblk) layout plus a block->tile map;
3. a ``lax.scan`` over blocks dynamic-slices the tile's (th+2h, tw+2h) slab
   out of a halo-padded plane and extracts every query's stencil as
   ``onehot_row @ slab`` matmuls + rolled one-hot column reductions — no
   gather instructions at all;
4. the shared ``*_from_stencil`` / ``*_from_select`` math (ops/packs.py)
   finishes the method inside the scan body, so only (n_blocks, qblk)
   results materialize.

Memory: one halo-padded copy of the (sentinel-encoded) grid plus the sorted
query copies — ~1.1x grid bytes + ~12 bytes/query, vs the bicubic pack's 16x
or the window pack's 32x grid bytes.  Replaces the per-query gather bound
with matrix work.

Matches the same reference kernels as ops/scattered.py
(/root/reference/code/src/kernels.cu:173-234, 246-372, 403-546) under v2
selection semantics; parity is tested against golden_v2 and the packed ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import RegularGrid
from .packs import (
    _SENTINEL,
    _sentinel_plane,
    bilinear_from_stencil,
    bicubic_from_stencil,
    idw_from_select,
    kriging_from_select,
    window_offsets,
    window_select_from_stencil,
)


def _normalize(grid: RegularGrid, lons, lats):
    from .scattered import _normalize as norm

    return norm(grid, lons, lats)


# ---------------------------------------------------------------------------
# partition: bucket queries by tile, pad each bucket to qblk-sized blocks
# ---------------------------------------------------------------------------

def _partition(x, y, H, W, *, anchor: str, tile, qblk: int):
    """Static-shape tile partition.

    Returns (block_tile (nb,), qx (nb, qblk), qy (nb, qblk),
    src (nb, qblk) int32 original index, -1 for pad lanes).
    nb is the static worst case: every tile wastes < qblk pad lanes.

    Cost note: the argsort + scatters amount to 2-4 full-batch random
    permutations (~8 ns/element each on the gather unit) — roughly the cost
    of the whole pack-fetch path for a one-shot random batch.  Partition
    therefore pays off only when it AMORTIZES: repeated serving of a fixed
    query layout (the real-time AUV map window), or spatially-coherent
    streams.  Use :func:`tiled_partition` + the ``*_run`` variants there;
    the one-shot wrappers below include it for honest single-batch numbers.
    """
    th, tw = tile
    n_ty = -(-H // th)
    n_tx = -(-W // tw)
    n_tiles = n_ty * n_tx
    n = x.shape[0]
    if anchor == "round":
        ax = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
        ay = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, H - 1)
    else:
        ax = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 1)
        ay = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 1)
    tid = (ay // th) * n_tx + (ax // tw)

    order = jnp.argsort(tid, stable=True)
    tid_s = jnp.take(tid, order)
    counts = jnp.bincount(tid, length=n_tiles)
    blocks_per_tile = -(-counts // qblk)  # ceil
    cum_blocks = jnp.cumsum(blocks_per_tile)
    pad_start = qblk * jnp.concatenate([jnp.zeros(1, cum_blocks.dtype), cum_blocks[:-1]])
    seg_start = jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]]
    )
    dst = jnp.take(pad_start, tid_s) + (jnp.arange(n) - jnp.take(seg_start, tid_s))

    nb = (n + n_tiles * (qblk - 1) + qblk - 1) // qblk  # static worst case
    m = nb * qblk
    qx = jnp.zeros(m, x.dtype).at[dst].set(jnp.take(x, order))
    qy = jnp.zeros(m, y.dtype).at[dst].set(jnp.take(y, order))
    src = jnp.full(m, -1, jnp.int32).at[dst].set(order.astype(jnp.int32))
    block_tile = jnp.clip(
        jnp.searchsorted(cum_blocks, jnp.arange(nb), side="right"), 0, n_tiles - 1
    ).astype(jnp.int32)
    return (
        block_tile,
        qx.reshape(nb, qblk),
        qy.reshape(nb, qblk),
        src.reshape(nb, qblk),
        n_tx,
    )


# ---------------------------------------------------------------------------
# slab stencil extraction (one-hot row matmuls + rolled one-hot column reduces)
# ---------------------------------------------------------------------------

def _slab_rows(slab, ly, n_rows: int):
    """Rows ly+0..ly+n_rows-1 of the slab per query, via one-hot matmuls.

    slab (SH, SW); ly (Q,) int32 local top row.  Returns list of (Q, SW).
    Out-of-range rows produce zeros (pad lanes; dropped at scatter-back).
    """
    sh = slab.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (ly.shape[0], sh), 1)
    rows = []
    for r in range(n_rows):
        oh = (iota == (ly + r)[:, None]).astype(slab.dtype)
        rows.append(
            jax.lax.dot_general(
                oh, slab, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=slab.dtype,
            )
        )
    return rows


def _col_pick(row_vals, lx, col: int):
    """row_vals (Q, SW) -> value at column lx+col per query (one-hot reduce)."""
    sw = row_vals.shape[1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (lx.shape[0], sw), 1)
    oh = (iota == (lx + col)[:, None]).astype(row_vals.dtype)
    return (row_vals * oh).sum(axis=1)


def _nanify(st):
    return jnp.where(st >= 0.5 * _SENTINEL, jnp.nan, st)


def _padded_plane(grid: RegularGrid, halo: int, clamp: bool, tile):
    """Sentinel-encoded plane padded by ``halo`` plus round-up to whole tiles
    (so the last tile row/column's slab slice is never start-clamped by
    dynamic_slice): edge-replicated for clamped stencils (bilinear/bicubic
    index clamping), sentinel for window candidates (out-of-grid = invalid)."""
    src = _sentinel_plane(grid)
    H, W = src.shape
    th, tw = tile
    pad_b = (-H) % th + halo
    pad_r = (-W) % tw + halo
    if clamp:
        return jnp.pad(src, ((halo, pad_b), (halo, pad_r)), mode="edge")
    return jnp.pad(
        src, ((halo, pad_b), (halo, pad_r)), mode="constant", constant_values=_SENTINEL
    )


# ---------------------------------------------------------------------------
# split API: partition once, run many (amortized serving path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("anchor", "tile", "qblk"))
def tiled_partition(grid: RegularGrid, lons, lats, *, anchor: str = "round", tile=(128, 256), qblk: int = 2048):
    """Partition a query batch once; reuse across calls with the ``*_run``
    ops while the grid updates (the real-time AUV serving pattern: the map
    mosaic changes every swath, the query layout around the vehicle doesn't).

    anchor='floor' for bilinear/bicubic, 'round' for window (kriging/IDW)
    ops.  Returns a pytree dict usable by tiled_*_run."""
    x, y, oob = _normalize(grid, lons, lats)
    H, W = grid.shape
    block_tile, qx, qy, src, _ = _partition(x, y, H, W, anchor=anchor, tile=tile, qblk=qblk)
    return {"block_tile": block_tile, "qx": qx, "qy": qy, "src": src, "oob": oob}


# ---------------------------------------------------------------------------
# tiled ops
# ---------------------------------------------------------------------------

def _scan_blocks(plane, block_tile, qx, qy, body, *, tile, halo: int, n_tx: int):
    th, tw = tile
    sh, sw = th + 2 * halo, tw + 2 * halo

    def step(_, xs):
        t, bx, by = xs
        r0 = (t // n_tx) * th
        c0 = (t % n_tx) * tw
        slab = jax.lax.dynamic_slice(plane, (r0, c0), (sh, sw))
        return None, body(slab, bx, by, r0, c0)

    _, out = jax.lax.scan(step, None, (block_tile, qx, qy))
    return out


def _scatter_back(n, vals, src, oob):
    out = jnp.full((n,), jnp.nan, vals.dtype)
    # pad lanes carry src = -1, which scatter would WRAP to index n-1 and
    # clobber the last query — route them to a truly-dropped scrap index
    f = jnp.where(src < 0, n, src).reshape(-1)
    out = out.at[f].set(vals.reshape(-1), mode="drop")
    return jnp.where(oob, jnp.nan, out)


@partial(jax.jit, static_argnames=("tile", "qblk"))
def tiled_bilinear_run(grid: RegularGrid, tb, *, tile=(128, 256), qblk: int = 2048):
    """Bilinear (kernels.cu:173-234 semantics) over a prebuilt partition."""
    H, W = grid.shape
    halo = 1
    n_tx = -(-W // tile[1])
    plane = _padded_plane(grid, halo, clamp=True, tile=tile)

    def body(slab, bx, by, r0, c0):
        ly0 = jnp.floor(by).astype(jnp.int32) - r0 + halo
        lx0 = jnp.floor(bx).astype(jnp.int32) - c0 + halo
        r = _slab_rows(slab, ly0, 2)
        st = jnp.stack(
            [_col_pick(r[0], lx0, 0), _col_pick(r[0], lx0, 1),
             _col_pick(r[1], lx0, 0), _col_pick(r[1], lx0, 1)],
            axis=1,
        )
        return bilinear_from_stencil(_nanify(st), bx, by, jnp.zeros_like(bx, bool))

    vals = _scan_blocks(plane, tb["block_tile"], tb["qx"], tb["qy"], body, tile=tile, halo=halo, n_tx=n_tx)
    return _scatter_back(tb["oob"].shape[0], vals, tb["src"], tb["oob"])


def tiled_bilinear(grid: RegularGrid, lons, lats, *, tile=(128, 256), qblk: int = 2048):
    tb = tiled_partition(grid, lons, lats, anchor="floor", tile=tile, qblk=qblk)
    return tiled_bilinear_run(grid, tb, tile=tile, qblk=qblk)


@partial(jax.jit, static_argnames=("tile", "qblk"))
def tiled_bicubic_run(grid: RegularGrid, tb, *, tile=(128, 256), qblk: int = 2048):
    """Clean-stencil Catmull-Rom (kernels.cu:246-254; NaN taps propagate)."""
    H, W = grid.shape
    halo = 2
    n_tx = -(-W // tile[1])
    plane = _padded_plane(grid, halo, clamp=True, tile=tile)

    def body(slab, bx, by, r0, c0):
        ly0 = jnp.floor(by).astype(jnp.int32) - r0 + halo - 1
        lx0 = jnp.floor(bx).astype(jnp.int32) - c0 + halo - 1
        rows = _slab_rows(slab, ly0, 4)
        st = jnp.stack(
            [_col_pick(rows[m], lx0, nn) for m in range(4) for nn in range(4)], axis=1
        )
        return bicubic_from_stencil(_nanify(st), bx, by, jnp.zeros_like(bx, bool))

    vals = _scan_blocks(plane, tb["block_tile"], tb["qx"], tb["qy"], body, tile=tile, halo=halo, n_tx=n_tx)
    return _scatter_back(tb["oob"].shape[0], vals, tb["src"], tb["oob"])


def tiled_bicubic(grid: RegularGrid, lons, lats, *, tile=(128, 256), qblk: int = 2048):
    tb = tiled_partition(grid, lons, lats, anchor="floor", tile=tile, qblk=qblk)
    return tiled_bicubic_run(grid, tb, tile=tile, qblk=qblk)


def _tiled_window_run(grid, tb, finish, *, k, window_radius, convention, tile, qblk):
    H, W = grid.shape
    R = window_radius
    halo = R
    n_tx = -(-W // tile[1])
    plane = _padded_plane(grid, halo, clamp=False, tile=tile)
    offs = window_offsets(R, convention)  # reference collection order

    def body(slab, bx, by, r0, c0):
        ci = jnp.clip(jnp.floor(bx + 0.5).astype(jnp.int32), 0, W - 1)
        cj = jnp.clip(jnp.floor(by + 0.5).astype(jnp.int32), 0, H - 1)
        # local top-left of the (2R+1)^2 patch (clipped round anchor = ci/cj)
        ly0 = cj - r0 + halo - R
        lx0 = ci - c0 + halo - R
        rows = _slab_rows(slab, ly0, 2 * R + 1)
        st = jnp.stack(
            [_col_pick(rows[dy + R], lx0, dx + R) for dy, dx in offs], axis=1
        )
        sel = window_select_from_stencil(
            _nanify(st), bx, by, jnp.zeros_like(bx, bool), ci, cj,
            k=k, window_radius=R, convention=convention,
        )
        return finish(sel, bx, by)

    vals = _scan_blocks(plane, tb["block_tile"], tb["qx"], tb["qy"], body, tile=tile, halo=halo, n_tx=n_tx)
    return _scatter_back(tb["oob"].shape[0], vals, tb["src"], tb["oob"])


@partial(jax.jit, static_argnames=("window_radius", "convention", "tile", "qblk"))
def tiled_kriging_run(grid: RegularGrid, tb, *, window_radius: int = 2, vparams=None, convention: str = "reference", tile=(128, 256), qblk: int = 2048):
    """Window top-4 + 5x5 kriging solve (kernels.cu:403-546, v2 selection)."""

    def finish(sel, bx, by):
        dt = grid.dtype
        qlon = grid.min_lon + bx * jnp.asarray(grid.lon_step, dt)
        qlat = grid.min_lat + by * jnp.asarray(grid.lat_step, dt)
        return kriging_from_select(grid, qlon, qlat, sel, vparams=vparams, convention=convention)

    return _tiled_window_run(
        grid, tb, finish,
        k=4, window_radius=window_radius, convention=convention, tile=tile, qblk=qblk,
    )


def tiled_kriging(grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None, convention: str = "reference", tile=(128, 256), qblk: int = 2048):
    tb = tiled_partition(grid, lons, lats, anchor="round", tile=tile, qblk=qblk)
    return tiled_kriging_run(
        grid, tb, window_radius=window_radius, vparams=vparams,
        convention=convention, tile=tile, qblk=qblk,
    )


@partial(jax.jit, static_argnames=("k", "power", "window_radius", "convention", "tile", "qblk"))
def tiled_idw_run(grid: RegularGrid, tb, *, k: int = 8, power: float = 2.0, window_radius: int = 2, convention: str = "reference", tile=(128, 256), qblk: int = 2048):
    """k-nearest IDW over the window (the north-star kernel), tile-streamed."""

    def finish(sel, bx, by):
        return idw_from_select(sel, power=power)

    return _tiled_window_run(
        grid, tb, finish,
        k=k, window_radius=window_radius, convention=convention, tile=tile, qblk=qblk,
    )


def tiled_idw(grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, window_radius: int = 2, convention: str = "reference", tile=(128, 256), qblk: int = 2048):
    tb = tiled_partition(grid, lons, lats, anchor="round", tile=tile, qblk=qblk)
    return tiled_idw_run(
        grid, tb, k=k, power=power, window_radius=window_radius,
        convention=convention, tile=tile, qblk=qblk,
    )
