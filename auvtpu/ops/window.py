"""Windowed k-nearest candidate selection — the vectorized reformulation of the
reference's data-dependent ring search (GridH.cpp:24-140, kernels.cu:26-155).

Instead of walking rings with divergent control flow, every query gathers the
fixed (2R+1)^2 candidate window around its center cell and selects the k
nearest valid cells with ``lax.top_k`` over a masked squared-distance key.
The candidate table is ordered exactly like the reference's collection order,
and ``lax.top_k`` breaks ties by lowest index, so equal-distance candidates
resolve in reference collection order.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from ..golden.engine import ring_offsets
from ..grid import RegularGrid


@lru_cache(maxsize=8)
def _ring_tables_np(max_radius: int):
    offs, seg = ring_offsets(max_radius)
    return offs.astype("int32"), seg.astype("int32")


def ring_tables(max_radius: int = 10):
    """(offsets (M,2) int32, seg_id (M,) int32) in reference collection order
    (center, then ring segments).  Returned as numpy so they embed as
    constants under jit (caching jnp arrays across traces leaks tracers)."""
    return _ring_tables_np(max_radius)


def window_select(
    grid: RegularGrid,
    x: jax.Array,
    y: jax.Array,
    ci: jax.Array,
    cj: jax.Array,
    *,
    k: int = 4,
    max_radius: int = 10,
    convention: str = "reference",
):
    """Select the k nearest valid cells in the (2R+1)^2 window around (ci, cj).

    Args:
      x, y:   float grid-space query coords (N,)
      ci, cj: int32 window center cell (N,)

    Returns dict with:
      val:   (N, k) selected values (garbage where slot >= found)
      ii:    (N, k) int32 column indices
      jj:    (N, k) int32 row indices
      d2:    (N, k) squared index-space distances to cell centers (+0.5)
      found: (N,) int32 number of valid candidates (capped at k)
      slot_ok: (N, k) bool, slot holds a real candidate
    """
    offs, _ = ring_tables(max_radius)
    H, W = grid.shape
    gi = ci[:, None] + offs[None, :, 0]  # (N, M)
    gj = cj[:, None] + offs[None, :, 1]
    inb = (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
    gic = jnp.clip(gi, 0, W - 1)
    gjc = jnp.clip(gj, 0, H - 1)
    from .gathers import fetch_masked, nan_plane

    val, vok = fetch_masked(
        nan_plane(grid), gjc.reshape(-1), gic.reshape(-1), W
    )
    val = val.reshape(gi.shape)
    ok = inb & vok.reshape(gi.shape)

    half = 0.5 if convention == "reference" else 0.0
    di = (gi.astype(x.dtype) + half) - x[:, None]
    dj = (gj.astype(y.dtype) + half) - y[:, None]
    d2 = di * di + dj * dj
    neg = jnp.where(ok, -d2, -jnp.inf)

    top_neg, top_idx = jax.lax.top_k(neg, k)  # ties -> lowest index = collection order
    slot_ok = jnp.isfinite(top_neg)
    m = val.shape[1]
    oh = (
        top_idx[:, :, None] == jax.lax.broadcasted_iota(jnp.int32, (1, 1, m), 2)
    ).astype(val.dtype)
    pick = lambda a: jnp.einsum(
        "nkm,nm->nk", oh, a.astype(val.dtype), precision=jax.lax.Precision.HIGHEST
    )
    return {
        "val": pick(val),
        "ii": pick(gic).astype(jnp.int32),
        "jj": pick(gjc).astype(jnp.int32),
        "d2": -top_neg,
        "found": slot_ok.sum(axis=1).astype(jnp.int32),
        "slot_ok": slot_ok,
    }


def masked_mean(val: jax.Array, slot_ok: jax.Array):
    """Mean of the selected candidates; NaN when none (fallbackAverage
    semantics generalized to k slots)."""
    cnt = slot_ok.sum(axis=1)
    s = jnp.where(slot_ok, val, 0.0).sum(axis=1)
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)
