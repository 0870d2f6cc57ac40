"""Fast scattered gathers.

A (row-block fetch + one-hot lane reduction) formulation of 1-element random
gathers: one fetch per 128-lane block, and the one-hot reduce fuses, so no
(N, 128) buffer materializes.  Validity rides along for free by NaN-encoding the plane
before the gather and testing finiteness afterwards — one fetch returns both
(value, mask).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import RegularGrid

_LANES = 128

# the row-block fetch materializes a (N, 128) buffer; above this many indices
# fall back to plain element takes (slower, but O(N) memory)
_FAST_TAKE_LIMIT = 8 << 20


def fast_take(plane: jax.Array, flat_idx: jax.Array) -> jax.Array:
    """plane: (H, W) or flat; flat_idx int32 (N,) or (N, M) -> values.

    Row-block fetch + fused one-hot lane reduction (~2x faster than XLA's
    element gather) while the (N, 128) intermediate fits; element takes
    otherwise."""
    shape = flat_idx.shape
    flat_idx = flat_idx.reshape(-1)
    n = int(flat_idx.shape[0])
    if n > _FAST_TAKE_LIMIT:
        return jnp.take(plane.reshape(-1), flat_idx).reshape(shape)
    flat = plane.reshape(-1)
    pad = (-flat.shape[0]) % _LANES
    if pad:
        flat = jnp.pad(flat, (0, pad))
    pr = flat.reshape(-1, _LANES)
    rows = flat_idx // _LANES
    lanes = flat_idx % _LANES
    rd = jnp.take(pr, rows, axis=0)  # (N, 128) block fetch
    oh = lanes[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, _LANES), 1)
    # select-then-sum, NOT sum(rd * onehot): the plane may carry NaN (packed
    # validity), and 0 * NaN = NaN would poison every block containing one
    return jnp.sum(jnp.where(oh, rd, 0.0), axis=1).reshape(shape)


def nan_plane(grid: RegularGrid) -> jax.Array:
    """Value+validity packed into one plane: invalid cells become NaN.
    Computed per jitted call; XLA CSEs it across multiple fetches."""
    return jnp.where(grid.valid > 0.5, grid.elev, jnp.nan)


def fetch_masked(nanp: jax.Array, jj: jax.Array, ii: jax.Array, width: int):
    """Gather (value, valid) at integer cells from a NaN-encoded plane."""
    v = fast_take(nanp, jj * width + ii)
    ok = ~jnp.isnan(v)
    return jnp.where(ok, v, 0.0), ok
