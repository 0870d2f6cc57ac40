"""Two-tier scattered interpolation: packed fast path + rare escalation.

SURVEY.md §7 'Hard parts' flags the divergence risk of making every query pay
the full 441-cell window.  The production answer: a radius-2 stencil pack
resolves k nearest valid neighbors for ~every query at one gather each; the
rare queries whose 5x5 window holds fewer than k valid cells (probability
~f^20 at removal f) are collected host-side, padded to a fixed shape, and
re-run through the radius-10 window op — two compiled programs and a single
host sync per batch, instead of a 441-wide gather for everyone.

Exact v2 semantics: a query is 'resolved' when its k-th selected neighbor is
strictly closer than the nearest conceivable cell outside the 5x5 window
(see _outside_min_d2) — then the radius-2 and radius-10 selections provably
coincide.  Everything else escalates.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..grid import RegularGrid
from .packs import StencilPack, packed_idw, packed_kriging, packed_window_select
from .scattered import scattered_idw, scattered_kriging


@partial(jax.jit, static_argnames=("k", "conv", "thresh"))
def _resolved_mask_jit(pack, grid, lons, lats, *, k, conv, thresh):
    sel = packed_window_select(
        pack, grid, lons, lats, k=k, window_radius=2, convention=conv
    )
    # resolved iff k candidates were found AND the k-th beats the nearest
    # conceivable outside-window cell (ties resolve to the inside cell:
    # collection order sorts smaller rings first)
    m = (sel["found"] >= k) & (sel["d2"][:, k - 1] < thresh)
    return m, jnp.sum(~m)


class TwoTierInterpolator:
    """Reusable scattered-query engine over a (possibly masked) grid."""

    def __init__(self, grid: RegularGrid, *, convention: str = "reference", escalate_cap: int = 1 << 14):
        """The fast path is the packed top_k + one-hot select of ops.packs;
        escalation and the resolved mask give identical v2 semantics."""
        self.grid = grid
        self.convention = convention
        self.pack = StencilPack(grid, window_radius=2)
        self.escalate_cap = escalate_cap

    def _outside_min_d2(self):
        """Infimum of the squared distance from ANY query position inside the
        center cell (fractional offset f in [-0.5, 0.5]^2) to any cell OUTSIDE
        the radius-2 window.  Per-axis lower bound for candidate offset d:
        reference convention |d + 0.5 - f| >= max(0, |d + 0.5| - 0.5);
        centered |d - f| >= max(0, |d| - 0.5).  A radius-3 edge cell can come
        as close as d^2 = 4.0 (reference) / 6.25 (centered)."""
        from .dense import sorted_offsets

        dxs, dys, _ = sorted_offsets(10, self.convention)
        outside = (np.abs(dxs) > 2) | (np.abs(dys) > 2)
        half = 0.5 if self.convention == "reference" else 0.0

        def lb(d):
            return np.maximum(0.0, np.abs(d + half) - 0.5)

        lo2 = lb(dxs[outside].astype(np.float64)) ** 2 + lb(dys[outside].astype(np.float64)) ** 2
        return float(lo2.min())

    def _resolved_mask(self, lons, lats, k):
        return _resolved_mask_jit(
            self.pack.window, self.grid, lons, lats,
            k=k, conv=self.convention, thresh=self._outside_min_d2(),
        )

    def _run(self, fast_fn, slow_fn, lons, lats, k):
        lons = jnp.asarray(lons, self.grid.dtype)
        lats = jnp.asarray(lats, self.grid.dtype)
        fast = fast_fn(lons, lats)
        mask, bad_count = self._resolved_mask(lons, lats, k)
        n_bad = int(bad_count)  # the ONLY host sync (a scalar)
        if n_bad == 0:
            return fast
        # escalation stays fully on device: a size-padded nonzero finds the
        # unresolved indices (padded with index 0 — harmless: a resolved
        # query's radius-10 value provably equals its fast value, so the
        # duplicate scatter is a no-op), the slow path recomputes them in
        # chunks of at most ``escalate_cap`` queries, and scatters merge.
        # The cap bounds the escalated intermediates ((chunk, 441) candidate
        # tensors) regardless of batch size; pad/chunk counts snap to powers
        # of two to bound the number of compiled shapes.
        cap = max(64, int(self.escalate_cap))
        pad_n = max(64, 1 << (n_bad - 1).bit_length())
        pad_n = min(pad_n, mask.shape[0], cap)
        n_chunks = -(-n_bad // pad_n)
        n_chunks_p = 1 << (n_chunks - 1).bit_length()
        idx = jnp.nonzero(~mask, size=n_chunks_p * pad_n, fill_value=0)[0]
        out = fast
        for c in range(n_chunks):
            sl = jax.lax.dynamic_slice_in_dim(idx, c * pad_n, pad_n)
            slow = slow_fn(jnp.take(lons, sl), jnp.take(lats, sl))
            if isinstance(out, tuple):
                out = tuple(o.at[sl].set(s) for o, s in zip(out, slow))
            else:
                out = out.at[sl].set(slow)
        return out

    def kriging(self, lons, lats, *, return_variance: bool = False):
        """return_variance=True also returns the ordinary-kriging prediction
        variance per query (same two-tier semantics: the variance of
        whichever tier produced the prediction; NaN at fallback queries)."""
        fast = lambda lo, la: packed_kriging(
            self.pack.window, self.grid, lo, la, window_radius=2,
            convention=self.convention, with_variance=return_variance,
        )
        return self._run(
            fast,
            lambda lo, la: scattered_kriging(
                self.grid, lo, la, max_radius=10, convention=self.convention,
                with_variance=return_variance,
            ),
            lons, lats, k=4,
        )

    def idw(self, lons, lats, k: int = 8):
        fast = lambda lo, la: packed_idw(
            self.pack.window, self.grid, lo, la, k=k,
            window_radius=2, convention=self.convention,
        )
        return self._run(
            fast,
            lambda lo, la: scattered_idw(
                self.grid, lo, la, k=k, max_radius=10, convention=self.convention
            ),
            lons, lats, k=k,
        )
