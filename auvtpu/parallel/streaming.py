"""Row-band-sharded streaming mosaic: streaming x spatial sharding composed.

SURVEY.md §5's remaining scale-up scenario: the survey mosaic is too big for
one chip's HBM *while* observations stream in.  The composition keeps
:class:`auvtpu.streaming.StreamingInterpolator`'s exact semantics (bit-for-bit
on every ingest/fill surface — pinned by tests/test_streaming_sharded.py) with
the planes living as row bands over a ``jax.sharding.Mesh``:

- **ingest** replicates the small packed staging buffer to every device; each
  band scatters only the observations whose rows it owns (out-of-band lanes
  drop on the scrap index), with the same sorted last-write-wins dedup — a
  cell is owned by exactly one band, so the winners are identical to the
  single-device program's;
- **window_fill** assembles the (win_h, win_w) crop around the vehicle from
  the owning band(s) by a one-hot-masked ``psum`` over the mesh (disjoint
  contributions + zeros add bit-exactly), then runs literally the same
  fill program (:func:`auvtpu.streaming._fill_window_planes`) on the
  replicated crop;
- **fit_variogram** psums per-band variogram pair sums (cross-band partners
  via the multi-hop halo collector, parallel.spatial._collect_halo) — the
  distributed twin of the whole-plane fit.

Reference scope note: the reference has nothing distributed (SURVEY.md §2
'Parallelism & distribution'); this is the multi-device scale-out of its
real-time AUV workload (title use case), not a port of any reference code.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..streaming import StreamingInterpolator, _fill_window_planes
from .spatial import _collect_halo


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("mesh", "blk"))
def _ingest_batch_sharded(elev, valid, obs, n_live, mesh, blk):
    """Sharded twin of streaming._ingest_batch: the packed (cap, 3) staging
    buffer is replicated; each band scatters its own rows, in place.

    Winner selection is identical to the single-device program: every mosaic
    cell belongs to exactly one band, so per-band sorted last-write-wins
    picks the same (cell, arrival) winners the global sort would."""
    W = elev.shape[1]

    def local(e, v, o, nl):
        idx = jax.lax.axis_index("dp")
        r_band = idx * blk
        cap = o.shape[0]
        rows = o[:, 0].astype(jnp.int32) - r_band
        cols = o[:, 1].astype(jnp.int32)
        vals = o[:, 2]
        nloc = blk * W
        live = (
            (jnp.arange(cap, dtype=jnp.int32) < nl)
            & (rows >= 0)
            & (rows < blk)
        )
        flat = jnp.where(live, rows * W + cols, nloc)
        order = jnp.arange(cap, dtype=jnp.int32)
        sf, _, sv = jax.lax.sort((flat, order, vals), num_keys=2)
        nxt = jnp.concatenate([sf[1:], jnp.full((1,), -1, sf.dtype)])
        winner = (sf != nxt) & (sf < nloc)
        f = jnp.where(winner, sf, nloc)
        ev = e.reshape(-1).at[f].set(sv, mode="drop").reshape(e.shape)
        ok = v.reshape(-1).at[f].max(winner.astype(v.dtype), mode="drop")
        return ev, ok.reshape(v.shape)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P(), P()),
        out_specs=(P("dp", None), P("dp", None)),
    )
    return fn(elev, valid, obs, n_live)


@partial(
    jax.jit,
    static_argnames=("mesh", "blk", "meta", "win", "method", "k", "max_radius", "steps", "variance", "backend"),
)
def _window_fill_sharded(
    elev, valid, meta, r0, c0, vparams, *, mesh, blk, win, method, k, max_radius, steps, variance=False, backend="xla"
):
    """Assemble the window crop from the owning band(s), then run the SAME
    fill program the single-device path runs (_fill_window_planes) on the
    replicated crop.  Crop assembly is a psum of disjoint one-hot-masked
    contributions — bit-exact (x + 0 = x), any band count."""
    wh, ww = win
    n = len(mesh.devices.flat)

    def crop(e, v):
        idx = jax.lax.axis_index("dp")
        r_band = idx * blk
        # pad so the dynamic_slice start is in range whenever this band
        # overlaps the crop; non-overlapping bands are fully masked anyway
        ep = jnp.pad(e, ((wh, wh), (0, 0)))
        vp = jnp.pad(v, ((wh, wh), (0, 0)))
        start = r0 - r_band + wh
        se = jax.lax.dynamic_slice(ep, (start, c0), (wh, ww))
        sv = jax.lax.dynamic_slice(vp, (start, c0), (wh, ww))
        gr = r0 + jax.lax.broadcasted_iota(jnp.int32, (wh, 1), 0)
        own = (gr >= r_band) & (gr < r_band + blk)
        se = jnp.where(own, se, 0.0)
        sv = jnp.where(own, sv, 0.0)
        return jax.lax.psum(se, "dp"), jax.lax.psum(sv, "dp")

    fn = shard_map(
        crop,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=(P(), P()),
    )
    we, wv = fn(elev, valid)
    return _fill_window_planes(
        we, wv, meta, r0, c0, vparams,
        method=method, k=k, max_radius=max_radius, steps=steps, variance=variance,
        backend=backend,
    )


@partial(jax.jit, static_argnames=("mesh", "blk", "max_lag", "n_bins", "steps"))
def _fit_variogram_sharded(elev, valid, mesh, blk, max_lag, n_bins, steps):
    """Distributed exponential-variogram fit: per-band pair sums (cross-band
    partners from the 'after' halo; pairs counted once via the half-plane
    convention) psum'd over the mesh, then the replicated Gauss-Newton fit —
    the fit stage of parallel.spatial.sharded_fit_fill on streaming planes."""
    from ..variogram import _bin_table, fit_exponential, pair_sums

    n = len(mesh.devices.flat)
    _, _, _, centers = _bin_table(max_lag, n_bins)

    def local(e, v):
        bot_e = _collect_halo(e, max_lag, "dp", n, "after", axis=0)
        bot_v = _collect_halo(v, max_lag, "dp", n, "after", axis=0)
        band_e = jnp.concatenate([e, bot_e], axis=0)
        band_v = jnp.concatenate([v, bot_v], axis=0)
        s, c = pair_sums(band_e, band_v, blk, max_lag=max_lag, n_bins=n_bins)
        s = jax.lax.psum(s, "dp")
        c = jax.lax.psum(c, "dp")
        gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
        step = jnp.asarray(0.5 * (abs(steps[0]) + abs(steps[1])), e.dtype)
        lags = jnp.asarray(centers, e.dtype) * step
        return fit_exponential(lags, gamma, c)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=P(),
    )
    return fn(elev, valid)


class ShardedStreamingInterpolator(StreamingInterpolator):
    """StreamingInterpolator whose mosaic planes are row-band-sharded over a
    mesh — the scale-out path for survey mosaics larger than one chip's HBM.

    Same API and (bit-for-bit) same results as the single-device class; the
    host staging ring buffer is unchanged.  Rows are padded to a multiple of
    the band count; the pad rows are permanently invalid and invisible
    (``shape``/``snapshot``/``save`` report the logical mosaic).
    """

    def __init__(self, shape, extent, mesh: Mesh, **kw):
        super().__init__(shape, extent, **kw)
        if "dp" not in mesh.axis_names:
            raise ValueError(f"mesh must have a 'dp' axis, got {mesh.axis_names}")
        self.mesh = mesh
        n = len(mesh.devices.flat)
        H, W = shape
        if self.window[0] > H or self.window[1] > W:
            raise ValueError(f"window {self.window} larger than mosaic {shape}")
        pad = (-H) % n
        self._n_rows = H
        self._blk = (H + pad) // n
        dtype = self.elev.dtype
        sh = NamedSharding(mesh, P("dp", None))
        self.elev = jax.device_put(jnp.zeros((H + pad, W), dtype), sh)
        self.valid = jax.device_put(jnp.zeros((H + pad, W), dtype), sh)

    @property
    def shape(self):
        return (self._n_rows, self.elev.shape[1])

    def flush(self) -> int:
        m = self._staged
        if m == 0:
            return 0
        # .copy(): see StreamingInterpolator.flush — jnp.asarray may alias
        # the mutable numpy staging buffer on the CPU backend
        self.elev, self.valid = _ingest_batch_sharded(
            self.elev, self.valid,
            jnp.asarray(self._stage.copy()), jnp.asarray(m, jnp.int32),
            self.mesh, self._blk,
        )
        self._staged = 0
        return m

    def _window(self, center_row: int, center_col: int, *, method: str, variance: bool):
        self.flush()
        wh, ww = self.window
        H, W = self.shape
        r0 = int(np.clip(center_row - wh // 2, 0, H - wh))
        c0 = int(np.clip(center_col - ww // 2, 0, W - ww))
        return _window_fill_sharded(
            self.elev, self.valid, self._meta,
            jnp.asarray(r0, jnp.int32), jnp.asarray(c0, jnp.int32),
            self._vparams,
            mesh=self.mesh, blk=self._blk,
            win=self.window, method=method, k=self.k,
            max_radius=self.max_radius, steps=self._steps, variance=variance,
            backend=self.backend,
        ), (r0, c0)

    def fit_variogram(self, *, max_lag: int = 10, n_bins: int = 10):
        self.flush()
        self._vparams = _fit_variogram_sharded(
            self.elev, self.valid, self.mesh, self._blk, max_lag, n_bins, self._steps
        )
        return self._vparams

    def snapshot(self) -> np.ndarray:
        self.flush()
        elev = np.asarray(self.elev, np.float64)[: self._n_rows]
        valid = np.asarray(self.valid)[: self._n_rows] > 0.5
        return np.where(valid, elev, np.nan)

    def save(self, path: str) -> None:
        """Checkpoint the logical (unpadded) mosaic — the artifact is
        interchangeable with the single-device class's."""
        self.flush()
        vp = (
            np.asarray([float(v) for v in self._vparams], np.float64)
            if self._vparams is not None
            else np.zeros((0,), np.float64)
        )
        np.savez_compressed(
            path,
            elev=np.asarray(self.elev)[: self._n_rows],
            valid=np.asarray(self.valid)[: self._n_rows],
            extent=np.asarray(self._meta, np.float64),
            window=np.asarray(self.window, np.int64),
            method=np.asarray(self.method),
            k=np.asarray(self.k),
            max_radius=np.asarray(self.max_radius),
            vparams=vp,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, *, swath_cap: int = 4096, stage_slots: int = 16):
        """Resume a checkpoint (from either streaming class) onto a mesh."""
        from ..config import Extent

        d = np.load(path)
        min_lon, max_lon, min_lat, max_lat = (float(v) for v in d["extent"])
        si = cls(
            d["elev"].shape,
            Extent(min_lon, max_lon, min_lat, max_lat),
            mesh,
            swath_cap=swath_cap,
            stage_slots=stage_slots,
            window=tuple(int(v) for v in d["window"]),
            method=str(d["method"]),
            k=int(d["k"]),
            max_radius=int(d["max_radius"]),
            dtype=d["elev"].dtype,
        )
        H = d["elev"].shape[0]
        pad = si.elev.shape[0] - H
        sh = NamedSharding(mesh, P("dp", None))
        ep = np.concatenate([d["elev"], np.zeros((pad, d["elev"].shape[1]), d["elev"].dtype)])
        vp_ = np.concatenate([d["valid"], np.zeros((pad, d["valid"].shape[1]), d["valid"].dtype)])
        si.elev = jax.device_put(jnp.asarray(ep), sh)
        si.valid = jax.device_put(jnp.asarray(vp_), sh)
        vp = d["vparams"] if "vparams" in d.files else np.zeros((0,))
        if len(vp) == 3:
            si._vparams = tuple(jnp.asarray(v, si.elev.dtype) for v in vp)
        return si


# ---------------------------------------------------------------------------
# 2-D block-sharded streaming mosaic
# ---------------------------------------------------------------------------

@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("mesh", "blk_r", "blk_c"))
def _ingest_batch_sharded2d(elev, valid, obs, n_live, mesh, blk_r, blk_c):
    """2-D twin of _ingest_batch_sharded: each (dy, dx) block scatters the
    observations whose (row, col) it owns; winner selection unchanged."""

    def local(e, v, o, nl):
        iy = jax.lax.axis_index("dy")
        ix = jax.lax.axis_index("dx")
        cap = o.shape[0]
        rows = o[:, 0].astype(jnp.int32) - iy * blk_r
        cols = o[:, 1].astype(jnp.int32) - ix * blk_c
        vals = o[:, 2]
        nloc = blk_r * blk_c
        live = (
            (jnp.arange(cap, dtype=jnp.int32) < nl)
            & (rows >= 0) & (rows < blk_r)
            & (cols >= 0) & (cols < blk_c)
        )
        flat = jnp.where(live, rows * blk_c + cols, nloc)
        order = jnp.arange(cap, dtype=jnp.int32)
        sf, _, sv = jax.lax.sort((flat, order, vals), num_keys=2)
        nxt = jnp.concatenate([sf[1:], jnp.full((1,), -1, sf.dtype)])
        winner = (sf != nxt) & (sf < nloc)
        f = jnp.where(winner, sf, nloc)
        ev = e.reshape(-1).at[f].set(sv, mode="drop").reshape(e.shape)
        ok = v.reshape(-1).at[f].max(winner.astype(v.dtype), mode="drop")
        return ev, ok.reshape(v.shape)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dy", "dx"), P("dy", "dx"), P(), P()),
        out_specs=(P("dy", "dx"), P("dy", "dx")),
    )
    return fn(elev, valid, obs, n_live)


@partial(
    jax.jit,
    static_argnames=("mesh", "blk_r", "blk_c", "meta", "win", "method", "k", "max_radius", "steps", "variance", "backend"),
)
def _window_fill_sharded2d(
    elev, valid, meta, r0, c0, vparams, *, mesh, blk_r, blk_c, win, method, k, max_radius, steps, variance=False, backend="xla"
):
    """2-D twin of _window_fill_sharded: the crop is assembled from the
    owning block(s) by a one-hot-masked psum over BOTH mesh axes, then the
    same replicated fill program runs."""
    wh, ww = win

    def crop(e, v):
        iy = jax.lax.axis_index("dy")
        ix = jax.lax.axis_index("dx")
        r_b = iy * blk_r
        c_b = ix * blk_c
        ep = jnp.pad(e, ((wh, wh), (ww, ww)))
        vp = jnp.pad(v, ((wh, wh), (ww, ww)))
        se = jax.lax.dynamic_slice(ep, (r0 - r_b + wh, c0 - c_b + ww), (wh, ww))
        sv = jax.lax.dynamic_slice(vp, (r0 - r_b + wh, c0 - c_b + ww), (wh, ww))
        gr = r0 + jax.lax.broadcasted_iota(jnp.int32, (wh, ww), 0)
        gc = c0 + jax.lax.broadcasted_iota(jnp.int32, (wh, ww), 1)
        own = (gr >= r_b) & (gr < r_b + blk_r) & (gc >= c_b) & (gc < c_b + blk_c)
        se = jnp.where(own, se, 0.0)
        sv = jnp.where(own, sv, 0.0)
        return (
            jax.lax.psum(jax.lax.psum(se, "dy"), "dx"),
            jax.lax.psum(jax.lax.psum(sv, "dy"), "dx"),
        )

    fn = shard_map(
        crop,
        mesh=mesh,
        in_specs=(P("dy", "dx"), P("dy", "dx")),
        out_specs=(P(), P()),
    )
    we, wv = fn(elev, valid)
    return _fill_window_planes(
        we, wv, meta, r0, c0, vparams,
        method=method, k=k, max_radius=max_radius, steps=steps, variance=variance,
        backend=backend,
    )


@partial(jax.jit, static_argnames=("mesh", "blk_r", "blk_c", "max_lag", "n_bins", "steps"))
def _fit_variogram_sharded2d(elev, valid, mesh, blk_r, blk_c, max_lag, n_bins, steps):
    """2-D twin of _fit_variogram_sharded: column halos on BOTH sides (the
    half-plane offsets reach dx in [-L, L]), then the 'after' row halo on the
    column-extended block (carrying the corners), then pair_sums_2d."""
    from ..variogram import _bin_table, fit_exponential, pair_sums_2d

    ny, nx = mesh.devices.shape
    L = max_lag
    _, _, _, centers = _bin_table(max_lag, n_bins)

    def local(e, v):
        eL = _collect_halo(e, L, "dx", nx, "before", axis=1)
        eR = _collect_halo(e, L, "dx", nx, "after", axis=1)
        vL = _collect_halo(v, L, "dx", nx, "before", axis=1)
        vR = _collect_halo(v, L, "dx", nx, "after", axis=1)
        e2 = jnp.concatenate([eL, e, eR], axis=1)
        v2 = jnp.concatenate([vL, v, vR], axis=1)
        bot_e = _collect_halo(e2, L, "dy", ny, "after", axis=0)
        bot_v = _collect_halo(v2, L, "dy", ny, "after", axis=0)
        be = jnp.concatenate([e2, bot_e], axis=0)
        bv = jnp.concatenate([v2, bot_v], axis=0)
        s, c = pair_sums_2d(be, bv, blk_r, blk_c, max_lag=max_lag, n_bins=n_bins)
        s = jax.lax.psum(jax.lax.psum(s, "dy"), "dx")
        c = jax.lax.psum(jax.lax.psum(c, "dy"), "dx")
        gamma = jnp.where(c > 0, s / (2.0 * jnp.maximum(c, 1.0)), 0.0)
        step = jnp.asarray(0.5 * (abs(steps[0]) + abs(steps[1])), e.dtype)
        lags = jnp.asarray(centers, e.dtype) * step
        return fit_exponential(lags, gamma, c)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dy", "dx"), P("dy", "dx")),
        out_specs=P(),
    )
    return fn(elev, valid)


class ShardedStreamingInterpolator2D(StreamingInterpolator):
    """StreamingInterpolator whose mosaic planes are 2-D block-sharded over a
    (dy, dx) mesh — the scale-out when the mosaic is too WIDE for row bands
    alone (halo bytes scale with the block perimeter, parallel.spatial).

    Same API and (bit-for-bit) same results as the single-device class.
    Rows/cols pad to block multiples; pad cells are permanently invalid and
    invisible (shape/snapshot/save report the logical mosaic).
    """

    def __init__(self, shape, extent, mesh: Mesh, **kw):
        super().__init__(shape, extent, **kw)
        if not {"dy", "dx"} <= set(mesh.axis_names):
            raise ValueError(f"mesh must have ('dy', 'dx') axes, got {mesh.axis_names}")
        self.mesh = mesh
        ny, nx = mesh.devices.shape
        H, W = shape
        if self.window[0] > H or self.window[1] > W:
            raise ValueError(f"window {self.window} larger than mosaic {shape}")
        self._n_rows, self._n_cols = H, W
        self._blk_r = (H + (-H) % ny) // ny
        self._blk_c = (W + (-W) % nx) // nx
        dtype = self.elev.dtype
        sh = NamedSharding(mesh, P("dy", "dx"))
        Hp, Wp = self._blk_r * ny, self._blk_c * nx
        self.elev = jax.device_put(jnp.zeros((Hp, Wp), dtype), sh)
        self.valid = jax.device_put(jnp.zeros((Hp, Wp), dtype), sh)

    @property
    def shape(self):
        return (self._n_rows, self._n_cols)

    def flush(self) -> int:
        m = self._staged
        if m == 0:
            return 0
        self.elev, self.valid = _ingest_batch_sharded2d(
            self.elev, self.valid,
            jnp.asarray(self._stage.copy()), jnp.asarray(m, jnp.int32),
            self.mesh, self._blk_r, self._blk_c,
        )
        self._staged = 0
        return m

    def _window(self, center_row: int, center_col: int, *, method: str, variance: bool):
        self.flush()
        wh, ww = self.window
        H, W = self.shape
        r0 = int(np.clip(center_row - wh // 2, 0, H - wh))
        c0 = int(np.clip(center_col - ww // 2, 0, W - ww))
        return _window_fill_sharded2d(
            self.elev, self.valid, self._meta,
            jnp.asarray(r0, jnp.int32), jnp.asarray(c0, jnp.int32),
            self._vparams,
            mesh=self.mesh, blk_r=self._blk_r, blk_c=self._blk_c,
            win=self.window, method=method, k=self.k,
            max_radius=self.max_radius, steps=self._steps, variance=variance,
            backend=self.backend,
        ), (r0, c0)

    def fit_variogram(self, *, max_lag: int = 10, n_bins: int = 10):
        self.flush()
        self._vparams = _fit_variogram_sharded2d(
            self.elev, self.valid, self.mesh,
            self._blk_r, self._blk_c, max_lag, n_bins, self._steps,
        )
        return self._vparams

    def snapshot(self) -> np.ndarray:
        self.flush()
        elev = np.asarray(self.elev, np.float64)[: self._n_rows, : self._n_cols]
        valid = np.asarray(self.valid)[: self._n_rows, : self._n_cols] > 0.5
        return np.where(valid, elev, np.nan)

    def save(self, path: str) -> None:
        self.flush()
        vp = (
            np.asarray([float(v) for v in self._vparams], np.float64)
            if self._vparams is not None
            else np.zeros((0,), np.float64)
        )
        np.savez_compressed(
            path,
            elev=np.asarray(self.elev)[: self._n_rows, : self._n_cols],
            valid=np.asarray(self.valid)[: self._n_rows, : self._n_cols],
            extent=np.asarray(self._meta, np.float64),
            window=np.asarray(self.window, np.int64),
            method=np.asarray(self.method),
            k=np.asarray(self.k),
            max_radius=np.asarray(self.max_radius),
            vparams=vp,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, *, swath_cap: int = 4096, stage_slots: int = 16):
        """Resume a checkpoint (from any streaming class) onto a 2-D mesh."""
        from ..config import Extent

        d = np.load(path)
        min_lon, max_lon, min_lat, max_lat = (float(v) for v in d["extent"])
        si = cls(
            d["elev"].shape,
            Extent(min_lon, max_lon, min_lat, max_lat),
            mesh,
            swath_cap=swath_cap,
            stage_slots=stage_slots,
            window=tuple(int(v) for v in d["window"]),
            method=str(d["method"]),
            k=int(d["k"]),
            max_radius=int(d["max_radius"]),
            dtype=d["elev"].dtype,
        )
        H, W = d["elev"].shape
        Hp, Wp = si.elev.shape
        sh = NamedSharding(mesh, P("dy", "dx"))
        ep = np.zeros((Hp, Wp), d["elev"].dtype)
        vp_ = np.zeros((Hp, Wp), d["valid"].dtype)
        ep[:H, :W] = d["elev"]
        vp_[:H, :W] = d["valid"]
        si.elev = jax.device_put(jnp.asarray(ep), sh)
        si.valid = jax.device_put(jnp.asarray(vp_), sh)
        vp = d["vparams"] if "vparams" in d.files else np.zeros((0,))
        if len(vp) == 3:
            si._vparams = tuple(jnp.asarray(v, si.elev.dtype) for v in vp)
        return si
