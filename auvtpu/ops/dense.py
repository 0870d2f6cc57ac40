"""Dense (cell-aligned) interpolation ops: mask fill and 2x upsampling.

The reference treats every workload as a scattered point batch, but its two
real workloads are cell-aligned: Grid B queries the masked cells themselves
(test_gebco.cpp:152-160 maps row/col straight back to lon/lat) and Grid A's
expanded grid queries half-integer coordinates (generateExpandedGridQueryPoints,
test_interpolation.cpp:91-109).  We exploit that: whole-grid shift/
stencil pipelines with **zero gathers** — every step is a dynamic-slice of an
edge-padded plane, which XLA fuses into elementwise code.

Key reformulation: because queries sit exactly on cells, the distance from a
query to candidate offset (dx, dy) is the *static* scalar
sqrt((dx+0.5)^2 + (dy+0.5)^2) (the reference's cell-center convention,
GridH.cpp:42-44).  Sorting offsets statically by (distance^2, collection
order) turns "k nearest valid neighbors" into "first k valid in static order"
— a pure prefix accumulation with no sort, no top-k, no data-dependent
control flow at all.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import IDWConfig, KrigingConfig
from ..golden.engine import ring_offsets
from ..grid import RegularGrid
from .scattered import krige_solve


@lru_cache(maxsize=16)
def sorted_offsets(max_radius: int, convention: str = "reference"):
    """Window offsets sorted by (distance^2, collection order).

    convention='reference': distances to cell centers (i+0.5, j+0.5) —
    the reference's asymmetric metric (GridH.cpp:42-44), under which a cell's
    left/up neighbors are closer than its right/down ones, so nearest-k
    neighborhoods are one-sided.  convention='centered': symmetric di = dx,
    dj = dy — geostatistically sound and measurably more accurate (see
    docs/SEMANTICS.md).  Returns numpy (dx (M,), dy (M,), d2 (M,)) with d2
    exact in f32."""
    offs, _ = ring_offsets(max_radius)
    dx = offs[:, 0].astype(np.float64)
    dy = offs[:, 1].astype(np.float64)
    if convention == "reference":
        d2 = (dx + 0.5) ** 2 + (dy + 0.5) ** 2
    elif convention == "centered":
        d2 = dx**2 + dy**2
    else:
        raise ValueError(convention)
    order = np.lexsort((np.arange(len(offs)), d2))  # stable: ties by collection order
    return (
        offs[order, 0].astype(np.int32),
        offs[order, 1].astype(np.int32),
        d2[order].astype(np.float32),
    )


def _padded(grid: RegularGrid, radius: int):
    """Edge-pad elev (values irrelevant outside) and zero-pad validity."""
    pe = jnp.pad(grid.elev, radius, mode="edge")
    pv = jnp.pad(grid.valid, radius, mode="constant", constant_values=0.0)
    return pe, pv


def _shift(p: jax.Array, dy: jax.Array, dx: jax.Array, radius: int, shape):
    """Plane shifted by (dy, dx): out[r, c] = p[r + dy + R, c + dx + R]."""
    return jax.lax.dynamic_slice(p, (radius + dy, radius + dx), shape)


def _shift_static(p: jax.Array, dy: int, dx: int, radius: int, shape):
    """_shift with compile-time offsets: a static lax.slice, which XLA fuses
    into the consuming elementwise graph instead of emitting a dynamic-slice
    copy.  Used by the chunk-0 peel (see _offset_loop)."""
    return jax.lax.slice(
        p, (radius + dy, radius + dx), (radius + dy + shape[0], radius + dx + shape[1])
    )


# ---------------------------------------------------------------------------
# bilinear fill (cell-aligned): corner-mean semantics at every cell
# ---------------------------------------------------------------------------

@jax.jit
def fill_bilinear(grid: RegularGrid):
    """Per-cell bilinear prediction at the cell's own coordinates.

    At x=c, y=r the reference's bilinear collapses to: value if all four
    corners (c,r),(c+1,r),(c,r+1),(c+1,r+1) are valid, else the mean of the
    valid corners, else NaN (GridH.cpp:170-199 with wx=wy=0).  The +1 indices
    clamp at the far edges, so edge cells see duplicated corners — reproduced
    via edge-replicate padding of both planes.
    """
    H, W = grid.shape
    ev = jnp.pad(grid.elev, ((0, 1), (0, 1)), mode="edge")
    va = jnp.pad(grid.valid, ((0, 1), (0, 1)), mode="edge")
    z = [ev[0:H, 0:W], ev[0:H, 1 : W + 1], ev[1 : H + 1, 0:W], ev[1 : H + 1, 1 : W + 1]]
    m = [va[0:H, 0:W], va[0:H, 1 : W + 1], va[1 : H + 1, 0:W], va[1 : H + 1, 1 : W + 1]]
    cnt = m[0] + m[1] + m[2] + m[3]
    s = z[0] * m[0] + z[1] * m[1] + z[2] * m[2] + z[3] * m[3]
    fb = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), jnp.nan)
    return jnp.where(cnt >= 4, z[0], fb)


# ---------------------------------------------------------------------------
# first-k-valid prefix accumulation over statically sorted offsets
# ---------------------------------------------------------------------------
#
# The accumulation visits offsets in sorted order, so once *every* cell has
# collected k valid neighbors the remaining offsets can't change anything.
# We therefore process offsets in chunks inside a lax.while_loop whose
# condition checks global saturation: at removal <= 0.5 almost every cell
# saturates within ring 2, so typically ~3 of 50 chunks run — a 15-20x cut in
# both HBM traffic and compute versus scanning all 441 offsets, with results
# bit-identical to the full scan (chunks are skipped only when no cell can
# take further candidates).

_CHUNK = 9  # offsets per while-loop iteration (ring 1 + center = 9)


def _offset_loop(grid: RegularGrid, max_radius: int, init, step, saturated, convention="reference"):
    """Early-exit chunked loop over the sorted offset table.

    step(state, val_plane, ok_plane, d2_scalar, live_scalar) -> state
    saturated(state) -> bool scalar: True when no further offset can matter.
    """
    dxs, dys, d2s = sorted_offsets(max_radius, convention)
    m = len(dxs)
    n_chunks = -(-m // _CHUNK)
    pad = n_chunks * _CHUNK - m
    live = np.concatenate([np.ones(m, np.float32), np.zeros(pad, np.float32)])
    dxs = np.concatenate([dxs, np.zeros(pad, np.int32)])
    dys = np.concatenate([dys, np.zeros(pad, np.int32)])
    d2s = np.concatenate([d2s, np.full(pad, np.inf, np.float32)])
    tdx = jnp.asarray(dxs)
    tdy = jnp.asarray(dys)
    td2 = jnp.asarray(d2s)
    tlive = jnp.asarray(live)

    pe, pv = _padded(grid, max_radius)
    shape = grid.shape

    # static peel of chunk 0: the old (c == 0) cond clause forced it on every
    # grid, and the offset table is host-static — so its windows can be read
    # with compile-time slice starts (fusable) instead of dynamic-slice
    # copies.  Same offsets, same order, same f32 table constants: bit-exact.
    state = init
    for i in range(min(_CHUNK, len(dxs))):
        if live[i] == 0.0:
            continue  # tail padding (only reachable when the table is short)
        v = _shift_static(pe, int(dys[i]), int(dxs[i]), max_radius, shape)
        ok = _shift_static(pv, int(dys[i]), int(dxs[i]), max_radius, shape)
        state = step(state, v, ok, jnp.asarray(d2s[i]), jnp.asarray(np.float32(1.0)))
    init = state

    def cond(carry):
        c, state = carry
        return (c < n_chunks) & ~saturated(state)

    def body(carry):
        c, state = carry
        base = c * _CHUNK
        for i in range(_CHUNK):
            j = base + i
            sdx = tdx[j]
            sdy = tdy[j]
            v = _shift(pe, sdy, sdx, max_radius, shape)
            ok = _shift(pv, sdy, sdx, max_radius, shape)
            state = step(state, v, ok, td2[j], tlive[j])
        return (c + 1, state)

    _, state = jax.lax.while_loop(cond, body, (jnp.asarray(1, jnp.int32), init))
    return state


@partial(jax.jit, static_argnames=("k", "max_radius", "convention"))
def fill_window_mean(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """Mean of the k nearest valid cells per cell — the dense Grid B 'cubic':
    at a masked center the 4x4 Catmull-Rom patch always contains the masked
    cell itself, so the reference's cubic *always* takes the ring-fallback
    path there (kernels.cu:305-371).  Returns the full plane (harness gathers
    the masked cells)."""
    dt = grid.dtype
    zero = grid.elev * 0  # zeros_like, inheriting shard_map axis variance
    init = (zero, zero)  # (count, sum)

    def step(state, v, ok, _d2, live):
        cnt, s = state
        take = ok * live * (cnt < k).astype(dt)
        return (cnt + take, s + take * v)

    cnt, s = _offset_loop(
        grid, max_radius, init, step, lambda st: jnp.min(st[0]) >= k, convention
    )
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), jnp.nan)


@partial(jax.jit, static_argnames=("k", "power", "max_radius", "convention"))
def fill_idw(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference"):
    """k-nearest IDW fill plane (the BASELINE.json north-star kernel)."""
    cfg = IDWConfig(k=k, power=power, max_radius=max_radius)
    dt = grid.dtype
    zero = grid.elev * 0
    init = (zero, zero, zero)

    def step(state, v, ok, d2, live):
        cnt, ws, vs = state
        take = ok * live * (cnt < k).astype(dt)
        w = take / (d2 ** (power / 2.0) + cfg.eps)
        return (cnt + take, ws + w, vs + w * v)

    cnt, ws, vs = _offset_loop(
        grid, max_radius, init, step, lambda st: jnp.min(st[0]) >= k, convention
    )
    return jnp.where(cnt > 0, vs / jnp.maximum(ws, cfg.eps), jnp.nan)


def window_topk_idx(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection with a slim carry: per cell, the *sorted-offset
    index* of each selected slot (f32 planes; -1 = empty slot) plus the count.

    Carrying k index planes instead of k (value, dx, dy) triples cuts the
    while-loop state ~2.6x; values/offsets are reconstructed afterwards by a
    cheap table lookup + one spatially-local gather per slot.
    """
    dt = grid.dtype
    zero = grid.elev * 0
    init = (zero, [zero - 1.0 for _ in range(k)])  # cnt, slot offset-indices

    dxs, dys, d2s, live, n_chunks = _padded_tables(max_radius, convention)
    tdx = jnp.asarray(dxs)
    tdy = jnp.asarray(dys)
    tlive = jnp.asarray(live)
    pe, pv = _padded(grid, max_radius)
    shape = grid.shape

    # static peel of chunk 0 (see _offset_loop)
    cnt, idxs = init
    for i in range(min(_CHUNK, len(dxs))):
        if live[i] == 0.0:
            continue
        v_ok = _shift_static(pv, int(dys[i]), int(dxs[i]), max_radius, shape)
        take = v_ok * (cnt < k).astype(dt)
        jf = jnp.asarray(i, jnp.int32).astype(dt)
        idxs = [
            idxs[s] + take * (cnt == s).astype(dt) * (jf - idxs[s])
            for s in range(k)
        ]
        cnt = cnt + take
    init = (cnt, idxs)

    def cond(carry):
        c, (cnt, _) = carry
        return (c < n_chunks) & (jnp.min(cnt) < k)

    def body(carry):
        c, (cnt, idxs) = carry
        base = c * _CHUNK
        for i in range(_CHUNK):
            j = base + i
            v_ok = _shift(pv, tdy[j], tdx[j], max_radius, shape)
            take = v_ok * tlive[j] * (cnt < k).astype(dt)
            jf = j.astype(dt)
            idxs = [
                idxs[s] + take * (cnt == s).astype(dt) * (jf - idxs[s])
                for s in range(k)
            ]
            cnt = cnt + take
        return (c + 1, (cnt, idxs))

    _, (cnt, idxs) = jax.lax.while_loop(
        cond, body, (jnp.asarray(1, jnp.int32), init)
    )
    return cnt, idxs


def _padded_tables(max_radius: int, convention: str = "reference"):
    dxs, dys, d2s = sorted_offsets(max_radius, convention)
    m = len(dxs)
    n_chunks = -(-m // _CHUNK)
    pad = n_chunks * _CHUNK - m
    live = np.concatenate([np.ones(m, np.float32), np.zeros(pad, np.float32)])
    dxs = np.concatenate([dxs, np.zeros(pad, np.int32)])
    dys = np.concatenate([dys, np.zeros(pad, np.int32)])
    d2s = np.concatenate([d2s, np.full(pad, np.inf, np.float32)])
    return dxs, dys, d2s, live, n_chunks


def _slots_at(grid: RegularGrid, idxs, flat_cells, max_radius: int):
    """Reconstruct (vals (N,K), dxs (N,K), dys (N,K)) for the cells in
    ``flat_cells`` from slot offset-index planes."""
    dxs_np, dys_np, _ = sorted_offsets(max_radius)
    tdx = jnp.asarray(dxs_np.astype(np.float32))
    tdy = jnp.asarray(dys_np.astype(np.float32))
    H, W = grid.shape
    R = max_radius
    pe, _ = _padded(grid, R)
    pw = W + 2 * R
    rows = flat_cells // W
    cols = flat_cells % W
    out_v, out_dx, out_dy = [], [], []
    for s in range(len(idxs)):
        oi = jnp.take(idxs[s].reshape(-1), flat_cells)
        oij = jnp.clip(oi, 0, None).astype(jnp.int32)
        dx = jnp.take(tdx, oij)
        dy = jnp.take(tdy, oij)
        src = (rows + dy.astype(jnp.int32) + R) * pw + (cols + dx.astype(jnp.int32) + R)
        # empty slots (oi < 0) must contribute 0 so the <4-neighbor mean
        # fallback (sum/cnt) stays correct
        out_v.append(jnp.where(oi >= 0, jnp.take(pe.reshape(-1), src), 0.0))
        out_dx.append(dx.astype(grid.dtype))
        out_dy.append(dy.astype(grid.dtype))
    stack = lambda xs: jnp.stack(xs, axis=1)
    return stack(out_v), stack(out_dx), stack(out_dy)


def window_topk_planes(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection as whole-grid planes (cnt, vals, dxs, dys):
    per cell, the k nearest valid neighbors in v2 order with their offsets.

    Values and offsets are carried as planes through the early-exit loop —
    a fatter carry than window_topk_idx, but gather-free.
    """
    dt = grid.dtype
    zero = grid.elev * 0
    init = (zero, [zero] * k, [zero] * k, [zero] * k)

    dxs_t, dys_t, d2s, live, n_chunks = _padded_tables(max_radius, convention)
    tdx = jnp.asarray(dxs_t)
    tdy = jnp.asarray(dys_t)
    tlive = jnp.asarray(live)
    pe, pv = _padded(grid, max_radius)
    shape = grid.shape

    # static peel of chunk 0 (see _offset_loop)
    cnt, vals, dxs, dys = init
    for i in range(min(_CHUNK, len(dxs_t))):
        if live[i] == 0.0:
            continue
        dy_i, dx_i = int(dys_t[i]), int(dxs_t[i])
        v = _shift_static(pe, dy_i, dx_i, max_radius, shape)
        ok = _shift_static(pv, dy_i, dx_i, max_radius, shape)
        take = ok * (cnt < k).astype(dt)
        fdx = jnp.asarray(dx_i, jnp.int32).astype(dt)
        fdy = jnp.asarray(dy_i, jnp.int32).astype(dt)
        nv, ndx, ndy = [], [], []
        for s in range(k):
            hit = take * (cnt == s).astype(dt)
            nv.append(vals[s] + hit * (v - vals[s]))
            ndx.append(dxs[s] + hit * (fdx - dxs[s]))
            ndy.append(dys[s] + hit * (fdy - dys[s]))
        cnt = cnt + take
        vals, dxs, dys = nv, ndx, ndy
    init = (cnt, vals, dxs, dys)

    def cond(carry):
        c, (cnt, *_rest) = carry
        return (c < n_chunks) & (jnp.min(cnt) < k)

    def body(carry):
        c, (cnt, vals, dxs, dys) = carry
        base = c * _CHUNK
        for i in range(_CHUNK):
            jj = base + i
            sdx = tdx[jj]
            sdy = tdy[jj]
            v = _shift(pe, sdy, sdx, max_radius, shape)
            ok = _shift(pv, sdy, sdx, max_radius, shape)
            take = ok * tlive[jj] * (cnt < k).astype(dt)
            fdx = sdx.astype(dt)
            fdy = sdy.astype(dt)
            nv, ndx, ndy = [], [], []
            for s in range(k):
                hit = take * (cnt == s).astype(dt)
                nv.append(vals[s] + hit * (v - vals[s]))
                ndx.append(dxs[s] + hit * (fdx - dxs[s]))
                ndy.append(dys[s] + hit * (fdy - dys[s]))
            cnt = cnt + take
            vals, dxs, dys = nv, ndx, ndy
        return (c + 1, (cnt, vals, dxs, dys))

    _, state = jax.lax.while_loop(cond, body, (jnp.asarray(1, jnp.int32), init))
    return state


def _krige_from_slots(grid, cnt, vals, dxs, dys, cols, rows, *, steps=None, vparams=None, convention="reference", model="exponential", with_variance=False):
    """Batched kriging solve given selected-slot data at given cells.

    cols/rows: (N,) float cell coordinates (global); slot inputs are (N, K).
    convention='reference' keeps the half-cell neighbor-coordinate shift
    (GridH.cpp:364-367); 'centered' removes it.
    """
    half = 0.5 if convention == "reference" else 0.0
    dt = grid.dtype
    if steps is None:
        lat_step = jnp.asarray(grid.lat_step, dt)
        lon_step = jnp.asarray(grid.lon_step, dt)
    else:
        lat_step = jnp.asarray(steps[0], dt)
        lon_step = jnp.asarray(steps[1], dt)
    qlon = grid.min_lon + cols * lon_step
    qlat = grid.min_lat + rows * lat_step
    cx = grid.min_lon + (cols[:, None] + dxs + half) * lon_step
    cy = grid.min_lat + (rows[:, None] + dys + half) * lat_step
    if with_variance:
        pred, singular, var = krige_solve(
            qlon, qlat, vals, cx, cy, KrigingConfig(), vparams=vparams,
            model=model, with_variance=True,
        )
    else:
        pred, singular = krige_solve(qlon, qlat, vals, cx, cy, KrigingConfig(), vparams=vparams, model=model)
    fb = jnp.where(cnt > 0, vals.sum(axis=1) / jnp.maximum(cnt, 1.0), jnp.nan)
    bail = singular | (cnt < 4)
    out = jnp.where(bail, fb, pred)
    if with_variance:
        # fallback cells have no defined kriging variance
        return out, jnp.where(bail, jnp.nan, var)
    return out


@partial(jax.jit, static_argnames=("max_radius", "convention", "backend", "model", "with_variance"))
def fill_kriging(grid: RegularGrid, *, max_radius: int = 10, row0=0, col0=0, steps=None, vparams=None, convention: str = "reference", backend: str = "xla", model: str = "exponential", with_variance: bool = False):
    """Ordinary-kriging fill plane: first-4-valid selection (window_topk_planes),
    then a batched 5x5 solve per cell (weights depend on the *geometry* of the
    selected offsets, kernels.cu:478-546).

    row0/col0/steps support spatially-sharded execution: when the plane is a
    block of a larger grid, pass the block's global starting row/col and the
    global (lat_step, lon_step) so the variogram geometry stays correct.

    backend: 'xla' (whole-plane loops, any platform) or 'fused' (the fused
    selection + solve kernel of pallas/kriging_fill.py, GPU f32; supports
    every argument).  ops.backend.resolve picks one per platform.
    """
    if backend == "fused":
        from ..pallas import fused_fill_kriging

        return fused_fill_kriging(
            grid, max_radius=max_radius, convention=convention, vparams=vparams,
            model=model, with_variance=with_variance,
            row0=row0, col0=col0, steps=steps,
        )
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    H, W = grid.shape
    dt = grid.dtype
    cnt, vals, dxs, dys = window_topk_planes(
        grid, k=4, max_radius=max_radius, convention=convention
    )
    cgrid = (jax.lax.broadcasted_iota(dt, (H, W), 1) + jnp.asarray(col0, dt)).reshape(-1)
    rgrid = (jax.lax.broadcasted_iota(dt, (H, W), 0) + jnp.asarray(row0, dt)).reshape(-1)
    out = _krige_from_slots(
        grid,
        cnt.reshape(-1),
        jnp.stack([v.reshape(-1) for v in vals], axis=1),
        jnp.stack([d.reshape(-1) for d in dxs], axis=1),
        jnp.stack([d.reshape(-1) for d in dys], axis=1),
        cgrid,
        rgrid,
        steps=steps,
        vparams=vparams,
        convention=convention,
        model=model,
        with_variance=with_variance,
    )
    if with_variance:
        plane, var = out
        return plane.reshape(H, W), var.reshape(H, W)
    return out.reshape(H, W)


@partial(jax.jit, static_argnames=("max_radius", "convention", "backend", "model"))
def kriging_at_cells(grid: RegularGrid, rows, cols, *, max_radius: int = 10, vparams=None, convention: str = "reference", backend: str = "xla", model: str = "exponential"):
    """Kriging predictions at an explicit cell list (Grid B workload).

    Computes the dense fill plane and takes the requested cells: the fused
    whole-plane solve is cheaper than per-cell slot gathers (5 random
    gathers at the cell list dominated the whole pipeline before this
    formulation)."""
    plane = fill_kriging(
        grid, max_radius=max_radius, vparams=vparams, convention=convention,
        backend=backend, model=model,
    )
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    return jnp.take(plane.reshape(-1), rows * grid.num_lon + cols)


# ---------------------------------------------------------------------------
# Grid A: 2x upsampling (separable stencils, fully-valid grids)
# ---------------------------------------------------------------------------

def _interleave_cols(a: jax.Array, b: jax.Array):
    """a (H, W), b (H, W-1) -> (H, 2W-1): a0 b0 a1 b1 ... a_{W-1}."""
    H, W = a.shape
    out = jnp.zeros((H, 2 * W - 1), a.dtype)
    out = out.at[:, 0::2].set(a)
    out = out.at[:, 1::2].set(b)
    return out


@jax.jit
def upsample2x_bilinear(grid: RegularGrid):
    """(H, W) -> (2H-1, 2W-1): even points copy, odd points average — exactly
    the reference's expanded-grid bilinear pass (queries at half-integer grid
    coords => wx, wy in {0, 0.5}; test_interpolation.cpp:283-306)."""
    g = grid.elev
    hmid = 0.5 * (g[:, :-1] + g[:, 1:])
    rows = _interleave_cols(g, hmid)  # (H, 2W-1)
    vmid = 0.5 * (rows[:-1, :] + rows[1:, :])
    return _interleave_cols(rows.T, vmid.T).T


def _cr_half_filter(g: jax.Array, axis: int):
    """Catmull-Rom at t=1/2 along axis: (-1, 9, 9, -1)/16 with edge-replicated
    ends (the reference clamps patch indices, GridH.cpp:244-247)."""
    if axis == 0:
        g = g.T
    p = jnp.pad(g, ((0, 0), (1, 2)), mode="edge")
    mid = (-p[:, 0:-3] + 9.0 * p[:, 1:-2] + 9.0 * p[:, 2:-1] - p[:, 3:]) / 16.0
    mid = mid[:, : g.shape[1] - 1]
    out = _interleave_cols(g, mid)
    return out.T if axis == 0 else out


@jax.jit
def upsample2x_bicubic(grid: RegularGrid):
    """(H, W) -> (2H-1, 2W-1) separable Catmull-Rom: even rows/cols are exact
    copies (t=0 => p1), odd positions use the half-phase kernel.  Matches the
    reference's per-point bicubic on fully-valid grids."""
    a = _cr_half_filter(grid.elev, axis=1)
    return _cr_half_filter(a, axis=0)
