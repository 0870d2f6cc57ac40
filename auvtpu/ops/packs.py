"""Stencil packs: gather-aligned neighborhood layouts for scattered queries.

A scattered query needs a whole neighborhood (4 bilinear corners, 16 bicubic
taps, 25 window candidates), and per-index gather cost dwarfs payload
cost.  A *pack* precomputes, for every cell, its neighborhood values into P
adjacent lanes (P a power of two dividing 128), NaN-encoding validity.  One
row-block fetch then returns the entire stencil: cell i's P lanes start at
lane (i*P) mod 128 of block (i*P) // 128 — never straddling a block because
P | 128.

Packs are built once per grid by dense shifts (a P-pass pipeline over HBM)
and amortize across every subsequent batch, exactly like the reference's
ctor-time grid upload (GridD.cu:65-83) — but shaped for the gather unit.

Cost: P x grid bytes of HBM (bilinear 4x, bicubic 16x, radius-2 window 32x).
For radius > 2 windows (heavily masked grids) packs are impractical (441
taps); the per-offset gather path in ops.window covers that regime.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import RegularGrid

_LANES = 128

# invalid taps are a finite sentinel inside packs (NaN would poison the
# one-hot sub-block selection: 0 * NaN = NaN); converted to NaN on fetch
_SENTINEL = 1e30


def _sentinel_plane(grid: RegularGrid):
    return jnp.where(grid.valid > 0.5, grid.elev, _SENTINEL)


def build_pack(grid: RegularGrid, offsets, clamp: bool):
    """(H*W*P,) packed plane for the given (dy, dx) offsets (P padded to a
    power of two dividing 128).

    clamp=True replicates edges (bilinear/bicubic index clamping); False
    marks out-of-grid taps NaN (window candidates).
    """
    H, W = grid.shape
    P = 1
    while P < len(offsets):
        P *= 2
    assert P <= _LANES
    planes = []
    src = _sentinel_plane(grid)
    for dy, dx in offsets:
        jj = jnp.arange(H, dtype=jnp.int32) + dy
        ii = jnp.arange(W, dtype=jnp.int32) + dx
        if clamp:
            jj = jnp.clip(jj, 0, H - 1)
            ii = jnp.clip(ii, 0, W - 1)
            plane = src[jj][:, ii]
        else:
            inb = ((jj >= 0) & (jj < H))[:, None] & ((ii >= 0) & (ii < W))[None, :]
            plane = jnp.where(
                inb, src[jnp.clip(jj, 0, H - 1)][:, jnp.clip(ii, 0, W - 1)], _SENTINEL
            )
        planes.append(plane)
    for _ in range(P - len(offsets)):
        planes.append(jnp.full((H, W), _SENTINEL, src.dtype))
    return jnp.stack(planes, axis=-1).reshape(-1), P


def fetch_pack(
    pack: jax.Array,
    P: int,
    cell_idx: jax.Array,
    nan_invalid: bool = True,
    transposed: bool = False,
) -> jax.Array:
    """cell_idx (N,) int32 -> (N, P) stencil values (NaN = invalid tap;
    ``nan_invalid=False`` keeps the raw +1e30 sentinel — consumers that
    multiply by one-hot masks need it, 0*NaN poisons the product;
    ``transposed=True`` emits (P, N) with the one-hot einsum writing the
    transposed layout directly, for lanes-major Pallas consumers).

    One (N, 128) row-block fetch + a (128/P)-way sub-block select.
    """
    n_pad = (-pack.shape[0]) % _LANES
    flat = jnp.pad(pack, (0, n_pad)) if n_pad else pack
    pr = flat.reshape(-1, _LANES)
    start = cell_idx * P
    rows = start // _LANES
    sub = (start % _LANES) // P  # which of the 128/P sub-blocks
    rd = jnp.take(pr, rows, axis=0)  # (N, 128)
    g = _LANES // P
    rdg = rd.reshape(-1, g, P)
    oh = (
        sub[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, g), 1)
    ).astype(pack.dtype)
    st = jnp.einsum("ng,ngp->pn" if transposed else "ng,ngp->np", oh, rdg,
                    precision=jax.lax.Precision.HIGHEST)
    if not nan_invalid:
        return st
    return jnp.where(st >= 0.5 * _SENTINEL, jnp.nan, st)


# ---------------------------------------------------------------------------
# packed scattered ops (fully-sharing the math of ops.scattered)
# ---------------------------------------------------------------------------

BILINEAR_OFFSETS = [(0, 0), (0, 1), (1, 0), (1, 1)]
BICUBIC_OFFSETS = [(m, n) for m in range(-1, 3) for n in range(-1, 3)]


def window_offsets(max_radius: int, convention: str = "reference"):
    """Window offsets in reference COLLECTION order (center, then ring
    segments — ops.window.ring_tables' order, of which any smaller radius is
    a prefix).  The pack/table index is therefore the collection index, so
    ``lax.top_k``'s lowest-index tie preference (and the fused kernel's
    first-lane min-extract) break equal-actual-d2 ties by collection order —
    exactly like ``ops.window.window_select`` and the GoldenV2 oracle.  A
    statically distance-sorted layout would instead break such ties by
    static d2, making the TwoTier fast path disagree with its own escalation
    on tie-line queries (the old docs/SEMANTICS.md caveat, now gone).

    ``convention`` only affects runtime distances, never the layout; it is
    accepted for signature compatibility with the callers that thread it."""
    del convention
    from .window import ring_tables

    offs, _ = ring_tables(max_radius)  # (M, 2) columns (dx, dy)
    return [(int(o[1]), int(o[0])) for o in offs]


class StencilPack:
    """Prebuilt packs for a grid: bilinear + bicubic + radius-R window."""

    def __init__(self, grid: RegularGrid, *, window_radius: int = 2):
        self.grid = grid
        self.window_radius = window_radius
        self.bilinear, self.p_bilinear = build_pack(grid, BILINEAR_OFFSETS, clamp=True)
        self.bicubic, self.p_bicubic = build_pack(grid, BICUBIC_OFFSETS, clamp=True)
        offs = window_offsets(window_radius)
        self.window, self.p_window = build_pack(grid, offs, clamp=False)
        d = np.asarray(offs, np.float64)
        self.window_d2_base = None  # distances depend on the query position


def _normalize(grid: RegularGrid, lons, lats):
    from .scattered import _normalize as norm

    return norm(grid, lons, lats)


def bilinear_from_stencil(st, x, y, oob):
    """Bilinear from a 4-corner stencil (NaN = invalid tap); shared by the
    pack-fetch and tile-extraction paths."""
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    wx = x - x0
    wy = y - y0
    z00, z01, z10, z11 = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
    ok = ~jnp.isnan(st)
    cnt = ok.sum(axis=1)
    s = jnp.where(ok, st, 0.0).sum(axis=1)
    fb = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)
    z0 = (1 - wx) * z00 + wx * z01
    z1 = (1 - wx) * z10 + wx * z11
    z = (1 - wy) * z0 + wy * z1
    out = jnp.where(cnt < 4, fb, z)
    return jnp.where(oob, jnp.nan, out)


def _row_fetch(pack: jax.Array, cell_idx, P: int):
    """(N, 128) row fetch + (rows, sub) for in-row lane addressing."""
    n_pad = (-pack.shape[0]) % _LANES
    flat = jnp.pad(pack, (0, n_pad)) if n_pad else pack
    pr = flat.reshape(-1, _LANES)
    start = cell_idx * P
    rd = jnp.take(pr, start // _LANES, axis=0)
    sub = (start % _LANES) // P
    return rd, sub


@partial(jax.jit, static_argnames=("assume_valid",))
def packed_bilinear(pack: jax.Array, grid: RegularGrid, lons, lats, *, assume_valid: bool = False):
    """Bilinear as ONE fused per-lane weighted sum over the gathered row.

    The row gather is row-count-bound, so the op's ceiling is the fetch
    itself; a (N,32,4)-reshape one-hot select would force a minor-dim
    relayout costing almost as much as the fetch.  The lerp is linear in the
    4 taps, so corner select + lerp collapse into one (N,128) multiply-reduce
    with per-lane weights built from iota.

    assume_valid=True (safe for fully-observed grids, e.g. Grid A) skips the
    masked-corner-fallback reductions: each extra (N,128) reduction pass
    costs ~6 ms at 5M queries, and the single-pass form hits 126 M pts/s vs
    93 for the general form.
    """
    x, y, oob = _normalize(grid, lons, lats)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    # the pack clamps the +1 taps at build time, matching min(x0+1, W-1)
    rd, sub = _row_fetch(pack, y0 * grid.num_lon + x0, 4)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, _LANES), 1)
    g = lane // 4
    c = lane % 4
    mine = (g == sub[:, None]).astype(rd.dtype)
    wlerp = (
        (c == 0) * (1 - wx) * (1 - wy)
        + (c == 1) * wx * (1 - wy)
        + (c == 2) * (1 - wx) * wy
        + (c == 3) * wx * wy
    )
    if assume_valid:
        z = (rd * (mine * wlerp)).sum(axis=1)
        return jnp.where(oob, jnp.nan, z)
    ok = mine * (rd < 0.5 * _SENTINEL)
    z = (rd * ok * wlerp).sum(axis=1)
    cnt = ok.sum(axis=1)
    s = (rd * ok).sum(axis=1)
    fb = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)
    out = jnp.where(cnt >= 4, z, fb)
    return jnp.where(oob, jnp.nan, out)


def bicubic_from_stencil(st, x, y, oob):
    """Catmull-Rom from a 16-tap stencil (rows m=-1..2, cols n=-1..2)."""
    from .scattered import _catmull_rom

    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    tx = x - xi
    ty = y - yi
    rows = [
        _catmull_rom(st[:, 4 * m + 0], st[:, 4 * m + 1], st[:, 4 * m + 2], st[:, 4 * m + 3], tx)
        for m in range(4)
    ]
    out = _catmull_rom(rows[0], rows[1], rows[2], rows[3], ty)
    return jnp.where(oob, jnp.nan, out)


def _cr_basis(t, i):
    """Catmull-Rom basis weight of tap i in {0..3} at parameter t — the
    tap-linear expansion of _catmull_rom (same polynomial, basis form)."""
    t2 = t * t
    t3 = t2 * t
    if i == 0:
        return 0.5 * (-t + 2.0 * t2 - t3)
    if i == 1:
        return 0.5 * (2.0 - 5.0 * t2 + 3.0 * t3)
    if i == 2:
        return 0.5 * (t + 4.0 * t2 - 3.0 * t3)
    return 0.5 * (-t2 + t3)


@partial(jax.jit, static_argnames=("assume_valid",))
def packed_bicubic(pack: jax.Array, grid: RegularGrid, lons, lats, *, assume_valid: bool = False):
    """Clean-stencil bicubic (fully-valid grids; NaN taps propagate NaN,
    reproducing 'no fallback' — use the window path for masked grids).

    Catmull-Rom is linear in its 16 taps, so select + two interpolation
    stages collapse into one fused (N,128) multiply-reduce with separable
    per-lane basis weights (see packed_bilinear's rationale); assume_valid
    skips the NaN-tap detection reduction (112 vs 97 M pts/s at 5M)."""
    x, y, oob = _normalize(grid, lons, lats)
    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    tx = (x - xi)[:, None]
    ty = (y - yi)[:, None]
    rd, sub = _row_fetch(pack, yi * grid.num_lon + xi, 16)  # rows m, cols n
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, _LANES), 1)
    g = lane // 16
    m = (lane % 16) // 4
    nn = lane % 4
    mine = (g == sub[:, None]).astype(rd.dtype)
    wrow = sum((m == i) * _cr_basis(ty, i) for i in range(4))
    wcol = sum((nn == i) * _cr_basis(tx, i) for i in range(4))
    z = (rd * (mine * wrow * wcol)).sum(axis=1)
    if not assume_valid:
        # NaN taps are sentinel-encoded in the pack; propagate NaN like the
        # reference's raw arithmetic would (no fallback in the clean path)
        bad = (rd * mine).max(axis=1) >= 0.5 * _SENTINEL
        z = jnp.where(bad, jnp.nan, z)
    return jnp.where(oob, jnp.nan, z)


def window_select_from_stencil(st, x, y, oob, ci, cj, *, k, window_radius, convention="reference"):
    """v2 top-k selection from a window stencil in v2 offset order (NaN =
    invalid tap); shared by the pack-fetch and tile-extraction paths."""
    offs = window_offsets(window_radius)
    return select_from_stencil(st, offs, x, y, oob, ci, cj, k=k, convention=convention)


def select_from_stencil(st, offs, x, y, oob, ci, cj, *, k, convention="reference"):
    """v2 top-k over an arbitrary collection-ordered offset table (the
    general core of window_select_from_stencil; also serves the 16-lane
    valid-grid fast path, whose table is a filtered subset)."""
    half = 0.5 if convention == "reference" else 0.0
    dyx = np.asarray(offs, np.float32)
    di = (ci[:, None].astype(x.dtype) + dyx[None, :, 1] + half) - x[:, None]
    dj = (cj[:, None].astype(y.dtype) + dyx[None, :, 0] + half) - y[:, None]
    d2 = di * di + dj * dj
    m = len(offs)
    ok = ~jnp.isnan(st[:, :m])
    neg = jnp.where(ok, -d2, -jnp.inf)
    top_neg, top_idx = jax.lax.top_k(neg, k)
    slot_ok = jnp.isfinite(top_neg)
    # select via one-hot contraction: take_along_axis lowers to a minor-dim
    # gather; the (N,k,m) one-hot einsum fuses instead.  HIGHEST keeps the
    # picks exact (a TF32 product would round depths by metres)
    oh = (
        top_idx[:, :, None] == jax.lax.broadcasted_iota(jnp.int32, (1, 1, m), 2)
    ).astype(st.dtype)
    pick = lambda a: jnp.einsum("nkm,nm->nk", oh, a, precision=jax.lax.Precision.HIGHEST)
    vals = jnp.where(slot_ok, pick(jnp.where(ok, st[:, :m], 0.0)), 0.0)
    # ONE composite position code instead of separate dy/dx picks: each
    # (N, k, m) einsum reads the materialized one-hot again (~1.3 GB at 5M
    # queries), so folding (dy, dx) into (dy+R)*B + (dx+R) saves a pass;
    # codes stay exact in f32 (B <= 22 for R <= 10 => codes < 500)
    R = int(np.abs(dyx).max())
    B = 2 * R + 2
    code_tab = (dyx[:, 0] + R) * B + (dyx[:, 1] + R)
    code = pick(jnp.broadcast_to(jnp.asarray(code_tab, st.dtype)[None, :], d2.shape))
    sel_dy = jnp.floor(code / B) - R
    sel_dx = code - (sel_dy + R) * B - R
    return {
        "x": x, "y": y, "oob": oob, "ci": ci, "cj": cj,
        "val": vals, "d2": -top_neg, "slot_ok": slot_ok,
        "found": slot_ok.sum(axis=1).astype(jnp.int32),
        "dy": sel_dy, "dx": sel_dx,
    }


@partial(jax.jit, static_argnames=("k", "window_radius", "convention"))
def packed_window_select(pack, grid: RegularGrid, lons, lats, *, k, window_radius, convention="reference"):
    """Window top-k from a pack: one fetch + masked top_k, v2 semantics."""
    x, y, oob = _normalize(grid, lons, lats)
    ci = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, grid.num_lon - 1)
    cj = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, grid.num_lat - 1)
    offs = window_offsets(window_radius)  # pack layout is fixed (reference order)
    P = 1
    while P < len(offs):
        P *= 2
    st = fetch_pack(pack, P, cj * grid.num_lon + ci)  # (N, P)
    return window_select_from_stencil(
        st, x, y, oob, ci, cj, k=k, window_radius=window_radius, convention=convention
    )


def kriging_from_select(grid: RegularGrid, lons, lats, sel, *, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False):
    """Kriging solve + fallbacks from a window-select dict (shared).

    with_variance=True also returns the ordinary-kriging prediction variance
    (NaN at fallback/out-of-bounds queries) — the scattered-serving twin of
    fill_kriging(with_variance=True)."""
    from ..config import KrigingConfig
    from .scattered import krige_solve
    from .window import masked_mean

    dt = grid.dtype
    half = 0.5 if convention == "reference" else 0.0
    lon_step = jnp.asarray(grid.lon_step, dt)
    lat_step = jnp.asarray(grid.lat_step, dt)
    cx = grid.min_lon + (sel["ci"][:, None].astype(dt) + sel["dx"] + half) * lon_step
    cy = grid.min_lat + (sel["cj"][:, None].astype(dt) + sel["dy"] + half) * lat_step
    out = krige_solve(
        jnp.asarray(lons, dt), jnp.asarray(lats, dt), sel["val"], cx, cy,
        KrigingConfig(), vparams=vparams, model=model, with_variance=with_variance,
    )
    pred, singular = out[0], out[1]
    fb = masked_mean(jnp.where(sel["slot_ok"], sel["val"], jnp.nan), sel["slot_ok"])
    bail = singular | (sel["found"] < 4)
    res = jnp.where(sel["oob"], jnp.nan, jnp.where(bail, fb, pred))
    if not with_variance:
        return res
    var = jnp.where(sel["oob"] | bail, jnp.nan, out[2])
    return res, var


def idw_from_select(sel, *, power: float = 2.0, eps: float = 1e-12):
    """IDW weights + fallbacks from a window-select dict (shared)."""
    w = jnp.where(sel["slot_ok"], 1.0 / (sel["d2"] ** (power / 2.0) + eps), 0.0)
    ws = w.sum(axis=1)
    out = jnp.where(ws > 0, (w * sel["val"]).sum(axis=1) / jnp.maximum(ws, eps), jnp.nan)
    return jnp.where(sel["oob"], jnp.nan, out)


@partial(jax.jit, static_argnames=("window_radius", "convention", "model", "with_variance"))
def packed_kriging(pack, grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False):
    sel = packed_window_select(pack, grid, lons, lats, k=4, window_radius=window_radius, convention=convention)
    return kriging_from_select(grid, lons, lats, sel, vparams=vparams, convention=convention, model=model, with_variance=with_variance)


@partial(jax.jit, static_argnames=("k", "power", "window_radius", "convention"))
def packed_idw(pack, grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, window_radius: int = 2, convention: str = "reference"):
    from ..config import IDWConfig

    cfg = IDWConfig(k=k, power=power)
    sel = packed_window_select(pack, grid, lons, lats, k=k, window_radius=window_radius, convention=convention)
    return idw_from_select(sel, power=power, eps=cfg.eps)


# ---------------------------------------------------------------------------
# fully-valid-grid kriging fast path: 16-lane candidate pack
# ---------------------------------------------------------------------------

# {-2..1}^2 in reference COLLECTION order (a filtered subset of the radius-2
# window table, so relative tie order is preserved)
VALID16_OFFSETS = [
    (dy, dx) for (dy, dx) in window_offsets(2) if -2 <= dy <= 1 and -2 <= dx <= 1
]


def build_valid16_pack(grid: RegularGrid):
    """16-lane {-2..1}^2 window pack for packed_kriging_valid (16x grid
    bytes — half the radius-2 window pack)."""
    pack, P = build_pack(grid, VALID16_OFFSETS, clamp=False)
    assert P == 16
    return pack


@partial(jax.jit, static_argnames=("convention", "model"))
def packed_kriging_valid(pack16, grid: RegularGrid, lons, lats, *, vparams=None, convention: str = "reference", model: str = "exponential"):
    """Kriging fast path for FULLY-VALID grids (Grid A): the top-4 candidate
    set provably fits a 16-lane pack, halving every selection tensor.

    Containment proof (reference convention, f = x - floor(x+0.5) in
    [-0.5, 0.5)): the inner 2x2 quad {0,-1}^2 always has d2 <= (0.5+|fx|)^2
    + (0.5+|fy|)^2 <= 2, while any cell OUTSIDE {-2..1}^2 has a per-axis
    center distance > 2 in the offending axis, so d2 > 4 — it can never
    displace the quad, and the 4 nearest cells of the radius-2 window lie in
    {-2..1}^2.  At grid edges the out-of-grid taps are NaN-marked and the
    surviving in-grid top-4 still fits: e.g. a column-2 cell beats the (1,1)
    quad corner only if fx - fy > 1, impossible on half-open fractions.
    The 16-entry table is the collection-order FILTERED radius-2 table, so
    tie order matches packed_kriging/window_select exactly — the selected
    sets are identical and the order-invariant 5x5 solve gives the same
    prediction (pinned by tests/test_packs.py::test_packed_kriging_valid_*).

    ONLY valid on fully-observed grids: on masked grids the 4 nearest VALID
    cells may lie outside {-2..1}^2.  Callers gate on grid validity
    (cli/bench_grid_a.py's assume-valid check).

    Reference behavior reproduced: kernels.cu:403-546 in the all-valid case
    (every ring search satisfied immediately by the adjacent cells).
    """
    if convention != "reference":
        raise ValueError(
            "packed_kriging_valid's containment proof is for the reference "
            "(+0.5) convention; use packed_kriging for 'centered'"
        )
    x, y, oob = _normalize(grid, lons, lats)
    W, H = grid.num_lon, grid.num_lat
    ci = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
    cj = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, H - 1)
    st = fetch_pack(pack16, 16, cj * W + ci)
    sel = select_from_stencil(
        st, VALID16_OFFSETS, x, y, oob, ci, cj, k=4, convention=convention
    )
    return kriging_from_select(
        grid, lons, lats, sel, vparams=vparams, convention=convention, model=model
    )
