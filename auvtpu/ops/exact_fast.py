"""Two-tier exact mode: dense streaming exact selection + rare-tie escalation.

``ops/exact.py`` reproduces the reference's observable selection
(ring-segment cutoff + swap tie-breaks, GridH.cpp:49-140) with a scattered
(N, 441)-lane kernel — correct, but ~28-35 us/pt of gather-bound device
time (results/exact_scale_r5.txt).  This module reformulates the SAME selection
as a dense whole-plane streaming pass, the formulation every other
cell-aligned path in this repo already uses (ops/dense.py): iterate the 441
candidate offsets in exact reference *collection order* as whole-plane
shifts, maintaining per cell

  - a running top-5 by the exact key (d2_static asc, T desc) — the key
    ops/exact.py proved equivalent to the reference's f64 ordering
    (see its module docstring for the derivation).  Five slots, not four:
    the fifth exists purely so the final state knows the key of the best
    REJECTED candidate;
  - the eligible-candidate count and a per-cell ``stopped`` flag that
    implements the reference's segment cutoff (count >= 4 checked at
    segment-end lanes, GridH.cpp:82,115) — the reference's own early exit,
    which also terminates the device loop once every cell has stopped;
  - a ``tie`` flag, computed once at the end of the pass: key(4th) ==
    key(5th) exactly.  An exact (d2, T) tie is an exact f64 distance tie
    (exact.py docstring), and a tie *at the selection boundary* is the only
    case where the reference's swap-mutated position order changes the
    selected SET.  Boundary-tied cells (rare: they need an exact distance
    tie straddling the 4th/5th rank) ESCALATE to the full ops/exact.py
    kernel, whose swap emulation is authoritative.

Ties strictly INSIDE the top four do not escalate: the selected set is
provably identical and the ordinary-kriging system is symmetric under
neighbor permutation, so slot order only moves the f64 Gauss-Jordan
round-off (measured ~1e-12 m, seven orders below the 5e-5 published-table
tolerance).  The dense pass serves those cells in collection order; the
divergence is documented in docs/SEMANTICS.md and bounded by
tests/test_exact_fast.py (canonical-order selection equality everywhere,
bitwise slot order wherever keys are distinct).

The kriging solve stays f64 (an f32 solve shifts regional MAE ~2e-3, above
the 5e-5 published-table tolerance) but drops its f64 exp/sqrt: for
cell-aligned queries every pairwise and query-to-neighbor distance is a
lattice quantity ((dx + 0.5) * lon_step etc., GridH.cpp:364-367 with integer
cell indices), so the variogram values come from two small host-precomputed
f64 tables (41x41 pairwise, 21x21 query) instead of per-point transcendental
emulation.  The table ignores the ~1e-12 coordinate residue inside gamma
(value effect ~1e-9 m, three orders below the table tolerance; the residue
still fully controls the *selection* via the T key).

The serving path (``solve='table'``, the default) runs selection,
neighbor-value extraction, the table solve and the found<4 fallback as ONE
jitted device program per query bucket — the only host<->device traffic is
the compact (N,) query upload and the (N,) prediction readback, per the
repo rule that serving paths are one dispatch (CLAUDE.md).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import KrigingConfig
from ..grid import RegularGrid
from .dense import _padded, _shift, _shift_static
from .exact import (
    _fallback_mean_np,
    _krige_chunk,
    _run_chunked,
    _select_chunk,
    exact_tables,
    prepare_exact_queries,
)
from .scattered import gj56

_CHUNK = 9  # lanes per while-loop iteration (center + ring-1 phase A + B)
_INF = np.float32(np.inf)
_BUCKET = 65536  # query-count padding quantum (bounds recompiles)


@lru_cache(maxsize=8)
def _collection_tables(max_radius: int = 10):
    """Per-lane scalars in exact collection order, chunk-padded.

    dx, dy   int32 offsets;
    d2       f32 variant-0 static squared distance ((dx+0.5)^2 + (dy+0.5)^2);
    cfx, cfy f32 variant-0 T-key coefficients (2 dx + 1, 2 dy + 1);
    seg_end  f32 1.0 at the last lane of each segment (cutoff checkpoints);
    live     f32 0.0 on tail padding.
    """
    tb = exact_tables(max_radius)
    dx = tb["dx"]
    dy = tb["dy"]
    m = len(dx)
    prev_end = tb["prev_end"]
    # last lane of segment s = prev_end of the first lane of segment s+1;
    # the final segment ends at the final lane.
    seg_end = np.zeros(m, np.float32)
    seg_end[prev_end[prev_end >= 0]] = 1.0
    seg_end[m - 1] = 1.0

    n_chunks = -(-m // _CHUNK)
    pad = n_chunks * _CHUNK - m

    def padi(a, fill=0):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return dict(
        dx=padi(dx),
        dy=padi(dy),
        d2=padi(tb["d2"][0], _INF),
        cfx=padi(tb["cfx"][0]),
        cfy=padi(tb["cfy"][0]),
        seg_end=padi(seg_end),
        live=padi(np.ones(m, np.float32)),
        n_chunks=n_chunks,
    )


@partial(jax.jit, static_argnames=("max_radius",))
def _dense_select(elev, valid, flat, exq, eyq, *, max_radius: int):
    """Whole-plane exact selection (variant 0: the kriging round anchor,
    which the f64 round-trip can never shift — prepare_exact_queries yields
    variant==0 for every cell-aligned round-anchored query).

    ``flat``/``exq``/``eyq`` are the compact (P,) query cells and their
    scaled residues; the residue planes are scattered on device (6 MB of
    upload instead of two 20 MB planes).  Padding entries carry flat ==
    H*W and are dropped by the scatter.

    Returns planes: count (i32), tie (bool: the 4th and 5th best keys are
    exactly equal — selected-set ambiguity), ln0..ln3 (i32 lane index in
    collection order, -1 when the slot is empty).  Slot order is the
    reference's selection-pass order (d2 asc, T desc); equal-key runs inside
    the top four sit in collection order (see module docstring).
    """
    tb = _collection_tables(max_radius)
    n_chunks = tb["n_chunks"]
    tdx = jnp.asarray(tb["dx"])
    tdy = jnp.asarray(tb["dy"])
    td2 = jnp.asarray(tb["d2"])
    tcfx = jnp.asarray(tb["cfx"])
    tcfy = jnp.asarray(tb["cfy"])
    tseg = jnp.asarray(tb["seg_end"])
    tlive = jnp.asarray(tb["live"])

    shape = valid.shape
    ex_plane = jnp.zeros(shape, jnp.float32).reshape(-1).at[flat].set(
        exq, mode="drop").reshape(shape)
    ey_plane = jnp.zeros(shape, jnp.float32).reshape(-1).at[flat].set(
        eyq, mode="drop").reshape(shape)
    grid_like = RegularGrid(
        elev=elev, valid=valid, min_lon=0.0, max_lon=1.0, min_lat=0.0, max_lat=1.0
    )
    _, pv = _padded(grid_like, max_radius)

    zf = jnp.zeros(shape, jnp.float32)
    zi = jnp.zeros(shape, jnp.int32)
    zb = jnp.zeros(shape, bool)
    state = dict(
        count=zi,
        stopped=zb,
        d2=[zf + _INF] * 5,
        T=[zf] * 5,
        ln=[zi - 1] * 5,
    )

    def lane_step(state, ok, lane_i, d2_s, cfx_s, cfy_s, seg_s, live_s):
        cand = (ok > 0.5) & ~state["stopped"] & (live_s > 0.5)
        T = ex_plane * cfx_s + ey_plane * cfy_s  # exact in f32 (exact.py)

        d2s, Ts, lns = state["d2"], state["T"], state["ln"]
        # lexicographic (d2 asc, T desc) against each slot; lt is monotone in
        # the slot index because slots are kept sorted.  Strict comparison:
        # an equal-key candidate files BELOW the earlier one (collection
        # order within ties).
        lt = [cand & ((d2_s < d2s[m]) | ((d2_s == d2s[m]) & (T > Ts[m]))) for m in range(5)]

        nd2, nT, nln = [], [], []
        for m in range(5):
            ins = lt[m] if m == 0 else (lt[m] & ~lt[m - 1])
            if m == 0:
                sd2, sT, sln = d2s[0], Ts[0], lns[0]
            else:
                # shift down when the insert happened above this slot
                sd2 = jnp.where(lt[m - 1], d2s[m - 1], d2s[m])
                sT = jnp.where(lt[m - 1], Ts[m - 1], Ts[m])
                sln = jnp.where(lt[m - 1], lns[m - 1], lns[m])
            nd2.append(jnp.where(ins, d2_s, sd2))
            nT.append(jnp.where(ins, T, sT))
            nln.append(jnp.where(ins, lane_i, sln))

        count = state["count"] + cand.astype(jnp.int32)
        stopped = state["stopped"] | ((seg_s > 0.5) & (count >= 4))
        return dict(count=count, stopped=stopped, d2=nd2, T=nT, ln=nln)

    # static peel of chunk 0 (compile-time slice starts; see dense._offset_loop)
    tbn = _collection_tables(max_radius)
    for i in range(min(_CHUNK, len(tbn["dx"]))):
        if tbn["live"][i] == 0.0:
            continue
        ok = _shift_static(pv, int(tbn["dy"][i]), int(tbn["dx"][i]), max_radius, shape)
        state = lane_step(
            state, ok,
            jnp.asarray(i, jnp.int32),
            jnp.asarray(tbn["d2"][i]),
            jnp.asarray(tbn["cfx"][i]),
            jnp.asarray(tbn["cfy"][i]),
            jnp.asarray(tbn["seg_end"][i]),
            jnp.asarray(np.float32(1.0)),
        )

    def cond(carry):
        c, state = carry
        return (c < n_chunks) & ~jnp.all(state["stopped"])

    def body(carry):
        c, state = carry
        base = c * _CHUNK
        for i in range(_CHUNK):
            j = base + i
            ok = _shift(pv, tdy[j], tdx[j], max_radius, shape)
            state = lane_step(state, ok, j, td2[j], tcfx[j], tcfy[j], tseg[j], tlive[j])
        return (c + 1, state)

    _, state = jax.lax.while_loop(cond, body, (jnp.asarray(1, jnp.int32), state))
    # boundary tie: 4th and 5th best keys exactly equal -> the selected set
    # is not determined by the key alone.  isfinite guards the <5-candidate
    # case (both slots INF compares equal but the set is all-eligible).
    tie = (
        (state["d2"][3] == state["d2"][4])
        & (state["T"][3] == state["T"][4])
        & jnp.isfinite(state["d2"][4])
    )
    return (
        state["count"],
        tie,
        jnp.stack(state["ln"][:4], axis=0),  # (4, H, W)
    )


def _pad_bucket(a, fill):
    n = len(a)
    p = max(-(-n // _BUCKET) * _BUCKET, _BUCKET)
    return np.concatenate([a, np.full(p - n, fill, a.dtype)])


@partial(jax.jit, static_argnames=("max_radius",))
def _extract_q(count_p, tie_p, ln_p, elev, flat, *, max_radius: int):
    """Device-side per-query extraction: gather the dense planes at the
    query cells and turn lane indices into neighbor offsets/values.  Returns
    found (P,), tie (P,), vals (4,P) elev dtype, dgi/dgj (4,P) int32 offsets
    from the query cell (zeros on unfilled slots)."""
    tb = exact_tables(max_radius)
    tdx = jnp.asarray(tb["dx"])
    tdy = jnp.asarray(tb["dy"])
    H, W = elev.shape
    found = jnp.take(count_p.reshape(-1), flat)
    tie = jnp.take(tie_p.reshape(-1), flat)
    lnq = jnp.take(ln_p.reshape(4, -1), flat, axis=1)  # (4, P)
    filled = jnp.arange(4)[:, None] < jnp.minimum(found, 4)[None, :]
    lnc = jnp.where(filled, lnq, 0)
    dgi = jnp.where(filled, jnp.take(tdx, lnc), 0)
    dgj = jnp.where(filled, jnp.take(tdy, lnc), 0)
    row = flat // W
    col = flat - row * W
    gi = jnp.clip(col[None, :] + dgi, 0, W - 1)
    gj = jnp.clip(row[None, :] + dgj, 0, H - 1)
    vals = jnp.where(filled, jnp.take(elev.reshape(-1), gj * W + gi), 0)
    return found, tie, vals, dgi, dgj


def exact_select_at_cells_fast(grid: RegularGrid, rows, cols, *, max_radius: int = 10, chunk: int = 16384):
    """Drop-in twin of exact.exact_select_at_cells for the kriging (round)
    anchor: dense pass + escalation of boundary-tie cells to the 441-lane
    kernel.  Returns (found, sel_val (N,4), sel_gi, sel_gj, q, escalated)
    with the same selected SET as the scattered kernel everywhere and the
    same slot order except inside exact-key ties (pinned by tests).
    """
    q = prepare_exact_queries(grid, rows, cols, anchor="round")
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    n = len(rows)
    H, W = grid.shape
    if n == 0:
        z = np.zeros((0, 4))
        return np.zeros(0, np.int32), z, z.astype(np.int32), z.astype(np.int32), q, np.zeros(0, bool)
    # the round anchor never shifts under the ~1e-12 residue, so the anchor
    # IS the query cell and every variant is 0; anything else means a
    # pathological extent — escalate those queries rather than mis-serve
    aligned = (q.ci == cols) & (q.cj == rows) & (q.variant == 0) & ~q.oob

    flat_np = (rows * W + cols).astype(np.int32)
    flat = _pad_bucket(np.where(aligned, flat_np, H * W).astype(np.int32), H * W)
    exq = _pad_bucket(np.where(aligned, q.ex_key, 0.0).astype(np.float32), 0.0)
    eyq = _pad_bucket(np.where(aligned, q.ey_key, 0.0).astype(np.float32), 0.0)

    count_p, tie_p, ln_p = _dense_select(
        grid.elev, grid.valid, jnp.asarray(flat), jnp.asarray(exq), jnp.asarray(eyq),
        max_radius=max_radius,
    )
    flat_q = jnp.asarray(_pad_bucket(np.clip(flat_np, 0, H * W - 1), 0))
    found_d, tie_d, vals_d, dgi_d, dgj_d = _extract_q(
        count_p, tie_p, ln_p, grid.elev, flat_q, max_radius=max_radius)
    found = np.asarray(found_d)[:n].astype(np.int32)
    tie = np.asarray(tie_d)[:n]
    sel_val = np.ascontiguousarray(np.asarray(vals_d)[:, :n].T)  # (N, 4)
    sel_gi = np.ascontiguousarray(
        (np.asarray(dgi_d)[:, :n] + cols[None, :]).astype(np.int32).T)
    sel_gj = np.ascontiguousarray(
        (np.asarray(dgj_d)[:, :n] + rows[None, :]).astype(np.int32).T)
    # unfilled slots carried offset 0 -> gi/gj would read as the query cell;
    # zero them to match the strict kernel's empty-slot convention
    unfilled = np.arange(4)[None, :] >= np.minimum(found, 4)[:, None]
    sel_gi[unfilled] = 0
    sel_gj[unfilled] = 0

    esc = (tie | ~aligned) & ~q.oob
    if esc.any():
        idx = np.nonzero(esc)[0]
        sel = partial(_select_chunk, grid.elev, grid.valid, max_radius=max_radius)
        f2, v2, gi2, gj2 = _run_chunked(
            sel, len(idx), min(chunk, len(idx)),
            q.ci[idx], q.cj[idx], q.variant[idx], q.ex_key[idx], q.ey_key[idx],
        )
        found[idx] = f2
        sel_val[idx] = v2
        sel_gi[idx] = gi2
        sel_gj[idx] = gj2
    return found, sel_val, sel_gi, sel_gj, q, esc


# ---------------------------------------------------------------------------
# lattice-gamma f64 solve (no per-point exp/sqrt emulation)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _gamma_tables(lon_step: float, lat_step: float, vg: tuple, model: str, max_radius: int = 10):
    """Host-precomputed f64 variogram tables over the selection lattice.

    gpair[dj + 2R, di + 2R] = gamma(hypot(di*lon_step, dj*lat_step))
      for neighbor-pair offsets (both neighbors carry the +0.5 cell-center
      shift, which cancels in the difference);
    gq[dy + R, dx + R]      = gamma(hypot((dx+0.5)*lon_step, (dy+0.5)*lat_step))
      for query->neighbor offsets (GridH.cpp:364-367 half-cell convention).
    """
    r = max_radius
    if model == "exponential":
        nugget, sill, rng = vg
        vf = lambda h: nugget + sill * (1.0 - np.exp(-h / rng))
    else:
        from ..variogram import variogram_model

        vf = lambda h: np.asarray(variogram_model(jnp.asarray(h, jnp.float64), vg, model))
    di = np.arange(-2 * r, 2 * r + 1, dtype=np.float64)
    gpair = vf(np.hypot(di[None, :] * lon_step, di[:, None] * lat_step))
    dq = np.arange(-r, r + 1, dtype=np.float64) + 0.5
    gq = vf(np.hypot(dq[None, :] * lon_step, dq[:, None] * lat_step))
    return np.asarray(gpair, np.float64), np.asarray(gq, np.float64)


def _krige_rows_table(vals, dgi, dgj, gpair, gq, max_radius):
    """f64 kriging solve from lattice-gamma tables, transposed operands.

    vals/dgi/dgj (4, P): neighbor values and int32 offsets from the query
    cell.  Builds the 5x6 system from 6 pairwise + 4 query gamma gathers
    (no exp/sqrt), then the shared unpivoted Gauss-Jordan.  Traced inline
    (callers jit)."""
    r = max_radius
    wp = 4 * r + 1
    wq = 2 * r + 1
    gp = gpair.reshape(-1)
    gqf = gq.reshape(-1)
    n = vals.shape[1]
    dt = vals.dtype
    one = jnp.ones((n,), dt)
    zero = jnp.zeros((n,), dt)
    g0 = gpair[2 * r, 2 * r] * jnp.ones((n,), dt)  # gamma(0) diagonal

    M = [[None] * 6 for _ in range(5)]
    for a in range(4):
        for b in range(4):
            if b < a:
                M[a][b] = M[b][a]
            elif b == a:
                M[a][b] = g0
            else:
                di = dgi[a] - dgi[b] + 2 * r
                dj = dgj[a] - dgj[b] + 2 * r
                M[a][b] = jnp.take(gp, dj * wp + di)
        M[a][4] = one
        M[a][5] = jnp.take(gqf, (dgj[a] + r) * wq + (dgi[a] + r))
    M[4] = [one, one, one, one, zero, one]

    M, singular = gj56(M, KrigingConfig().pivot_tol)
    pred = sum(M[a][5] * vals[a] for a in range(4))
    return pred, singular


@partial(jax.jit, static_argnames=("max_radius",))
def _krige_chunk_table(vals, dgi, dgj, gpair, gq, *, max_radius: int):
    """(N, 4)-layout wrapper of _krige_rows_table for the host-chunked
    escalation path."""
    return _krige_rows_table(vals.T, dgi.T, dgj.T, gpair, gq, max_radius)


@partial(jax.jit, static_argnames=("max_radius",))
def _extract_solve_table(count_p, tie_p, ln_p, elev, flat, gpair, gq, *, max_radius: int):
    """Fused device program: plane gathers at the query cells -> neighbor
    extraction -> lattice-gamma f64 solve -> found<4 fallback mean.  One
    dispatch; only (P,) arrays cross to the host."""
    found, tie, vals, dgi, dgj = _extract_q(
        count_p, tie_p, ln_p, elev, flat, max_radius=max_radius)
    vals64 = vals.astype(gpair.dtype)
    pred, singular = _krige_rows_table(vals64, dgi, dgj, gpair, gq, max_radius)
    nfill = jnp.minimum(found, 4)
    mean_found = jnp.where(found > 0, vals64.sum(axis=0) / nfill, jnp.nan)
    out = jnp.where(
        found >= 4,
        jnp.where(singular, vals64.sum(axis=0) / 4.0, pred),
        mean_found,
    )
    return out, tie, found


def exact_kriging_at_cells_fast(
    grid: RegularGrid,
    rows,
    cols,
    *,
    max_radius: int = 10,
    chunk: int = 65536,
    solve: str = "table",
):
    """Two-tier exact ordinary kriging at cell-aligned queries.

    Selection: dense streaming exact pass + boundary-tie escalation
    (set-identical to ops/exact.py's selection; see module docstring for the
    in-tie order contract).  Solve: f64; ``solve='table'`` (default) uses
    the lattice-gamma tables fused with extraction into one device program
    (value drift vs the coordinate-form solve ~1e-9 m, three orders under
    the published-table tolerance), ``solve='coords'`` uses the same
    coordinate-form f64 solve as exact_kriging_at_cells.  Requires x64 for
    published-table parity, like the strict path.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    n = len(rows)
    if n == 0:
        return np.full(0, np.nan)
    if solve == "coords":
        return _exact_kriging_coords(grid, rows, cols, max_radius=max_radius, chunk=chunk)
    if solve != "table":
        raise ValueError(solve)

    q = prepare_exact_queries(grid, rows, cols, anchor="round")
    H, W = grid.shape
    aligned = (q.ci == cols) & (q.cj == rows) & (q.variant == 0) & ~q.oob

    flat_np = (rows * W + cols).astype(np.int32)
    flat = _pad_bucket(np.where(aligned, flat_np, H * W).astype(np.int32), H * W)
    exq = _pad_bucket(np.where(aligned, q.ex_key, 0.0).astype(np.float32), 0.0)
    eyq = _pad_bucket(np.where(aligned, q.ey_key, 0.0).astype(np.float32), 0.0)

    count_p, tie_p, ln_p = _dense_select(
        grid.elev, grid.valid, jnp.asarray(flat), jnp.asarray(exq), jnp.asarray(eyq),
        max_radius=max_radius,
    )
    cfg = KrigingConfig()
    vg = (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    lon_step = (grid.max_lon - grid.min_lon) / (grid.num_lon - 1)
    lat_step = (grid.max_lat - grid.min_lat) / (grid.num_lat - 1)
    gpair, gq_t = _gamma_tables(lon_step, lat_step, vg, "exponential", max_radius)
    flat_q = jnp.asarray(_pad_bucket(np.clip(flat_np, 0, H * W - 1), 0))
    out_d, tie_d, _ = _extract_solve_table(
        count_p, tie_p, ln_p, grid.elev, flat_q,
        jnp.asarray(gpair), jnp.asarray(gq_t), max_radius=max_radius)
    out = np.array(out_d, np.float64)[:n]  # np.array: writable copy
    tie = np.asarray(tie_d)[:n]
    out[q.oob] = np.nan

    esc = (tie | ~aligned) & ~q.oob
    if esc.any():
        idx = np.nonzero(esc)[0]
        sel = partial(_select_chunk, grid.elev, grid.valid, max_radius=max_radius)
        f2, v2, gi2, gj2 = _run_chunked(
            sel, len(idx), min(chunk, len(idx)),
            q.ci[idx], q.cj[idx], q.variant[idx], q.ex_key[idx], q.ey_key[idx],
        )
        eo = np.full(len(idx), np.nan)
        few = f2 < 4
        eo[few] = _fallback_mean_np(f2[few], v2[few])
        okm = f2 >= 4
        if okm.any():
            vals = v2[okm].astype(np.float64)
            dgi = (gi2[okm] - cols[idx][okm, None]).astype(np.int32)
            dgj = (gj2[okm] - rows[idx][okm, None]).astype(np.int32)
            gpair_d = jnp.asarray(gpair)
            gq_d = jnp.asarray(gq_t)
            pred, singular = _run_chunked(
                lambda v, a, b: _krige_chunk_table(v, a, b, gpair_d, gq_d, max_radius=max_radius),
                int(okm.sum()), min(chunk, int(okm.sum())), vals, dgi, dgj,
            )
            eo[okm] = np.where(singular.astype(bool), vals.mean(axis=1), pred)
        out[idx] = eo
    return out


def _exact_kriging_coords(grid: RegularGrid, rows, cols, *, max_radius: int, chunk: int):
    """Coordinate-form f64 solve on the two-tier selection (parity
    diagnostics; same solver as exact_kriging_at_cells)."""
    found, sel_val, sel_gi, sel_gj, q, _ = exact_select_at_cells_fast(
        grid, rows, cols, max_radius=max_radius
    )
    n = len(found)
    out = np.full(n, np.nan)
    few = (found < 4) & ~q.oob
    out[few] = _fallback_mean_np(found[few], sel_val[few])

    okm = (found >= 4) & ~q.oob
    if not okm.any():
        return out
    idx = np.nonzero(okm)[0]
    vals = sel_val[okm].astype(np.float64)
    lon_step = (grid.max_lon - grid.min_lon) / (grid.num_lon - 1)
    lat_step = (grid.max_lat - grid.min_lat) / (grid.num_lat - 1)
    cx = grid.min_lon + (sel_gi[okm].astype(np.float64) + 0.5) * lon_step
    cy = grid.min_lat + (sel_gj[okm].astype(np.float64) + 0.5) * lat_step
    pred, singular = _run_chunked(
        lambda a, b, c, d, e: _krige_chunk(a, b, c, d, e),
        len(idx), min(chunk, len(idx)),
        q.qlon[okm], q.qlat[okm], vals, cx, cy,
    )
    fb4 = vals.mean(axis=1)
    out[idx] = np.where(singular.astype(bool), fb4, pred)
    return out
