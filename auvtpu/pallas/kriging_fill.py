"""Fused ordinary-kriging fill kernel for NVIDIA GPUs (Pallas, Triton route).

One program fills one (th, tw) output tile; the whole first-4-valid
selection AND the 5x6 Gauss-Jordan solve run in registers, so the k-slot
value/offset planes that the XLA path (ops.dense.fill_kriging) carries
through device memory never leave the SM:

1. The NaN-encoded plane (invalid and out-of-grid cells are NaN) is padded
   by max_radius and passed whole; the tile reads its shifted (th, tw)
   windows with dynamic ``pl.ds`` loads.  Neighbouring windows overlap, so
   after the first touch they are served from L1/L2.
2. The statically distance-sorted offset table (ops.dense.sorted_offsets) is
   read one scalar at a time in chunks of ``_CHUNK`` inside a
   ``lax.while_loop``; the loop stops once every cell of the *tile* holds 4
   neighbours (a per-tile early exit where the XLA path waits for the
   slowest cell of the whole plane).
3. The kriging system is built and solved elementwise over the tile in the
   operation order of ops.scattered.krige_solve_cols / gj56.

Selection is identical to ops.dense.window_topk_planes: same offset order,
first-k-valid, same tie order.  Predictions agree with the XLA path to f32
rounding (the two compilers contract multiply-adds differently).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import KrigingConfig
from ..grid import RegularGrid
from ..ops.dense import _CHUNK, sorted_offsets

K = 4  # neighbours per kriging system (kernels.cu:478-546)
# Output tile (rows, cols; powers of two for Triton) and warps per program:
# the fastest of 14 tile/warp pairs on an H100 at the Kerguelen-shaped
# workload; the whole sweep fell within 0.41-0.52 ms (PERF.md).
TILE = (16, 64)
NUM_WARPS = 8


def _gamma(h, nugget, sill, vrange, model: str):
    """variogram.variogram_model, written for the kernel (range already
    clamped by the wrapper for the non-exponential models)."""
    if model == "exponential":
        return nugget + sill * (1.0 - jnp.exp(-h / vrange))
    if model == "linear":
        return nugget + sill * h
    if model == "spherical":
        m = jnp.minimum(h / vrange, 1.0)
        return nugget + sill * (1.5 * m - 0.5 * (m * m * m))
    if model == "gaussian":
        hr = h / vrange
        return nugget + sill * (1.0 - jnp.exp(-(hr * hr)))
    raise ValueError(model)


def _make_kernel(*, R: int, th: int, tw: int, H: int, W: int, n_offsets: int, n_chunks: int, half: float, pivot_tol: float, model: str, with_variance: bool, with_count: bool):
    import jax.experimental.pallas as pl

    B = 2 * R + 1  # packing stride of a slot's (dy, dx) code

    def kernel(dy_ref, dx_ref, par_ref, nanp_ref, *out_refs):
        i = pl.program_id(0)
        j = pl.program_id(1)
        r0 = i * th
        c0 = j * tw
        lrow = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0)
        lcol = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1)
        # cells of the padded tail start saturated so they never hold the
        # early exit back; their outputs are sliced off by the wrapper
        in_grid = (lrow + r0 < H) & (lcol + c0 < W)
        cnt0 = jnp.where(in_grid, 0, K).astype(jnp.int32)
        zf = jnp.zeros((th, tw), jnp.float32)
        zi = jnp.zeros((th, tw), jnp.int32)

        def cond(carry):
            c, cnt = carry[0], carry[1]
            return (c < n_chunks) & (jnp.min(cnt) < K)

        def body(carry):
            c, cnt, vals, codes = carry
            vals, codes = list(vals), list(codes)
            for t in range(_CHUNK):
                oi = c * _CHUNK + t
                dy = dy_ref[oi]
                dx = dx_ref[oi]
                v = nanp_ref[pl.ds(r0 + dy, th), pl.ds(c0 + dx, tw)]
                take = (oi < n_offsets) & (v == v) & (cnt < K)
                code = dy * B + dx
                for s in range(K):
                    hit = take & (cnt == s)
                    vals[s] = jnp.where(hit, v, vals[s])
                    codes[s] = jnp.where(hit, code, codes[s])
                cnt = cnt + take.astype(jnp.int32)
            return c + 1, cnt, tuple(vals), tuple(codes)

        _, cnt, vals, codes = jax.lax.while_loop(
            cond, body, (jnp.int32(0), cnt0, (zf,) * K, (zi,) * K)
        )

        nugget, sill, vrange = par_ref[0], par_ref[1], par_ref[2]
        min_lon, min_lat = par_ref[3], par_ref[4]
        lon_step, lat_step = par_ref[5], par_ref[6]
        row0, col0 = par_ref[7], par_ref[8]
        # global cell coordinates: integers < 2^24, so exact in f32 and
        # equal to the XLA path's iota + col0
        col = (lcol + c0).astype(jnp.float32) + col0
        row = (lrow + r0).astype(jnp.float32) + row0
        qlon = min_lon + col * lon_step
        qlat = min_lat + row * lat_step
        cx, cy = [], []
        for s in range(K):
            sdy = (codes[s] // B - R).astype(jnp.float32)
            sdx = (codes[s] % B - R).astype(jnp.float32)
            cx.append(min_lon + (col + sdx + half) * lon_step)
            cy.append(min_lat + (row + sdy + half) * lat_step)
        gamma = lambda h: _gamma(h, nugget, sill, vrange, model)

        one = zf + 1.0
        M = [[None] * 6 for _ in range(5)]
        for a in range(K):
            for b in range(K):
                if b < a:
                    M[a][b] = M[b][a]
                elif b == a:
                    # gamma(0) is exactly the nugget for every model
                    M[a][b] = zf + nugget
                else:
                    ddx = cx[a] - cx[b]
                    ddy = cy[a] - cy[b]
                    M[a][b] = gamma(jnp.sqrt(ddx * ddx + ddy * ddy))
            M[a][4] = one
            ddx = cx[a] - qlon
            ddy = cy[a] - qlat
            M[a][5] = gamma(jnp.sqrt(ddx * ddx + ddy * ddy))
        gamma0 = [M[a][5] for a in range(K)]
        M[4] = [one, one, one, one, zf, one]

        # unpivoted Gauss-Jordan, op-ordered like ops.scattered.gj56
        singular = cnt < 0
        for p in range(5):
            pivot = M[p][p]
            singular = singular | (jnp.abs(pivot) < pivot_tol)
            safe = jnp.where(singular, 1.0, pivot)
            for q in range(p, 6):
                M[p][q] = M[p][q] / safe
            for r in range(5):
                if r == p:
                    continue
                f = M[r][p]
                for q in range(p, 6):
                    M[r][q] = M[r][q] - f * M[p][q]

        vz = [jnp.where(cnt > s, vals[s], 0.0) for s in range(K)]
        pred = M[0][5] * vz[0] + M[1][5] * vz[1] + M[2][5] * vz[2] + M[3][5] * vz[3]
        cntf = cnt.astype(jnp.float32)
        fb = jnp.where(cnt > 0, (vz[0] + vz[1] + vz[2] + vz[3]) / jnp.maximum(cntf, 1.0), jnp.nan)
        bail = singular | (cnt < K)
        out_refs[0][...] = jnp.where(bail, fb, pred)
        n = 1
        if with_variance:
            var = M[0][5] * gamma0[0] + M[1][5] * gamma0[1] + M[2][5] * gamma0[2] + M[3][5] * gamma0[3]
            var = jnp.maximum(var + M[4][5], 0.0)
            out_refs[n][...] = jnp.where(bail, jnp.nan, var)
            n += 1
        if with_count:
            out_refs[n][...] = cntf

    return kernel


@partial(
    jax.jit,
    static_argnames=("max_radius", "convention", "model", "with_variance", "with_count", "interpret"),
)
def fused_fill_kriging(grid: RegularGrid, *, max_radius: int = 10, row0=0, col0=0, steps=None, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False, with_count: bool = False, interpret: bool = False):
    """Fused selection + solve; the GPU twin of ops.dense.fill_kriging with
    the same arguments.  Returns the prediction plane, or a tuple
    (plane, [variance plane], [selected-neighbour count plane]) when
    ``with_variance`` / ``with_count`` ask for them.  ``interpret=True``
    runs the kernel in the Pallas interpreter (tests on the CPU)."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as pltriton

    if grid.dtype != jnp.float32:
        raise ValueError("the fused kriging kernel is f32; use backend='xla'")
    th, tw = TILE
    R = max_radius
    cfg = KrigingConfig()
    if vparams is None:
        vparams = (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    vrange = vparams[2] if model == "exponential" else jnp.maximum(vparams[2], 1e-6)
    lat_step, lon_step = (grid.lat_step, grid.lon_step) if steps is None else steps
    par = jnp.stack([
        jnp.asarray(x, jnp.float32)
        for x in (vparams[0], vparams[1], vrange, grid.min_lon, grid.min_lat,
                  lon_step, lat_step, row0, col0)
    ])

    dxs, dys, _ = sorted_offsets(R, convention)
    m = len(dxs)
    n_chunks = -(-m // _CHUNK)
    pad = n_chunks * _CHUNK - m  # tail entries are read but never taken
    dy_tab = np.pad(dys + R, (0, pad))
    dx_tab = np.pad(dxs + R, (0, pad))

    H, W = grid.shape
    Hp = -(-H // th) * th
    Wp = -(-W // tw) * tw
    nanp = jnp.pad(
        jnp.where(grid.valid > 0.5, grid.elev, jnp.nan),
        ((R, R + Hp - H), (R, R + Wp - W)), constant_values=jnp.nan,
    )
    kernel = _make_kernel(
        R=R, th=th, tw=tw, H=H, W=W, n_offsets=m, n_chunks=n_chunks,
        half=0.5 if convention == "reference" else 0.0,
        pivot_tol=cfg.pivot_tol, model=model,
        with_variance=with_variance, with_count=with_count,
    )
    n_out = 1 + with_variance + with_count
    whole = pl.BlockSpec(memory_space=pl.ANY)
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((Hp, Wp), jnp.float32)] * n_out,
        grid=(Hp // th, Wp // tw),
        in_specs=[whole, whole, whole, whole],
        out_specs=[pl.BlockSpec((th, tw), lambda i, j: (i, j))] * n_out,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="fused_fill_kriging",
    )(jnp.asarray(dy_tab), jnp.asarray(dx_tab), par, nanp)
    outs = [o[:H, :W] for o in outs]
    return outs[0] if n_out == 1 else tuple(outs)
