"""Sharded mission-atlas fills: band pages distributed over the device mesh.

`plan_segments` pages are embarrassingly parallel — same snapped shape,
independent fills — so a K-page atlas fills in ceil(K/D) page-fill times on a
D-device mesh instead of K.  `build_atlas_sharded` shard_maps a dynamic-
origin page fill over a 1-D mesh (origins are DATA here, not compile-time
constants: the SPMD program is identical on every device); the page stack
comes back page-sharded and XLA inserts the gather where serving consumes
it, returning the same `BandAtlas` the single-device `ops.band.build_atlas`
produces — bit-equal planes, same serving path (`AtlasResampler` /
`BandRouter`).

Bit-equality argument for `fill_page_dynamic` vs `fill_band`'s static crop:
the margin-expanded crop here is a FIXED (pr+2m, pc+2m) window shifted
inside the grid — a superset of fill_band's edge-clipped crop — and each
cell's fill only ever reads its radius-m window, whose global cell content
is identical in both crops; the dense fills are shift-invariant given the
global (row0, col0) variogram offsets, which are passed as traced values.

No reference analog: the reference's deployment is single-GPU
(kernels.cu); this is mesh scaling for the band-serving capability.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import RegularGrid
from ..ops.band import BandAtlas, place_segments


def fill_page_dynamic(grid: RegularGrid, origin, pr: int, pc: int, *,
                      method: str = "kriging", margin: int = 10,
                      fill_backend: str = "xla",
                      convention: str = "reference", vparams=None,
                      model: str = "exponential"):
    """One (pr, pc) page fill at a TRACED (row0, col0) origin.

    The jittable twin of ops.band.fill_band's crop-fill-crop: dynamic_slice
    a fixed-size margin-expanded block (shifted inside the grid at edges),
    fill it with global variogram geometry (row0/col0 are value inputs to
    fill_kriging), and crop the page back.  Returns (plane, vmask) with
    observed cells kept and undefined cells zeroed, exactly like fill_band.
    """
    from ..ops.dense import fill_idw, fill_kriging

    H, W = grid.shape
    eh = min(pr + 2 * margin, H)
    ew = min(pc + 2 * margin, W)
    r0 = jnp.clip(origin[0] - margin, 0, H - eh)
    c0 = jnp.clip(origin[1] - margin, 0, W - ew)
    sub = RegularGrid(
        elev=jax.lax.dynamic_slice(grid.elev, (r0, c0), (eh, ew)),
        valid=jax.lax.dynamic_slice(grid.valid, (r0, c0), (eh, ew)),
        min_lon=grid.min_lon, max_lon=grid.max_lon,
        min_lat=grid.min_lat, max_lat=grid.max_lat,
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
    filled = jax.lax.dynamic_slice(filled, (origin[0] - r0, origin[1] - c0),
                                   (pr, pc))
    ev = jax.lax.dynamic_slice(grid.elev, (origin[0], origin[1]), (pr, pc))
    va = jax.lax.dynamic_slice(grid.valid, (origin[0], origin[1]), (pr, pc))
    plane = jnp.where(va > 0.5, ev, filled)
    vmask = jnp.where(jnp.isnan(plane), 0.0, 1.0).astype(grid.dtype)
    plane = jnp.where(jnp.isnan(plane), 0.0, plane)
    return plane, vmask


@partial(
    jax.jit,
    static_argnames=("mesh", "pr", "pc", "method", "margin", "fill_backend",
                     "convention", "model", "meta"),
)
def _sharded_pages_impl(elev, valid, origins, vparams, mesh, pr, pc, method,
                        margin, fill_backend, convention, model, meta):
    axis = mesh.axis_names[0]
    min_lon, max_lon, min_lat, max_lat = meta

    def local(e, v, org):
        g = RegularGrid(elev=e, valid=v, min_lon=min_lon, max_lon=max_lon,
                        min_lat=min_lat, max_lat=max_lat)

        def one(o):
            return fill_page_dynamic(
                g, o, pr, pc, method=method, margin=margin,
                fill_backend=fill_backend, convention=convention,
                vparams=vparams, model=model,
            )

        return jax.lax.map(one, org)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None)),
        out_specs=(P(axis, None, None), P(axis, None, None)),
        check_vma=(fill_backend != "fused"),
    )
    return fn(elev, valid, origins)


def build_atlas_sharded(grid: RegularGrid, segments, mesh: Mesh, *,
                        method: str = "kriging", margin: int = 10,
                        fill_backend: str = "xla",
                        convention: str = "reference", vparams=None,
                        model: str = "exponential",
                        assume_masked: bool | None = None) -> BandAtlas:
    """Mesh twin of ops.band.build_atlas: pages fill one-per-device.

    The page list is padded to a device-count multiple by repeating the last
    page (the duplicates are dropped after the gather), so any K works on
    any 1-D mesh.  Output planes are replicated — the atlas is small by
    construction (the corridor, not the grid) — and plug directly into
    AtlasResampler / BandRouter serving.
    """
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"build_atlas_sharded needs a 1-D mesh (got axes {mesh.axis_names});"
            " a second axis would silently duplicate every page fill")
    if margin < 10:
        # fill_kriging/fill_idw select to radius 10 regardless of margin;
        # fill_band's edge-clipped crop and this fixed-size shifted window
        # then expose DIFFERENT neighbor content at grid-edge pages, breaking
        # the bit-equality contract with build_atlas
        raise ValueError("build_atlas_sharded requires margin >= 10 "
                         "(the fills' max selection radius)")
    placed, pr, pc = place_segments(segments, grid.shape)
    K = len(placed)
    D = int(mesh.devices.size)
    Kp = -(-K // D) * D
    origins = np.asarray(list(placed) + [placed[-1]] * (Kp - K), np.int32)
    meta = (float(grid.min_lon), float(grid.max_lon),
            float(grid.min_lat), float(grid.max_lat))
    planes, vmasks = _sharded_pages_impl(
        grid.elev, grid.valid, jnp.asarray(origins), vparams, mesh,
        int(pr), int(pc), method, int(margin), fill_backend, convention,
        model, meta,
    )
    planes, vmasks = planes[:K], vmasks[:K]
    if assume_masked is None:
        masked = bool(jnp.min(vmasks) < 0.5)
    else:
        masked = bool(assume_masked)
    return BandAtlas(
        planes=planes,
        vmasks=vmasks,
        origins=jnp.asarray(np.asarray(placed), grid.dtype),
        masked=masked,
        placed=placed,
    )
