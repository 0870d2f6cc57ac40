"""Ahead-of-time export for production serving.

The reference ships compiled binaries (`edge_app`, `test_*`) that embed their
kernels; the equivalent here is a *serialized StableHLO artifact*
(jax.export): trace + lower the jitted program once, write the portable
artifact, and serve it later without retracing Python — across processes and
jax minor versions, on any backend that can compile StableHLO.

Typical flow::

    spec = export_fill("exported.bin", (2053, 2441), method="kriging")
    ...
    srv = load_exported("exported.bin")
    plane = srv(elev, valid)      # elev/valid (H, W) f32, NaN-free + mask

Shapes are static (XLA's compilation model — SURVEY.md §7); export one
artifact per tile geometry.  The artifact stores the *lowered* program, so
the Python-side fill implementation (and its compile cost) is out of the
serving path entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jexport

from .grid import RegularGrid


def _export_artifact(path: str, fn, specs, platforms):
    """Shared export tail: trace+lower the jitted fn at the given arg specs,
    serialize, write, return the byte size."""
    kw = {}
    if platforms is not None:
        kw["platforms"] = tuple(platforms)
    exp = jexport.export(jax.jit(fn), **kw)(*specs)
    blob = exp.serialize()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def _fill_fn(shape, extent, method, max_radius, vparams, convention, backend):
    from .ops import fill_idw, fill_kriging, fill_window_mean

    min_lon, max_lon, min_lat, max_lat = extent

    def fill(elev, valid):
        g = RegularGrid(
            elev=elev, valid=valid,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        if method == "kriging":
            return fill_kriging(
                g, max_radius=max_radius, vparams=vparams, convention=convention,
                backend=backend,
            )
        if method == "idw":
            return fill_idw(g, max_radius=max_radius, convention=convention)
        if method == "window_mean":
            return fill_window_mean(g, max_radius=max_radius, convention=convention)
        raise ValueError(method)

    return fill


def export_fill(path: str, shape, *, extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging", max_radius: int = 10, vparams=None, convention: str = "reference", backend: str = "xla", platforms=None):
    """Serialize the jitted dense fill for a fixed grid geometry to ``path``.

    platforms: lowering targets (default: the current backend only); pass
    e.g. ("cuda", "cpu") to produce one artifact servable on both.
    Returns the byte size written."""
    fill = _fill_fn(tuple(shape), tuple(extent), method, max_radius, vparams, convention, backend)
    spec = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return _export_artifact(path, fill, (spec, spec), platforms)


def load_exported(path: str):
    """Deserialize an export_fill artifact into a callable
    ``fill(elev, valid) -> plane`` (compiled on first call)."""
    with open(path, "rb") as f:
        exp = jexport.deserialize(f.read())

    def fill(elev, valid):
        return exp.call(jnp.asarray(elev, jnp.float32), jnp.asarray(valid, jnp.float32))

    return fill


def _scattered_fn(shape, extent, method, window_radius, vparams, convention, k, power):
    from .ops.packs import packed_idw, packed_kriging

    min_lon, max_lon, min_lat, max_lat = extent

    def run(pack, elev, valid, lons, lats):
        g = RegularGrid(
            elev=elev, valid=valid,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        if method == "kriging":
            return packed_kriging(
                pack, g, lons, lats, window_radius=window_radius,
                vparams=vparams, convention=convention,
            )
        if method == "idw":
            return packed_idw(
                pack, g, lons, lats, k=k, power=power,
                window_radius=window_radius, convention=convention,
            )
        raise ValueError(method)

    return run


def export_scattered(path: str, shape, n_queries: int, *, extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging", window_radius: int = 2, vparams=None, convention: str = "reference", k: int = 8, power: float = 2.0, platforms=None):
    """Serialize the packed scattered-query engine for a fixed grid geometry
    and query batch size: ``run(pack, elev, valid, lons, lats) -> preds``.

    The stencil pack is an *argument* (build it once per grid with
    ops.packs.StencilPack and reuse across calls), so the artifact stays
    small.  Returns the byte size written."""
    from .ops.packs import window_offsets

    H, W = shape
    P = 1
    while P < len(window_offsets(window_radius)):
        P *= 2
    run = _scattered_fn(tuple(shape), tuple(extent), method, window_radius, vparams, convention, k, power)
    plane = jax.ShapeDtypeStruct((H, W), jnp.float32)
    pack = jax.ShapeDtypeStruct((H * W * P,), jnp.float32)  # flat pack layout
    q = jax.ShapeDtypeStruct((n_queries,), jnp.float32)
    return _export_artifact(path, run, (pack, plane, plane, q, q), platforms)


def load_exported_scattered(path: str):
    """Deserialize an export_scattered artifact into
    ``run(pack, elev, valid, lons, lats) -> preds``."""
    with open(path, "rb") as f:
        exp = jexport.deserialize(f.read())

    def run(pack, elev, valid, lons, lats):
        return exp.call(
            jnp.asarray(pack, jnp.float32),
            jnp.asarray(elev, jnp.float32), jnp.asarray(valid, jnp.float32),
            jnp.asarray(lons, jnp.float32), jnp.asarray(lats, jnp.float32),
        )

    return run


def export_learned(path: str, shape, params, *, extent=(0.0, 1.0, 0.0, 1.0), width: int = 16, depth: int = 2, convention: str = "reference", platforms=None):
    """Serialize the learned fill (auvtpu.learned.fill_learned) with the
    trained parameters embedded as constants: ``fill(elev, valid) -> plane``.
    One artifact = architecture + weights + lowered program."""
    from .learned import fill_learned

    min_lon, max_lon, min_lat, max_lat = extent

    def fill(elev, valid):
        g = RegularGrid(
            elev=elev, valid=valid,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        return fill_learned(g, params, width=width, depth=depth, convention=convention)

    spec = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return _export_artifact(path, fill, (spec, spec), platforms)


def _mission_fill_fn(shape, extent, placed, pr, pc, method, margin,
                     fill_backend, convention, model):
    from .ops.band import _fill_pages

    min_lon, max_lon, min_lat, max_lat = extent

    def fill(elev, valid):
        g = RegularGrid(
            elev=elev, valid=valid,
            min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat,
        )
        return _fill_pages(
            g, None, placed=placed, pr=pr, pc=pc, method=method,
            margin=margin, fill_backend=fill_backend, convention=convention,
            model=model,
        )

    return fill


def export_mission_fill(path: str, shape, placed, pr: int, pc: int, *,
                        extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging",
                        margin: int = 10, fill_backend: str = "xla",
                        convention: str = "reference",
                        model: str = "exponential", platforms=None):
    """Serialize the one-dispatch K-page band/atlas fill for a fixed grid
    geometry and page placement: ``fill(elev, valid) -> (planes, vmasks)``.
    ``placed`` is the tuple of (row0, col0) page origins (BandAtlas.placed,
    or a single pair for one band); pages share the (pr, pc) shape.  This is
    the serving-mode refresh step of ops/band.py's BandRouter, exported so
    new observations can be folded in without any Python tracing.
    Returns the byte size written."""
    fill = _mission_fill_fn(
        tuple(shape), tuple(extent), tuple(tuple(p) for p in placed),
        int(pr), int(pc), method, margin, fill_backend, convention, model)
    spec = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return _export_artifact(path, fill, (spec, spec), platforms)


def _mission_resample_fn(shape, extent, placed, chunk, wr, wc, masked):
    from .ops.band import _atlas_resample

    H, W = shape
    min_lon, max_lon, min_lat, max_lat = extent
    lon_step = (max_lon - min_lon) / (W - 1)
    lat_step = (max_lat - min_lat) / (H - 1)
    origins_np = np.asarray(placed, np.float32)

    def run(planes, vmasks, lons, lats):
        x = (lons - min_lon) / lon_step
        y = (lats - min_lat) / lat_step
        n = x.shape[0]
        pad = (-n) % chunk
        if pad:
            # pad with the LAST query so the tail chunk stays coherent
            x = jnp.concatenate([x, jnp.broadcast_to(x[-1], (pad,))])
            y = jnp.concatenate([y, jnp.broadcast_to(y[-1], (pad,))])
        z, ok = _atlas_resample(
            planes, vmasks, jnp.asarray(origins_np), x, y,
            chunk=chunk, wr=wr, wc=wc, masked=masked,
            pick=len(placed) > 1,
        )
        return z[:n], ok[:n]

    return run


def export_mission_resample(path: str, shape, placed, pr: int, pc: int,
                            n_queries: int, *, extent=(0.0, 1.0, 0.0, 1.0),
                            chunk: int = 512, win_rows: int = 48,
                            win_cols: int = 128, masked: bool = False,
                            platforms=None):
    """Serialize the chunked matmul windowed-bilinear resample over a K-page
    band atlas for a fixed page placement and query batch size:
    ``run(planes, vmasks, lons, lats) -> (z, resolved)``.  Unresolved
    queries (page straddle / undefined cells) return NaN + False and should
    escalate to the exported scattered engine — the same two-tier shape as
    the live BandRouter.  ``masked`` is FROZEN into the artifact: pin it
    True for production refresh loops (always-correct — the vmask channel
    rides along), False only if every future refresh provably resolves all
    page cells.  Returns the byte size written."""
    placed = tuple(tuple(p) for p in placed)
    run = _mission_resample_fn(
        tuple(shape), tuple(extent), placed, int(chunk),
        min(int(win_rows), int(pr)), min(int(win_cols), int(pc)),
        bool(masked))
    pages = jax.ShapeDtypeStruct((len(placed), int(pr), int(pc)), jnp.float32)
    q = jax.ShapeDtypeStruct((int(n_queries),), jnp.float32)
    return _export_artifact(path, run, (pages, pages, q, q), platforms)


def load_exported_mission(fill_path: str, resample_path: str):
    """Deserialize an export_mission_fill / export_mission_resample pair into
    ``(fill(elev, valid) -> (planes, vmasks),
       run(planes, vmasks, lons, lats) -> (z, resolved))``."""
    with open(fill_path, "rb") as f:
        fexp = jexport.deserialize(f.read())
    with open(resample_path, "rb") as f:
        rexp = jexport.deserialize(f.read())

    def fill(elev, valid):
        return fexp.call(jnp.asarray(elev, jnp.float32),
                         jnp.asarray(valid, jnp.float32))

    def run(planes, vmasks, lons, lats):
        return rexp.call(
            jnp.asarray(planes, jnp.float32), jnp.asarray(vmasks, jnp.float32),
            jnp.asarray(lons, jnp.float32), jnp.asarray(lats, jnp.float32),
        )

    return fill, run
