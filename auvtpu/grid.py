"""Core data model: a regular lat/lon grid resident in device HBM.

Redesign of the reference's grid state (include/GridH.h:8-17,
include/GridD.h:22-28).  Differences from the reference, by design:

- **Validity mask instead of in-band NaN.**  The reference stores missing cells
  as NaN and branches on ``isnan`` inside every kernel.  Here we keep a
  separate ``valid`` mask (f32 0/1) and a NaN-free ``elev`` array so every op is
  branch-free mask arithmetic; NaN is reintroduced only at I/O boundaries
  (:func:`RegularGrid.to_nan_array`).
- **SoA queries.**  The reference's AoS ``Point{lon,lat,elev}``
  (include/Point.h:9-13) becomes plain ``(lons, lats)`` arrays.
- **Grid uploaded once.**  Like GridD's ctor-time H2D copy (src/GridD.cu:65-83),
  a ``RegularGrid`` is device-put once and reused across batches; unlike GridD
  there is no per-batch alloc/copy/free cycle.

Geometry convention (GridH.cpp:156-157): ``lon_step = (max_lon-min_lon)/(W-1)``,
row 0 is ``min_lat`` (the Grid B pipeline flips GEBCO tiles so this holds;
subset_bathymetry.py:17), normalized coords ``x = (lon-min_lon)/lon_step``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import Extent


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["elev", "valid"],
    meta_fields=["min_lon", "max_lon", "min_lat", "max_lat"],
)
@dataclasses.dataclass(frozen=True)
class RegularGrid:
    """A regular geographic grid.

    elev:  (H, W) elevations with masked cells zero-filled (never NaN).
    valid: (H, W) validity mask, same dtype as elev (1.0 = observed cell).
    Bounds are static metadata: jit re-specializes per grid geometry, which is
    the common case (one survey region per session) and lets every offset
    computation constant-fold.
    """

    elev: jax.Array
    valid: jax.Array
    min_lon: float
    max_lon: float
    min_lat: float
    max_lat: float

    # -- geometry ----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.elev.shape

    @property
    def num_lat(self) -> int:
        return self.elev.shape[0]

    @property
    def num_lon(self) -> int:
        return self.elev.shape[1]

    @property
    def lon_step(self) -> float:
        return (self.max_lon - self.min_lon) / (self.num_lon - 1)

    @property
    def lat_step(self) -> float:
        return (self.max_lat - self.min_lat) / (self.num_lat - 1)

    @property
    def extent(self) -> Extent:
        return Extent(self.min_lon, self.max_lon, self.min_lat, self.max_lat)

    @property
    def dtype(self):
        return self.elev.dtype

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_nan_array(
        cls,
        elev,
        extent: Extent,
        dtype=jnp.float32,
        device=None,
    ) -> "RegularGrid":
        """Build from a (H, W) array where missing cells are NaN.

        This is the reference's native representation (readGridCSV,
        test_gebco.cpp:19-40); we split it into (values, mask) and stage it to
        the device once.
        """
        elev = np.asarray(elev, dtype=np.float64)
        valid = np.isfinite(elev)
        filled = np.where(valid, elev, 0.0)
        ev = jnp.asarray(filled, dtype=dtype)
        va = jnp.asarray(valid, dtype=dtype)
        if device is not None:
            ev = jax.device_put(ev, device)
            va = jax.device_put(va, device)
        return cls(
            elev=ev,
            valid=va,
            min_lon=float(extent.min_lon),
            max_lon=float(extent.max_lon),
            min_lat=float(extent.min_lat),
            max_lat=float(extent.max_lat),
        )

    @classmethod
    def dense(cls, elev, extent: Extent, dtype=jnp.float32, device=None) -> "RegularGrid":
        """Build from a fully-observed (H, W) array (Grid A path)."""
        elev = jnp.asarray(np.asarray(elev), dtype=dtype)
        if device is not None:
            elev = jax.device_put(elev, device)
        return cls(
            elev=elev,
            valid=jnp.ones_like(elev),
            min_lon=float(extent.min_lon),
            max_lon=float(extent.max_lon),
            min_lat=float(extent.min_lat),
            max_lat=float(extent.max_lat),
        )

    # -- converters ---------------------------------------------------------
    def to_nan_array(self) -> np.ndarray:
        """Back to the reference's in-band-NaN representation (host, f64)."""
        elev = np.asarray(self.elev, dtype=np.float64)
        valid = np.asarray(self.valid) > 0.5
        return np.where(valid, elev, np.nan)

    def index_to_lonlat(self, rows, cols):
        """Grid indices -> geographic coords (test_gebco.cpp:72-81)."""
        lat = self.min_lat + np.asarray(rows, dtype=np.float64) * self.lat_step
        lon = self.min_lon + np.asarray(cols, dtype=np.float64) * self.lon_step
        return lon, lat

    def lonlat_to_xy(self, lons, lats):
        """Geographic coords -> continuous grid coords (x=col, y=row)."""
        x = (jnp.asarray(lons) - self.min_lon) / self.lon_step
        y = (jnp.asarray(lats) - self.min_lat) / self.lat_step
        return x, y
