"""Typed configuration for the auvtpu framework.

The reference hardcodes every constant inline (geographic extents at
test_interpolation.cpp:143-144 and test_gebco.cpp:132-135, variogram constants at
GridH.cpp:372-375 / kernels.cu:379-380, ring radius at GridH.cpp:275-276, batch sizes
at test_interpolation.cpp:163, removal fraction at subset_bathymetry.py:41).  Here all
of them live in frozen dataclasses with the reference values as defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class VariogramConfig:
    """Exponential variogram gamma(h) = nugget + sill * (1 - exp(-h / range)).

    Defaults match the reference (GridH.cpp:371-376, kernels.cu:376-381); h is
    measured in degrees (the reference never projects coordinates).
    """

    nugget: float = 1.0
    sill: float = 100.0
    range: float = 10.0


@dataclasses.dataclass(frozen=True)
class FallbackConfig:
    """NaN-fallback neighbor search (GridH.cpp:24-140, kernels.cu:26-155).

    The reference walks Chebyshev rings outward from the center cell up to
    ``max_radius`` collecting valid cells, stops at the end of the first ring
    *segment* (top/bottom edges, then left/right edges) once >= ``k`` candidates
    are held, then keeps the ``k`` nearest by Euclidean distance to the query
    measured at cell centers ``(i + 0.5, j + 0.5)`` in index space.
    """

    max_radius: int = 10
    k: int = 4

    @property
    def window(self) -> int:
        return 2 * self.max_radius + 1

    @property
    def max_candidates(self) -> int:
        return self.window * self.window


@dataclasses.dataclass(frozen=True)
class KrigingConfig:
    variogram: VariogramConfig = VariogramConfig()
    fallback: FallbackConfig = FallbackConfig()
    # Gauss-Jordan singular-pivot threshold (GridH.cpp:404).
    pivot_tol: float = 1e-12


@dataclasses.dataclass(frozen=True)
class IDWConfig:
    """Inverse-distance weighting (BASELINE.json configs; generalizes the
    reference's top-4 average fallback to distance-weighted k-nearest)."""

    k: int = 8
    power: float = 2.0
    max_radius: int = 10
    eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class Extent:
    """Geographic extent of a grid: values the reference hardcodes per run."""

    min_lon: float
    max_lon: float
    min_lat: float
    max_lat: float

    def steps(self, num_lat: int, num_lon: int) -> tuple[float, float]:
        """(lat_step, lon_step) per GridH.cpp:156-157."""
        return (
            (self.max_lat - self.min_lat) / (num_lat - 1),
            (self.max_lon - self.min_lon) / (num_lon - 1),
        )


# Extents used by the reference harnesses.
GRID_A_EXTENT = Extent(min_lon=-180.0, max_lon=-160.0, min_lat=20.0, max_lat=30.0)  # test_interpolation.cpp:143-144
KERGUELEN_EXTENT = Extent(min_lon=74.615, max_lon=84.785, min_lat=-58.2508, max_lat=-49.6982)  # test_gebco.cpp:132-134

# GEBCO tiles shipped with the reference (bounds from the file names, which is
# what the reference harness keys off; the actual cell centers sit half a cell
# inside).  Paths are relative to a GEBCO data root; "shape" sizes the
# synthetic stand-in used where the tile is not available.
GEBCO_TILES = {
    "mariana": {
        "path": "Mariana Trench/GEBCO_05_May_2025_1bf90a8fdc83/gebco_2024_n13.0188_s9.0088_w137.9828_e142.0148.nc",
        "extent": Extent(min_lon=137.9828, max_lon=142.0148, min_lat=9.0088, max_lat=13.0188),
        "shape": (963, 968),  # (rows, cols), SURVEY.md §2 row 19
    },
    "mid_atlantic": {
        "path": "Mid-Atlantic Ridge/GEBCO_05_May_2025_861eace686e1/gebco_2024_n1.0071_s-0.5035_w-30.9967_e-29.4993.nc",
        "extent": Extent(min_lon=-30.9967, max_lon=-29.4993, min_lat=-0.5035, max_lat=1.0071),
        "shape": (363, 359),  # (rows, cols), SURVEY.md §2 row 19
    },
    "east_pacific": {
        "path": "East-Pacific Rise/GEBCO_05_May_2025_c75e2141a65d/gebco_2024_n12.085_s7.9541_w-112.0496_e-105.9851.nc",
        "extent": Extent(min_lon=-112.0496, max_lon=-105.9851, min_lat=7.9541, max_lat=12.085),
        "shape": (991, 1456),  # (rows, cols), SURVEY.md §2 row 19
    },
    "us_east_coast": {
        "path": "GEBCO_28_Feb_2025_5615bda1e072/gebco_2024_n38.2361_s33.7129_w-73.5773_e-70.4713.nc",
        "extent": Extent(min_lon=-73.5773, max_lon=-70.4713, min_lat=33.7129, max_lat=38.2361),
        "shape": (1086, 746),  # (rows, cols), SURVEY.md §2 row 19
    },
    "kerguelen": {
        # Tile is a missing large blob in the reference checkout; bounds from
        # subset_bathymetry.py:8 / test_gebco.cpp:132-134.  A synthetic
        # stand-in of the same shape is generated on demand.
        "path": None,
        "extent": KERGUELEN_EXTENT,
        "shape": (2053, 2441),
    },
}

# Grid A batch sizes (test_interpolation.cpp:163).
GRID_A_BATCH_SIZES: Sequence[int] = (1_000, 5_000, 10_000, 50_000, 100_000, 1_000_000, 5_000_000)

# Grid A synthetic grid dimensions (generate_csv_grids.cpp:103).
GRID_A_SHAPE = (3200, 4000)  # (num_lat, num_lon)

# Masking defaults (subset_bathymetry.py:32-41).
DEFAULT_REMOVAL_FRACTION = 0.10
DEFAULT_MASK_SEED = 42

# Cross-engine validation (test_interpolation.cpp:214-249).
VALIDATION_POINTS = 10
VALIDATION_ATOL = 1e-6

# Results CSV schema (results/TestingResults1.csv:1).
RESULTS_SCHEMA = (
    "Machine",
    "InterpolationType",
    "GridType",
    "BatchSize",
    "Time",
    "RemovalFraction",
    "MAE",
    "RMSE",
    "Max Error",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level knobs for the device engine."""

    kriging: KrigingConfig = KrigingConfig()
    fallback: FallbackConfig = FallbackConfig()
    idw: IDWConfig = IDWConfig()
    # dtype for device compute; the golden model is always float64 on host.
    dtype: str = "float32"
    # queries are processed in chunks of this many points to bound memory.
    query_chunk: int = 1 << 20
