"""XLA/Pallas interpolation ops (the device rebuild of src/kernels.cu).

Two query modes:

- **scattered** (:mod:`auvtpu.ops.scattered`): arbitrary (lon, lat) query
  batches — the reference's benchmark workload (1 thread/point CUDA kernels,
  kernels.cu:173-546, become vectorized gathers + ``lax.top_k`` selection).
- **dense** (:mod:`auvtpu.ops.dense`): queries aligned to grid cells — mask
  fill (Grid B) and 2x upsampling (Grid A) — re-expressed as whole-grid
  stencil/shift pipelines with no per-point gathers at all.

Semantics note ("v2"): the reference's NaN fallback walks Chebyshev rings and
stops mid-search once 4 candidates are held, then runs a selection sort whose
swaps scramble equal-distance candidates (GridH.cpp:24-140).  Here we keep
the same candidate window (radius 10 -> 21x21) and the same distance
convention (cell centers at +0.5), but select the true k nearest by
(squared distance, collection order) over the whole window — deterministic,
search-order-free, and strictly no-worse interpolation.  Bit-exact reference
behavior lives in :mod:`auvtpu.golden`; the numpy twin of the v2 semantics
lives in :mod:`auvtpu.golden.v2` and is what these ops are tested against.

Bit-exact reference selection ON DEVICE (ring-segment cutoff + swap-order
tie-breaks, for published-table parity from chip runs) lives in
:mod:`auvtpu.ops.exact` (``--selection exact`` in the Grid B CLI).
"""

from .scattered import (
    scattered_bilinear,
    scattered_bicubic,
    scattered_kriging,
    scattered_idw,
)
from .dense import (
    fill_bilinear,
    fill_window_mean,
    fill_kriging,
    fill_idw,
    kriging_at_cells,
    window_topk_idx,
    window_topk_planes,
    upsample2x_bilinear,
    upsample2x_bicubic,
)
from .exact import (
    exact_bilinear_at_cells,
    exact_cubic_at_cells,
    exact_kriging_at_cells,
    exact_select_at_cells,
    prepare_exact_queries,
)
from .tiled import tiled_bicubic, tiled_bilinear, tiled_idw, tiled_kriging
from .window import window_select, ring_tables
from .batch import apply_chunked
from .two_tier import TwoTierInterpolator
from .gathers import fast_take

__all__ = [
    "scattered_bilinear",
    "scattered_bicubic",
    "scattered_kriging",
    "scattered_idw",
    "fill_bilinear",
    "fill_window_mean",
    "fill_kriging",
    "kriging_at_cells",
    "window_topk_idx",
    "window_topk_planes",
    "fill_idw",
    "upsample2x_bilinear",
    "upsample2x_bicubic",
    "exact_bilinear_at_cells",
    "exact_cubic_at_cells",
    "exact_kriging_at_cells",
    "exact_select_at_cells",
    "prepare_exact_queries",
    "tiled_bilinear",
    "tiled_bicubic",
    "tiled_kriging",
    "tiled_idw",
    "window_select",
    "ring_tables",
    "apply_chunked",
    "TwoTierInterpolator",
    "fast_take",
]
