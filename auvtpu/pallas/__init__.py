"""Pallas GPU kernels for the hot paths.

- fused_fill_kriging — the dense ordinary-kriging fill with selection and
  solve fused per output tile (Triton route; tested in interpret mode).

It reproduces the v2 selection semantics of ops.dense exactly (statically
distance-sorted offsets, first-k-valid, early exit once no cell can take
another candidate) and is validated against the XLA ops in
tests/test_pallas.py.
"""

from .kriging_fill import fused_fill_kriging

__all__ = ["fused_fill_kriging"]
