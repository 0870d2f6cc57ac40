"""Float64 host-side golden model with exact reference semantics.

This package is the parity oracle: a vectorized numpy re-implementation of the
reference CPU engine (src/GridH.cpp) against which every device op is tested.
"""

from .engine import GoldenGrid, ring_offsets

__all__ = ["GoldenGrid", "ring_offsets"]
