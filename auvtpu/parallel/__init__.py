"""Mesh/sharding layer: scale-out across the devices of a host (or hosts).

The reference is strictly single-device (one GPU, one stream, synchronous
cudaDeviceSynchronize per batch; SURVEY.md §2 'Parallelism & distribution').
Its only parallel axis is the embarrassingly-parallel query batch.  The
equivalents here:

- **query data-parallelism**: shard scattered query batches over the mesh with
  the grid replicated (the device interconnect plays the role cudaMemcpy
  played);
- **spatial grid sharding**: split large grids into row bands with halo
  exchange (``jax.lax.ppermute`` inside ``shard_map``) so dense fills scale to
  grids bigger than one device's memory — the stencil analog of sequence
  parallelism.
"""

from .mesh import make_mesh, make_mesh2d, replicated, shard_queries
from .mission import build_atlas_sharded, fill_page_dynamic
from .spatial import sharded_fill, sharded_fill2d, sharded_fit_fill
from .streaming import ShardedStreamingInterpolator, ShardedStreamingInterpolator2D

__all__ = [
    "build_atlas_sharded",
    "fill_page_dynamic",
    "make_mesh",
    "make_mesh2d",
    "replicated",
    "shard_queries",
    "sharded_fill",
    "sharded_fill2d",
    "sharded_fit_fill",
    "ShardedStreamingInterpolator",
    "ShardedStreamingInterpolator2D",
]
