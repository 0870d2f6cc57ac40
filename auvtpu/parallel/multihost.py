"""Multi-host (DCN) execution support.

One chip was never the design target: grids shard over a `Mesh` and every
collective in parallel/spatial.py (`psum`, `ppermute` halos) rides whatever
fabric the mesh spans — the device interconnect within a host, the
network across hosts.  This module
adds the process-bootstrap glue so the SAME `sharded_fit_fill` /
`sharded_fill` code runs across multiple processes:

- :func:`initialize` wraps ``jax.distributed.initialize`` with env
  autodetection (no-op for a single process);
- :func:`global_mesh` builds a mesh over every process's devices;
- :func:`fit_fill_multihost` is the SPMD entry each process calls with the
  full-grid numpy plane (device_put against a cross-process NamedSharding
  scatters each process's addressable shards).

Verified end-to-end by tests/test_multihost.py: two local processes, each
with 2 virtual CPU devices, form a 4-device global mesh via a real
coordinator handshake and reproduce the single-process fit+fill results
(same fitted variogram, same plane checksum).  Run standalone:

    python -m auvtpu.parallel.multihost --num-processes 2 --process-id 0 &
    python -m auvtpu.parallel.multihost --num-processes 2 --process-id 1
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join (or bootstrap) the cluster.  Arguments default from the standard
    env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID);
    with one process (or none configured) this is a no-op."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis: str = "dp"):
    """1-D mesh over every device of every process (jax.devices() is global
    after initialize())."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def fit_fill_multihost(elev_np, extent, *, max_radius: int = 10, max_lag: int = 10, n_bins: int = 10):
    """SPMD fit+fill: every process calls this with the SAME full-grid numpy
    plane; returns (plane (global Array), (nugget, sill, range) scalars).
    The scalars are replicated and host-readable on every process; the plane
    is a global array (use multihost_utils.process_allgather to pull it)."""
    from ..grid import RegularGrid
    from .spatial import sharded_fit_fill

    mesh = global_mesh()
    grid = RegularGrid.from_nan_array(np.asarray(elev_np, np.float32), extent)
    return sharded_fit_fill(mesh, grid, max_radius=max_radius, max_lag=max_lag, n_bins=n_bins)


def _child_main(argv=None):
    """Test/demo entry: join a 2+-process CPU cluster and run one fit+fill.

    Prints one line: ``MH <nugget> <sill> <range> <nansum>`` — the parent
    (tests/test_multihost.py) compares it against the single-process run.
    """
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default="127.0.0.1:9874")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=2)
    p.add_argument("--shape", type=int, nargs=2, default=[64, 40])
    args = p.parse_args(argv)

    # must happen before first jax device use
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_process}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    initialize(args.coordinator, args.num_processes, args.process_id)

    import jax.numpy as jnp

    from ..config import Extent
    from ..masking import mask_grid
    from ..synthetic import shelf_seamount

    H, W = args.shape
    elev = shelf_seamount(H, W)
    elev, _, _ = mask_grid(elev, 0.2, seed=7)
    ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
    plane, vparams = fit_fill_multihost(elev, ext, max_radius=5, max_lag=5, n_bins=5)
    chk = float(jnp.nansum(plane))  # replicated scalar: identical everywhere
    n, s, r = (float(v) for v in vparams)
    print(f"MH {n:.6g} {s:.6g} {r:.6g} {chk:.6g}", flush=True)


if __name__ == "__main__":
    _child_main()
