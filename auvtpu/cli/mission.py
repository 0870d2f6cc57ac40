"""Mission serving CLI: trajectory-band/atlas kriging for AUV survey tracks.

The reference's deployment surface is `edge_app` (main.cpp): load a grid,
serve interpolation queries.  This CLI is its trajectory-serving analog:
load a (masked) grid, take an ordered mission
trajectory, let the measured-cost router pick between the packed two-tier
path and the dense band/atlas fill + windowed matmul resample (ops/band.py),
serve the batch, and report route, geometry, resolved fraction, and timings.
`--export-dir` additionally writes the serving pair as StableHLO artifacts
(serve.export_mission_fill / export_mission_resample) so production serving
needs no Python tracing.

Trajectories come from a CSV (`--trajectory-csv`, columns lon,lat) or the
built-in synthetic missions (`--synthetic band|diagonal`, the chip-probe
workloads of scripts/band_probe.py / atlas_probe.py).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import GEBCO_TILES
from ..grid import RegularGrid
from ..io import write_points_csv
from ..masking import mask_grid


def log(*a):
    print(*a, flush=True)


def synthetic_trajectory(kind: str, grid: RegularGrid, n: int, seed: int = 0):
    """The probe workloads: 'band' = monotone lon sweep + cross-track weave
    inside a ~120-row band; 'diagonal' = corner-to-corner weaving corridor.
    The weave period is fixed in PINGS (the chip probes' 5M-sample cadence:
    ~12.5k pings/cycle, so a 512-ping chunk spans ~14 rows), NOT in track
    fraction — otherwise small --pings counts would compress the weave until
    every chunk spans the full amplitude and nothing fits the resample
    window."""
    H, W = grid.shape
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = 1.0 + t * (W - 3)
    weave = np.sin(np.arange(n) * (2.0 * np.pi / 12_500.0))
    if kind == "band":
        y = H * 0.45 + min(55.0, H * 0.1) * weave
    elif kind == "diagonal":
        y = 1.0 + t * (H - 3) + min(55.0, H * 0.05) * weave
    else:
        raise ValueError(kind)
    x = np.clip(x + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(y + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    lon = (grid.min_lon + x * grid.lon_step).astype(np.float32)
    lat = (grid.min_lat + y * grid.lat_step).astype(np.float32)
    return lon, lat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--region", default=None, choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default="/root/reference/GEBCO-Data")
    p.add_argument("--grid-shape", type=int, nargs=2, default=[512, 640],
                   help="synthetic grid shape when no --region is given")
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trajectory-csv", default=None,
                   help="CSV with lon,lat columns (ordered mission track)")
    p.add_argument("--synthetic", default="band", choices=["band", "diagonal"])
    p.add_argument("--pings", type=int, default=200_000)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--win-rows", type=int, default=112)
    p.add_argument("--win-cols", type=int, default=128)
    p.add_argument("--max-bands", type=int, default=8)
    p.add_argument("--fill-backend", default="auto",
                   choices=["auto", "xla", "fused"])
    p.add_argument("--convention", default="reference",
                   choices=["reference", "centered"])
    p.add_argument("--force", default=None, choices=["band", "packed"],
                   help="skip the cost router and force a path")
    p.add_argument("--out", default=None, help="predictions CSV (lon,lat,depth)")
    p.add_argument("--export-dir", default=None,
                   help="write mission_fill.bin/mission_resample.bin here "
                   "(requires the router to have chosen/forced the band path)")
    args = p.parse_args(argv)

    from ..ops.band import BandRouter
    from ..synthetic import shelf_seamount

    if args.region:
        from .bench_grid_b import load_region

        elev, ext = load_region(args.region, args.gebco_root)
    else:
        from ..config import Extent

        H, W = args.grid_shape
        elev = shelf_seamount(H, W)
        ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
        log(f"synthetic shelf+seamount grid {H}x{W}")
    reduced, _, _ = mask_grid(elev, args.removal, args.seed)
    grid = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), ext)
    log(f"grid {grid.shape[0]}x{grid.shape[1]}, removal {args.removal}")

    if args.trajectory_csv:
        track = np.genfromtxt(args.trajectory_csv, delimiter=",", names=True)
        lon = np.atleast_1d(np.asarray(track["lon"], np.float32))
        lat = np.atleast_1d(np.asarray(track["lat"], np.float32))
    else:
        lon, lat = synthetic_trajectory(args.synthetic, grid, args.pings,
                                        args.seed)
    log(f"trajectory: {len(lon)} pings "
        f"({'csv' if args.trajectory_csv else args.synthetic})")

    router = BandRouter(
        grid, convention=args.convention, chunk=args.chunk,
        win_rows=args.win_rows, win_cols=args.win_cols,
        fill_backend=args.fill_backend, max_bands=args.max_bands,
    )
    choice = args.force or router.route(lon, lat)
    log(f"route: {choice}" + (" (forced)" if args.force else
                              f" (coherence {router.last_coherence:.4f})"))
    if args.export_dir and choice != "band":
        p.error("--export-dir requires the band path (use --force band)")

    t0 = time.perf_counter()
    if choice == "band":
        out = router.prepare(lon, lat)
        if hasattr(out, "origins"):
            k, pr, pc = out.shape
            log(f"atlas: {k} pages of {pr}x{pc} "
                f"({out.cells / 1e6:.2f}M cells, masked={out.masked})")
        else:
            log(f"band: rows {out.row0}+{out.shape[0]}, "
                f"cols {out.col0}+{out.shape[1]} "
                f"({out.cells / 1e6:.2f}M cells, masked={out.masked})")
    z = np.asarray(router.kriging(lon, lat, force=choice))
    wall = time.perf_counter() - t0
    assert np.isfinite(z).all(), "mission serving produced non-finite depths"
    if choice == "band":
        # kriging() recorded the unresolved count from its own resample
        resolved = 1.0 - router.last_unresolved / len(z)
        log(f"resolved in-band: {resolved:.4f} (rest escalated to exact "
            "two-tier kriging)")
    log(f"served {len(z)} pings in {wall * 1e3:.0f} ms cold "
        f"({len(z) / wall / 1e6:.1f} M pts/s incl. compile/fill)")

    if args.out:
        write_points_csv(args.out, lon, lat, z)
        log(f"wrote {args.out}")
    if args.export_dir:
        from ..serve import export_mission_fill, export_mission_resample

        os.makedirs(args.export_dir, exist_ok=True)
        a = router._atlas
        if a is not None:
            placed, (_, pr, pc) = a.placed, a.shape
        else:
            b = router._band
            placed, (pr, pc) = ((b.row0, b.col0),), b.shape
        extent = (grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat)
        fp = os.path.join(args.export_dir, "mission_fill.bin")
        rp = os.path.join(args.export_dir, "mission_resample.bin")
        # router.fill_backend is the RESOLVED backend (ops.backend.resolve):
        # the artifact must reproduce the live router's fill exactly
        nf = export_mission_fill(
            fp, grid.shape, placed, pr, pc, extent=extent,
            convention=args.convention, fill_backend=router.fill_backend)
        rs = router._resampler  # auto_window may have shrunk wr/wc
        # masked=True is FROZEN into the artifact and always-correct: a
        # production refresh may leave page cells undefined even if this
        # build resolved everything (serve.export_mission_resample docs)
        nr = export_mission_resample(
            rp, grid.shape, placed, pr, pc, len(lon), extent=extent,
            chunk=args.chunk, win_rows=rs.wr, win_cols=rs.wc,
            masked=True)
        log(f"exported serving pair: {fp} ({nf} B), {rp} ({nr} B)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
