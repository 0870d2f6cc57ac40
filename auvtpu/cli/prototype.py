"""Scattered-data prototype pipeline CLI (rebuild of code/main.py +
test_interpolation.py): sample a fraction of a GEBCO tile, re-predict the
full grid from the samples, and report range-normalized RMSE per method —
the sanity-check flow the reference ran with scipy.griddata + PyKrige.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import GEBCO_TILES
from ..scattered import sample_and_reconstruct
from .bench_grid_b import load_region


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--region", default="us_east_coast", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default="/root/reference/GEBCO-Data")
    p.add_argument("--standin", action="store_true",
                   help="use a synthetic stand-in of the tile's shape and extent")
    p.add_argument("--subset", type=float, default=0.01, help="sample fraction (main.py used 0.01)")
    p.add_argument(
        "--k", type=int, default=16,
        help="moving-window neighbors (the prototype used PyKrige's "
        "n_closest_points=50; k=16 measures within noise of it at a third "
        "of the solve cost on the real tiles)",
    )
    p.add_argument("--methods", nargs="*", default=["linear", "idw", "kriging"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-prefix", default=None, help="write reconstructed grids as .npy")
    p.add_argument(
        "--model", default="exponential",
        choices=["exponential", "linear", "spherical", "gaussian", "best"],
        help="kriging variogram model ('linear' = the prototype's PyKrige "
        "choice; 'best' fits the zoo and keeps the lowest weighted SSE)",
    )
    p.add_argument(
        "--trend", default="plane", choices=["plane", "none"],
        help="kriging local trend removal (krige residuals about a weighted "
        "plane; 'none' = plain ordinary kriging like the prototype)",
    )
    p.add_argument(
        "--aniso", action="store_true",
        help="kriging only: fit a directional ellipse (nugget, sill, rx, ry, "
        "theta) from the samples and krige in correlation distance",
    )
    p.add_argument(
        "--density", default="uniform", choices=["uniform", "strip"],
        help="sample layout: 'strip' concentrates 10x sampling odds in a "
        "central row corridor (survey-track analog) — the variable-density "
        "regime where adaptive IDW's per-query power matching pays",
    )
    p.add_argument(
        "--results", default=None,
        help="append reference-schema rows (GridType=P, Machine suffixed "
        "with the density) to this CSV",
    )
    p.add_argument(
        "--crop", type=int, nargs=2, metavar=("H", "W"), default=None,
        help="use only the top-left HxW corner of the tile (fast smoke runs; "
        "the extent is rescaled to the crop so query coordinates stay valid)",
    )
    args = p.parse_args(argv)

    elev, ext = load_region(args.region, None if args.standin else args.gebco_root)
    if args.crop is not None:
        from ..config import Extent

        ch, cw = args.crop
        ch, cw = min(ch, elev.shape[0]), min(cw, elev.shape[1])
        # rescale the extent so cell spacing is preserved on the crop
        dlat = (ext.max_lat - ext.min_lat) / (elev.shape[0] - 1)
        dlon = (ext.max_lon - ext.min_lon) / (elev.shape[1] - 1)
        elev = elev[:ch, :cw]
        ext = Extent(ext.min_lon, ext.min_lon + dlon * (cw - 1),
                     ext.min_lat, ext.min_lat + dlat * (ch - 1))
    print(f"{args.region}: {elev.shape[1]} x {elev.shape[0]} cells, sampling {args.subset:.1%} ({args.density})")
    span = np.nanmax(elev) - np.nanmin(elev)

    writer = None
    if args.results:
        from ..io import ResultsWriter

        writer = ResultsWriter(args.results, with_region=True, with_cold=True)

    import jax

    machine = jax.devices()[0].device_kind
    for method in args.methods:
        t0 = time.time()
        pred, sample_mask = sample_and_reconstruct(
            elev, ext, subset_fraction=args.subset, method=method, k=args.k,
            seed=args.seed, model=args.model, trend=args.trend,
            aniso=args.aniso and method == "kriging",
            density=args.density,
        )
        dt = time.time() - t0
        hold = ~sample_mask  # score on non-sample cells (test_interpolation.py:111-146)
        err = pred[hold] - elev[hold]
        rmse = float(np.sqrt(np.nanmean(err**2)))
        mae = float(np.nanmean(np.abs(err)))
        mx = float(np.nanmax(np.abs(err)))
        print(
            f"  {method:8s}: RMSE {rmse:9.3f} m  ({100*rmse/span:5.2f}% of range)  "
            f"MAE {mae:8.3f} m  wall {dt:6.1f}s for {hold.sum()} predictions"
        )
        if writer is not None:
            writer.append(
                f"{machine}-proto-{args.density}", method, "P", int(hold.sum()),
                dt * 1e3, 1.0 - args.subset, mae, rmse, mx,
                region=args.region, cold_ms=dt * 1e3,
            )
        if args.out_prefix:
            np.save(f"{args.out_prefix}_{method}.npy", pred)


if __name__ == "__main__":
    main()
