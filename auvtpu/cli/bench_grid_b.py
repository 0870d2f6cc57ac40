"""Grid B benchmark (rebuild of test_gebco.cpp): masked-cell recovery.

Workflow (test_gebco.cpp:100-308):
1. load a GEBCO tile (named region or CSV), flip rows, apply the seeded
   masking pipeline (or read pre-made reduced/reference CSVs);
2. predict the masked cells with bilinear / window-mean ('Cubic' — at masked
   centers the reference's bicubic always takes its fallback path) / kriging /
   IDW using the dense cell-aligned ops;
3. score MAE/RMSE/max with the reference-biased metrics; append
   reference-schema rows (GridType=B) and write per-point CSVs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import GEBCO_TILES
from ..grid import RegularGrid
from ..io import (
    ResultsWriter,
    load_gebco_flipped,
    read_grid_csv,
    read_reference_missing,
    write_points_csv,
)
from ..masking import mask_grid
from ..metrics import all_reference_metrics, coverage
from ..synthetic import kerguelen_standin
from ..utils import steady_state_ms, time_once_ms, warm_e2e_ms

GEBCO_ROOT_DEFAULT = "/root/reference/GEBCO-Data"


def log(*a):
    print(*a, flush=True)


def load_region(region: str, gebco_root: str | None):
    """(elev, extent) of a GEBCO tile.  gebco_root=None, or a tile missing
    upstream, gives a synthetic stand-in of the tile's shape and extent."""
    tile = GEBCO_TILES[region]
    if gebco_root is None or tile["path"] is None:
        log(f"{region}: synthetic stand-in {tile['shape']}")
        return kerguelen_standin(tile["shape"]), tile["extent"]
    _, _, elev = load_gebco_flipped(os.path.join(gebco_root, tile["path"]))
    return elev, tile["extent"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--region", default="mariana", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--reduced-csv", default=None, help="pre-masked grid CSV (matrix)")
    p.add_argument("--reference-csv", default=None, help="row,col,elev held-out CSV")
    p.add_argument("--min-lon", type=float), p.add_argument("--max-lon", type=float)
    p.add_argument("--min-lat", type=float), p.add_argument("--max-lat", type=float)
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--machine", default=None,
                   help="Machine column of the results CSV (default: the device kind)")
    p.add_argument("--out-prefix", default=None, help="write per-point CSVs with this prefix")
    p.add_argument("--methods", nargs="*", default=["Bilinear", "Cubic", "Kriging", "IDW"])
    p.add_argument("--idw-k", type=int, default=8)
    p.add_argument("--backend", choices=["auto", "xla", "fused"], default="auto",
                   help="kriging fill backend (auto: ops.backend.resolve)")
    p.add_argument(
        "--convention", choices=["reference", "centered"], default="reference",
        help="neighbor-distance convention: 'reference' reproduces the "
        "study's asymmetric +0.5 metric; 'centered' is the corrected "
        "symmetric metric (3-4x lower error; docs/SEMANTICS.md)",
    )
    p.add_argument(
        "--selection", choices=["v2", "exact"], default="v2",
        help="neighbor selection: 'v2' = true-k-nearest dense ops; 'exact' = "
        "bit-exact reference selection on device (ring-segment cutoff + "
        "swap tie-breaks, GridH.cpp:24-140) — reproduces the published error "
        "tables from chip runs (enables f64 for the kriging solve)",
    )
    p.add_argument(
        "--exact-tier", choices=["strict", "two"], default="two",
        help="exact-mode kriging engine: 'two' = dense streaming selection + "
        "boundary-tie escalation + lattice-gamma f64 solve (ops/exact_fast.py"
        "; ~10x faster, published digits intact); 'strict' = the 441-lane "
        "scattered kernel with full swap-order emulation (the authoritative "
        "oracle; bilinear/cubic always use it)",
    )
    p.add_argument(
        "--variogram-model", default="exponential",
        choices=["exponential", "linear", "spherical", "gaussian", "best"],
        help="kriging variogram model; non-exponential models FIT their "
        "params from the masked grid's empirical variogram (the reference "
        "constants nugget=1/sill=100/range=10 are exponential-only, "
        "GridH.cpp:371-376); 'best' fits the whole zoo and keeps the "
        "lowest weighted-SSE model",
    )
    p.add_argument("--debug", action="store_true",
                   help="sanitizer mode: jax_debug_nans (SURVEY.md §5)")
    p.add_argument("--debug-eager", action="store_true",
                   help="NaN checking + jit disabled (step-through mode)")
    args = p.parse_args(argv)

    import jax

    if args.machine is None:
        args.machine = jax.devices()[0].device_kind
    if args.debug or args.debug_eager:
        from ..utils.debug import enable_debug

        enable_debug(nans=True, disable_jit=args.debug_eager)
    if args.selection == "exact":
        # the 5x5 kriging solve needs f64 for published-table parity (an f32
        # Gauss-Jordan shifts MAE by ~2e-3 m); selection itself is f32-exact
        jax.config.update("jax_enable_x64", True)
        if args.convention != "reference":
            p.error("--selection exact implies --convention reference")

    import jax.numpy as jnp

    from ..ops import fill_bilinear, fill_idw, fill_window_mean, kriging_at_cells

    if args.reduced_csv:
        reduced = read_grid_csv(args.reduced_csv)
        rc, truth = read_reference_missing(args.reference_csv)
        from ..config import Extent

        ext = Extent(args.min_lon, args.max_lon, args.min_lat, args.max_lat)
        region_name = os.path.basename(args.reduced_csv)
    else:
        elev, ext = load_region(args.region, args.gebco_root)
        reduced, rc, truth = mask_grid(elev, args.removal, args.seed)
        region_name = args.region
    n_pts = len(truth)
    log(f"masked grid {reduced.shape[1]} x {reduced.shape[0]}, {n_pts} held-out points")

    dtype = jnp.float64 if args.selection == "exact" else jnp.float32
    grid = RegularGrid.from_nan_array(reduced, ext, dtype=dtype)
    from ..ops.backend import pick as pick_backend

    backend = pick_backend(args.backend, grid.dtype)
    rows = jnp.asarray(rc[:, 0], jnp.int32)
    cols = jnp.asarray(rc[:, 1], jnp.int32)
    results = ResultsWriter(args.results, with_region=True, with_cold=True)

    def at_cells(plane):
        return jnp.take(plane.reshape(-1), rows * grid.num_lon + cols)

    conv = args.convention
    machine = args.machine if conv == "reference" else f"{args.machine}-centered"
    if args.selection == "exact":
        from ..ops import (
            exact_bilinear_at_cells,
            exact_cubic_at_cells,
            exact_kriging_at_cells,
        )
        from ..ops.exact_fast import exact_kriging_at_cells_fast

        machine = f"{args.machine}-exact"
        krig = (
            (lambda: exact_kriging_at_cells_fast(grid, rc[:, 0], rc[:, 1]))
            if args.exact_tier == "two"
            else (lambda: exact_kriging_at_cells(grid, rc[:, 0], rc[:, 1]))
        )
        ops = {
            "Bilinear": lambda: exact_bilinear_at_cells(grid, rc[:, 0], rc[:, 1]),
            "Cubic": lambda: exact_cubic_at_cells(grid, rc[:, 0], rc[:, 1]),
            "Kriging": krig,
        }
        args.methods = [m for m in args.methods if m in ops]
    else:
        vmodel = args.variogram_model
        vparams = None
        if vmodel != "exponential":
            # the reference constants are exponential-only: fit this model
            # to the masked grid's own empirical variogram
            from ..variogram import empirical_variogram, fit_best_model, fit_model

            lags_e, gamma_e, counts_e = empirical_variogram(grid)
            step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
            if vmodel == "best":
                vmodel, vparams, sse = fit_best_model(lags_e * step, gamma_e, counts_e)
                print(f"best-fit model: {vmodel} (weighted SSE {sse:.4g})", flush=True)
            else:
                vparams = fit_model(lags_e * step, gamma_e, counts_e, model=vmodel)
            machine = f"{machine}-{vmodel}"
            print(
                f"fitted {vmodel} variogram: "
                + " ".join(f"{float(v):.4g}" for v in vparams),
                flush=True,
            )
        ops = {
            "Bilinear": lambda: at_cells(fill_bilinear(grid)),
            "Cubic": lambda: at_cells(fill_window_mean(grid, k=4, convention=conv)),
            "Kriging": lambda: kriging_at_cells(
                grid, rows, cols, convention=conv, backend=backend,
                vparams=vparams, model=vmodel,
            ),
            "IDW": lambda: at_cells(fill_idw(grid, k=args.idw_k, convention=conv)),
        }

    # more repeats for small batches, whose times are short and noisy
    iters = int(np.clip(2_000_000 // max(n_pts, 1), 5, 100))
    if args.selection == "exact":
        iters = 3  # parity mode: correctness is the product, not throughput

    for method in args.methods:
        fn = ops[method]
        first_ms, _ = time_once_ms(fn)  # compile + warmup; log-only, never CSV
        e2e_ms, out = warm_e2e_ms(fn)
        warm_ms = steady_state_ms(fn, iters=iters)
        pred = np.asarray(out, np.float64)
        m = all_reference_metrics(truth, pred)
        cov = float(coverage(pred))
        log(
            f"[B {region_name} r={args.removal}] {method:8s} end-to-end {e2e_ms:7.1f} ms  "
            f"steady {warm_ms:7.2f} ms  (first call {first_ms/1e3:6.1f} s incl. compile)  "
            f"MAE={m['MAE']:.4f} RMSE={m['RMSE']:.4f} "
            f"MAX={m['MaxError']:.3f} coverage={cov:.4f}"
        )
        results.append(
            machine, method, "B", n_pts, warm_ms, args.removal,
            m["MAE"], m["RMSE"], m["MaxError"], region=region_name,
            cold_ms=e2e_ms,
        )
        if args.out_prefix:
            qlon, qlat = grid.index_to_lonlat(rc[:, 0], rc[:, 1])
            write_points_csv(
                f"{args.out_prefix}_{machine.lower()}_{method.lower()}.csv",
                qlon, qlat, pred,
            )


if __name__ == "__main__":
    main()
