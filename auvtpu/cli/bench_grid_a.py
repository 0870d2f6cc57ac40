"""Grid A benchmark (rebuild of test_interpolation.cpp).

Workflow (test_interpolation.cpp:115-322):
1. load/generate the synthetic grid (default 4000x3200 shelf+seamount,
   extents lon -180..-160, lat 20..30);
2. per batch size, generate uniform random query points (seeded jax PRNG —
   fixing the reference's unseeded std::random_device, SURVEY.md §4 item 5)
   and time bilinear/bicubic/kriging on the device;
3. cross-validate the first 10 points against the float64 golden engine at
   a f32-appropriate tolerance (the reference compared CPU vs GPU at 1e-6,
   both f64: test_interpolation.cpp:214-249);
4. append reference-schema rows (GridType=A, error columns 'nan');
5. optional expanded-grid pass: 2x-densified full-grid interpolation written
   as grid CSVs (test_interpolation.cpp:283-306) via the dense upsample ops.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import GRID_A_BATCH_SIZES, GRID_A_EXTENT, GRID_A_SHAPE, VALIDATION_POINTS
from ..golden import GoldenGrid
from ..grid import RegularGrid
from ..io import ResultsWriter, read_grid_csv, write_grid_csv
from ..synthetic import shelf_seamount
from ..utils import steady_state_ms, time_once_ms, warm_e2e_ms


def log(*a):
    print(*a, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid-csv", default=None, help="input grid (csv/npy); default: generate")
    p.add_argument("--num-lon", type=int, default=GRID_A_SHAPE[1])
    p.add_argument("--num-lat", type=int, default=GRID_A_SHAPE[0])
    p.add_argument("--batch-sizes", type=int, nargs="*", default=list(GRID_A_BATCH_SIZES))
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--machine", default=None,
                   help="Machine column of the results CSV (default: the device kind)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--expanded", action="store_true", help="run the 2x upsample pass")
    p.add_argument("--expanded-out-prefix", default="results_local/interpolated")
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--methods", nargs="*", default=["Bilinear", "Cubic", "Kriging", "IDW"])
    p.add_argument("--packed", action="store_true", default=True,
                   help="use stencil packs (one gather per query)")
    p.add_argument("--no-packed", dest="packed", action="store_false")
    p.add_argument(
        "--window-radius", type=int, default=2,
        help="candidate window radius for kriging/IDW; 2 is exact on fully-"
        "valid grids (the k<=8 nearest cells always lie within Chebyshev 2)",
    )
    p.add_argument(
        "--selection", choices=["v2", "exact"], default="v2",
        help="exact = reproduce the reference CPU engine digit-for-digit at "
        "arbitrary coordinates (f64 ring selection, ops/exact.py; enables "
        "x64). v2 = true-k-nearest production semantics.",
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
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ..ops import (
        scattered_bicubic,
        scattered_bilinear,
        scattered_idw,
        scattered_kriging,
        upsample2x_bicubic,
        upsample2x_bilinear,
    )

    if args.grid_csv:
        elev = np.load(args.grid_csv) if args.grid_csv.endswith(".npy") else read_grid_csv(args.grid_csv)
    else:
        log(f"generating {args.num_lon}x{args.num_lat} shelf+seamount grid ...")
        elev = shelf_seamount(args.num_lat, args.num_lon)
    ext = GRID_A_EXTENT
    log(f"grid dimensions: {elev.shape[1]} x {elev.shape[0]}")

    grid = RegularGrid.dense(elev, ext)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    # kriging/IDW use the v2 selection semantics (true k-nearest; see
    # docs/SEMANTICS.md) -> validate against the v2 float64 oracle
    from ..golden.v2 import GoldenV2

    golden_v2 = GoldenV2(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    results = ResultsWriter(args.results, with_region=True, with_cold=True)

    # fully-valid grid: cubic can statically skip the fallback window
    from ..ops import apply_chunked

    R = args.window_radius
    if args.selection == "exact":
        # device f64 path reproducing the golden (= reference CPU) engine
        # digit-for-digit at arbitrary coordinates; validated below against
        # the golden oracle at 1e-9 instead of the f32 tolerance
        from ..ops.exact import (
            exact_bilinear_scattered,
            exact_cubic_scattered,
            exact_kriging_scattered,
        )

        grid = RegularGrid.from_nan_array(
            np.asarray(elev, np.float64), ext, dtype=np.float64
        )
        ops = {
            "Bilinear": lambda g, lo, la: exact_bilinear_scattered(g, lo, la),
            "Cubic": lambda g, lo, la: exact_cubic_scattered(g, lo, la, max_radius=R if R > 2 else 10),
            "Kriging": lambda g, lo, la: exact_kriging_scattered(g, lo, la, max_radius=R if R > 2 else 10),
        }
        dropped = [m for m in args.methods if m not in ops]
        if dropped:
            log(f"exact mode: dropping unsupported methods {dropped} "
                "(the reference engine has no scattered IDW to be exact against)")
        args.methods = [m for m in args.methods if m in ops]
    elif args.packed:
        # stencil packs: every query fetches its whole neighborhood in ONE
        # row-block gather (ops/packs.py); pack build amortizes like the
        # reference's ctor-time grid upload
        from ..ops.packs import (
            StencilPack,
            packed_bicubic,
            packed_bilinear,
            packed_idw,
            packed_kriging,
        )

        log("building stencil packs (bilinear 4x, bicubic 16x, window 32x grid bytes)")
        sp = StencilPack(grid, window_radius=min(R, 2))
        # fully-observed grid => single-reduction fast path (no fallback pass)
        av = bool(np.isfinite(np.asarray(elev)).all())
        if av and R <= 2:
            # fully-valid grids: the top-4 candidate set provably fits a
            # 16-lane pack (ops.packs.packed_kriging_valid) — selection
            # tensors halve
            from ..ops.packs import build_valid16_pack, packed_kriging_valid

            p16 = build_valid16_pack(grid)
            krig = lambda g, lo, la: packed_kriging_valid(p16, g, lo, la)
            idw = lambda g, lo, la: packed_idw(
                sp.window, g, lo, la, window_radius=sp.window_radius
            )
        else:
            krig = lambda g, lo, la: packed_kriging(
                sp.window, g, lo, la, window_radius=sp.window_radius
            )
            idw = lambda g, lo, la: packed_idw(
                sp.window, g, lo, la, window_radius=sp.window_radius
            )
        ops = {
            "Bilinear": lambda g, lo, la: packed_bilinear(sp.bilinear, g, lo, la, assume_valid=av),
            "Cubic": lambda g, lo, la: packed_bicubic(sp.bicubic, g, lo, la, assume_valid=av),
            "Kriging": krig,
            "IDW": idw,
        }
    else:
        # windowed ops materialize (N, (2R+1)^2) candidates: chunk big
        # batches so the fast-gather path stays in memory (dispatches queue
        # asynchronously, so chunking costs no extra host round-trips)
        win_chunk = max((1 << 22) // ((2 * R + 1) ** 2), 1 << 16)

        def chunked(fn, **kw):
            return lambda g, lo, la: apply_chunked(fn, g, lo, la, chunk=win_chunk, **kw)

        ops = {
            "Bilinear": lambda g, lo, la: scattered_bilinear(g, lo, la),
            "Cubic": lambda g, lo, la: scattered_bicubic(g, lo, la, fallback="never"),
            "Kriging": chunked(scattered_kriging, max_radius=R),
            "IDW": chunked(scattered_idw, max_radius=R),
        }
    goldens = {
        "Bilinear": golden.bilinear,
        "Cubic": golden.cubic,
        # exact mode targets the reference engine itself; v2 targets its
        # documented true-k-nearest semantics (docs/SEMANTICS.md)
        "Kriging": golden.kriging if args.selection == "exact" else golden_v2.kriging,
        "IDW": lambda lo, la: golden_v2.idw(lo, la, k=8),
    }

    key = jax.random.PRNGKey(args.seed)
    overall_ok = True
    for n in args.batch_sizes:
        key, k1, k2 = jax.random.split(key, 3)
        eps = 1e-6
        lons = jax.random.uniform(k1, (n,), jnp.float32, ext.min_lon + eps, ext.max_lon - eps)
        lats = jax.random.uniform(k2, (n,), jnp.float32, ext.min_lat + eps, ext.max_lat - eps)
        lons_h = np.asarray(lons, np.float64)
        lats_h = np.asarray(lats, np.float64)

        # more repeats for small batches, whose times are short and noisy
        iters = int(np.clip(2_000_000 // max(n, 1), 5, 100))
        if args.selection == "exact":
            # exact mode is the parity path (host-chunked f64), not the
            # throughput path; queries go in as raw f64 coordinates
            qlo, qla = lons_h, lats_h
            iters = 2
        else:
            qlo, qla = lons, lats
        for method in args.methods:
            fn = ops[method]
            first_ms, _ = time_once_ms(fn, grid, qlo, qla)  # compile; log-only
            e2e_ms, out = warm_e2e_ms(fn, grid, qlo, qla)
            warm_ms = steady_state_ms(fn, grid, qlo, qla, iters=iters)
            log(
                f"[A n={n:>9}] {method:8s} end-to-end {e2e_ms:8.1f} ms   "
                f"steady {warm_ms:8.2f} ms  ({n/warm_ms*1e3/1e6:7.2f} M pts/s)"
                f"  [first call {first_ms/1e3:.1f} s incl. compile]"
            )
            results.append(
                args.machine, method, "A", n, warm_ms, None, None, None, None,
                region="grid_a", cold_ms=e2e_ms,
            )

            if args.validate and goldens[method] is not None and n <= 1_000_000:
                m = min(VALIDATION_POINTS, n)
                want = goldens[method](lons_h[:m], lats_h[:m])
                got = np.asarray(out)[:m]
                scale = max(1.0, float(np.nanmax(np.abs(want))))
                tol = 1e-9 if args.selection == "exact" else 5e-5
                ok = np.allclose(got, want, atol=tol * scale, equal_nan=True)
                overall_ok &= ok
                log(f"          validation vs golden ({m} pts): {'PASSED' if ok else 'FAILED'}")

    if args.expanded:
        for name, up in [("bilin", upsample2x_bilinear), ("cubic", upsample2x_bicubic)]:
            ms, out = time_once_ms(up, grid)
            out = np.asarray(out)
            path = f"{args.expanded_out_prefix}_{name}.csv"
            log(f"expanded 2x {name}: {out.shape} in {ms:.1f} ms -> {path}")
            write_grid_csv(path, out)
        # kriging/IDW have no separable form: run the scattered op over the
        # expanded lattice (queries at half-integer grid coords,
        # test_interpolation.cpp:91-109) in chunks
        Hn, Wn = 2 * grid.num_lat - 1, 2 * grid.num_lon - 1
        lo = ext.min_lon + np.arange(Wn, dtype=np.float64) * (ext.max_lon - ext.min_lon) / (Wn - 1)
        la = ext.min_lat + np.arange(Hn, dtype=np.float64) * (ext.max_lat - ext.min_lat) / (Hn - 1)
        LO, LA = np.meshgrid(lo.astype(np.float32), la.astype(np.float32))
        import time as _t

        for name, fn in [("kriging", ops["Kriging"]), ("idw", ops["IDW"])]:
            t0 = _t.perf_counter()
            out = np.asarray(
                apply_chunked(
                    lambda g, lo_, la_, _f=fn: _f(g, lo_, la_),
                    grid, LO.ravel(), LA.ravel(), chunk=1 << 21,
                )
            ).reshape(Hn, Wn)
            ms = (_t.perf_counter() - t0) * 1e3
            path = f"{args.expanded_out_prefix}_{name}.csv"
            log(f"expanded 2x {name}: {out.shape} in {ms:.1f} ms -> {path}")
            write_grid_csv(path, out)

    if not overall_ok:
        log("VALIDATION FAILED")
        sys.exit(1)


if __name__ == "__main__":
    main()
