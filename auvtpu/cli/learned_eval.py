"""Learned-baseline Grid B evaluation (capability extension — no reference
counterpart; motivation arXiv:2011.09707, PAPERS.md).

Protocol (honest vs the classical rows):
1. the tile is masked by the SAME seeded pipeline as bench_grid_b
   (subset_bathymetry.py semantics), so the held-out cells are identical;
2. the inpainter trains SELF-SUPERVISED on the reduced tile only — random
   crops with a further fraction of the *observed* cells hidden as targets.
   The harness's held-out cells are invalid in every training input, so no
   leakage;
3. the trained model fills the full plane once; the held-out cells are
   scored with the reference-biased metrics and appended as a
   reference-schema row (InterpolationType=Learned, GridType=B).

Run on the chip for real timings; CPU works for small nets (slow).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import GEBCO_TILES
from ..grid import RegularGrid
from ..io import ResultsWriter
from ..masking import mask_grid
from ..metrics import all_reference_metrics
from ..utils import steady_state_ms, warm_e2e_ms
from .bench_grid_b import GEBCO_ROOT_DEFAULT, load_region, log


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--region", default="mid_atlantic", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--synthetic", nargs=2, type=int, metavar=("H", "W"),
                   help="use a synthetic shelf+seamount tile instead of a region")
    p.add_argument("--removal", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=42)
    # defaults from the measured Mid-Atlantic sweep (results/learned_sweep):
    # the small net trained longer wins — w16/d2/s400 MAE 6.97 vs w32/d4/s300
    # MAE 11.9 (bigger nets under-train/overfit at these budgets)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--tile", type=int, default=48)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--region-suffix", default="",
                   help="appended to the Region column (e.g. '_seed7' for the "
                   "untouched-mask-seed evaluation rows — the hyperparameter "
                   "sweep only ever saw seed 42)")
    p.add_argument("--machine", default=None, help="default: the device kind")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (jax.config, pre-device-init)")
    p.add_argument("--save-params", default=None, metavar="NPZ",
                   help="checkpoint the trained parameters (learned.save_params)")
    p.add_argument("--load-params", default=None, metavar="NPZ",
                   help="skip training and evaluate a checkpoint instead")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from ..learned import fill_learned, learned_available, make_crop_batch, train

    if not learned_available():
        raise SystemExit("flax/optax unavailable in this environment")

    if args.synthetic:
        from ..config import Extent
        from ..synthetic import shelf_seamount

        H, W = args.synthetic
        elev, ext = shelf_seamount(H, W), Extent(0.0, float(W - 1), 0.0, float(H - 1))
        args.region = f"synthetic{H}x{W}"
    else:
        elev, ext = load_region(args.region, args.gebco_root)
    reduced, rc, truth = mask_grid(elev, args.removal, seed=args.seed)
    grid = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), ext)
    elev_plane = np.asarray(grid.elev)
    valid_plane = np.asarray(grid.valid)
    log(f"{args.region}: {elev.shape} grid, {len(truth)} held-out cells; "
        f"training {args.steps} steps (width {args.width}, depth {args.depth})")

    if args.load_params:
        from ..learned import load_params

        params, args.width, args.depth = load_params(args.load_params)
        log(f"loaded checkpoint {args.load_params} (width {args.width}, depth {args.depth})")
    else:
        t0 = time.time()
        params, hist = train(
            steps=args.steps, width=args.width, depth=args.depth, tile=args.tile,
            batch=args.batch, lr=args.lr, seed=args.seed,
            log_every=max(1, args.steps // 10), log=log,
            batch_fn=lambda rng: make_crop_batch(
                rng, elev_plane, valid_plane, n=args.batch, tile=args.tile
            ),
        )
        log(f"trained in {time.time()-t0:.1f}s; masked-crop MSE {hist[0]:.2f} -> {hist[-1]:.2f}")
    if args.save_params:
        from ..learned import save_params

        save_params(args.save_params, params, width=args.width, depth=args.depth)
        log(f"checkpointed parameters to {args.save_params}")

    fill = lambda: fill_learned(grid, params, width=args.width, depth=args.depth)
    plane = np.asarray(fill())
    pred = plane[rc[:, 0], rc[:, 1]]
    m = all_reference_metrics(truth, pred)
    log(f"held-out metrics: {m}")

    ms = steady_state_ms(fill, iters=5, warmup=1)
    cold, _ = warm_e2e_ms(fill)
    machine = args.machine or jax.devices()[0].device_kind
    w = ResultsWriter(args.results, with_region=True, with_cold=True)
    w.append(
        machine, "Learned", "B", len(truth), ms, args.removal,
        m["MAE"], m["RMSE"], m["MaxError"],
        region=args.region + args.region_suffix, cold_ms=cold,
    )
    log(f"appended Learned row to {args.results} ({ms:.2f} ms steady, {cold:.2f} ms warm e2e)")


if __name__ == "__main__":
    main()
