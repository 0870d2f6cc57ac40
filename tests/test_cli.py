"""CLI smoke tests: in-process main(argv) runs on tiny inputs (CPU)."""

import os

import numpy as np
import pandas as pd
import pytest

from auvtpu.io import write_grid_csv
from auvtpu.synthetic import shelf_seamount


def test_gen_grid_cli(tmp_path):
    from auvtpu.cli.gen_grid import main

    out = str(tmp_path / "g.csv")
    main(["--num-lon", "12", "--num-lat", "9", "--out", out])
    g = pd.read_csv(out, header=None).to_numpy()
    assert g.shape == (9, 12)


def test_bench_grid_a_cli(tmp_path):
    from auvtpu.cli.bench_grid_a import main

    grid = str(tmp_path / "grid.npy")
    np.save(grid, shelf_seamount(40, 50))
    results = str(tmp_path / "res.csv")
    main([
        "--grid-csv", grid, "--batch-sizes", "500", "--results", results,
        "--methods", "Bilinear", "Cubic", "--expanded",
        "--expanded-out-prefix", str(tmp_path / "up"),
    ])
    df = pd.read_csv(results)
    assert len(df) == 2
    assert set(df["GridType"]) == {"A"}
    up = pd.read_csv(str(tmp_path / "up_cubic.csv"), header=None).to_numpy()
    assert up.shape == (79, 99)


def test_bench_grid_a_cli_selection_exact(tmp_path):
    # exact mode must validate against the golden (reference) oracle at the
    # tight 1e-9 tolerance — main() exits nonzero on a validation failure
    import jax

    from auvtpu.cli.bench_grid_a import main

    grid = str(tmp_path / "grid.npy")
    np.save(grid, shelf_seamount(36, 44))
    results = str(tmp_path / "res_exact.csv")
    old = jax.config.jax_enable_x64
    try:
        main([
            "--grid-csv", grid, "--batch-sizes", "300", "--results", results,
            "--selection", "exact",
        ])
    finally:
        jax.config.update("jax_enable_x64", old)
    df = pd.read_csv(results)
    assert set(df["InterpolationType"]) == {"Bilinear", "Cubic", "Kriging"}


def test_bench_grid_b_cli_with_csv_inputs(tmp_path):
    from auvtpu.cli.bench_grid_b import main
    from auvtpu.io import write_reference_missing
    from auvtpu.masking import mask_grid

    elev = shelf_seamount(40, 50)
    reduced, rc, vals = mask_grid(elev, 0.1, seed=4)
    rcsv = str(tmp_path / "reduced.csv")
    mcsv = str(tmp_path / "missing.csv")
    write_grid_csv(rcsv, reduced)
    write_reference_missing(mcsv, rc, vals)
    results = str(tmp_path / "res.csv")
    main([
        "--reduced-csv", rcsv, "--reference-csv", mcsv,
        "--min-lon", "0", "--max-lon", "49", "--min-lat", "0", "--max-lat", "39",
        "--results", results, "--out-prefix", str(tmp_path / "pts"),
    ])
    df = pd.read_csv(results)
    assert len(df) == 4  # Bilinear, Cubic, Kriging, IDW
    assert (df["BatchSize"] == len(vals)).all()
    assert df["RMSE"].notna().all()
    import jax

    kind = jax.devices()[0].device_kind.lower()
    pts = pd.read_csv(str(tmp_path / f"pts_{kind}_kriging.csv"))
    assert list(pts.columns) == ["lon", "lat", "interpolated_value"]
    assert len(pts) == len(vals)


def test_bench_grid_b_cli_exact_tiers(tmp_path):
    # --selection exact through the CLI: the two-tier engine (default) and
    # the strict oracle must agree on the error metrics to f64-solve noise
    import jax

    from auvtpu.cli.bench_grid_b import main
    from auvtpu.io import write_reference_missing
    from auvtpu.masking import mask_grid

    elev = shelf_seamount(40, 50)
    reduced, rc, vals = mask_grid(elev, 0.2, seed=7)
    rcsv = str(tmp_path / "reduced.csv")
    mcsv = str(tmp_path / "missing.csv")
    write_grid_csv(rcsv, reduced)
    write_reference_missing(mcsv, rc, vals)
    base = [
        "--reduced-csv", rcsv, "--reference-csv", mcsv,
        "--min-lon", "0", "--max-lon", "49", "--min-lat", "0", "--max-lat", "39",
        "--selection", "exact", "--methods", "Kriging",
    ]
    old = jax.config.jax_enable_x64
    try:
        main(base + ["--exact-tier", "two", "--results", str(tmp_path / "two.csv")])
        main(base + ["--exact-tier", "strict", "--results", str(tmp_path / "strict.csv")])
    finally:
        jax.config.update("jax_enable_x64", old)
    two = pd.read_csv(str(tmp_path / "two.csv"))
    strict = pd.read_csv(str(tmp_path / "strict.csv"))
    assert len(two) == 1 and len(strict) == 1
    for colm in ("MAE", "RMSE", "Max Error"):
        assert two[colm][0] == pytest.approx(strict[colm][0], abs=1e-6)


def test_bench_grid_b_cli_variogram_model(tmp_path):
    from auvtpu.cli.bench_grid_b import main
    from auvtpu.io import write_reference_missing
    from auvtpu.masking import mask_grid

    elev = shelf_seamount(40, 50)
    reduced, rc, vals = mask_grid(elev, 0.1, seed=4)
    rcsv = str(tmp_path / "reduced.csv")
    mcsv = str(tmp_path / "missing.csv")
    write_grid_csv(rcsv, reduced)
    write_reference_missing(mcsv, rc, vals)
    results = str(tmp_path / "res.csv")
    main([
        "--reduced-csv", rcsv, "--reference-csv", mcsv,
        "--min-lon", "0", "--max-lon", "49", "--min-lat", "0", "--max-lat", "39",
        "--results", results, "--methods", "Kriging",
        "--variogram-model", "gaussian",
    ])
    df = pd.read_csv(results)
    assert len(df) == 1
    assert df["Machine"].iloc[0].endswith("-gaussian")
    assert np.isfinite(df["RMSE"].iloc[0])


def test_analyze_cli(tmp_path):
    from auvtpu.cli.analyze import main
    from auvtpu.io import ResultsWriter

    results = str(tmp_path / "res.csv")
    w = ResultsWriter(results, with_region=True)
    for mach in ("CPU", "GPU"):
        w.append(mach, "Bilinear", "A", 1000, 1.5, None, None, None, None)
        w.append(mach, "Kriging", "B", 500, 2.5, 0.1, 10.0, 12.0, 99.0, region="mariana")
    main(["--results", results, "--out-dir", str(tmp_path)])
    a = pd.read_csv(str(tmp_path / "grid_A_runtimes_averaged.csv"))
    assert "CPU Bilinear" in a.columns and "GPU Bilinear" in a.columns
    b = pd.read_csv(str(tmp_path / "mariana_runtimes_errors.csv"))
    assert len(b) == 1


def test_subset_cli(tmp_path):
    path = "/root/reference/GEBCO-Data/Mid-Atlantic Ridge/GEBCO_05_May_2025_861eace686e1/gebco_2024_n1.0071_s-0.5035_w-30.9967_e-29.4993.nc"
    if not os.path.exists(path):
        pytest.skip("tile unavailable")
    from auvtpu.cli.subset import main

    main(["--nc", path, "--removal", "0.01", "--out-dir", str(tmp_path)])
    red = pd.read_csv(str(tmp_path / "reduced_data.csv"), header=None).to_numpy()
    ref = np.loadtxt(str(tmp_path / "reference_missing.csv"), delimiter=",")
    assert np.isnan(red).sum() == len(ref)
    rr, cc = ref[:, 0].astype(int), ref[:, 1].astype(int)
    assert np.isnan(red[rr, cc]).all()


def test_plots_cli(tmp_path):
    if not os.path.exists("/root/reference/GEBCO-Data"):
        pytest.skip("tiles unavailable")
    from auvtpu.cli.plots import main

    main([
        "--region", "mid_atlantic", "--removal", "0.05", "--method", "IDW",
        "--out-dir", str(tmp_path),
    ])
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    assert len(pngs) == 4


def test_figures_cli(tmp_path):
    """figures.py executes end-to-end, including the Fig. 10 hole-growth
    sweep (regression: fig_coverage was an empty stub in round 1)."""
    import matplotlib

    matplotlib.use("Agg")
    from auvtpu.cli.figures import fig_coverage, main

    png = str(tmp_path / "holes.png")
    csv = str(tmp_path / "holes.csv")
    # high removals: at f=0.05 the expected hole count on the small
    # Mid-Atlantic tile is < 1 (f^3 * 6.5k masked cells), so the growth
    # assertion needs fractions where holes are statistically certain
    df = fig_coverage(png, csv, region="mid_atlantic", removals=(0.2, 0.5),
                      gebco_root=None)  # same-shape synthetic stand-in
    assert os.path.exists(png) and os.path.exists(csv)
    assert len(df) == 2
    # the paper's qualitative finding: holes grow superlinearly with removal
    h = (1.0 - df["bilinear_coverage"]).to_numpy()
    assert h[1] > 1.5 * h[0] > 0
    # fallback methods leave no holes
    assert (df["cubic_fallback_coverage"] == 1.0).all()

    # main() with the runtime/accuracy figures on a tiny results CSV
    a_csv = str(tmp_path / "a.csv")
    pd.DataFrame(
        {
            "Machine": ["GPU"] * 2,
            "InterpolationType": ["Bilinear", "Kriging"],
            "GridType": ["A", "A"],
            "BatchSize": [1000, 1000],
            "Time": [1.0, 2.0],
            "RemovalFraction": [np.nan] * 2,
            "MAE": [np.nan] * 2,
            "RMSE": [np.nan] * 2,
            "Max Error": [np.nan] * 2,
        }
    ).to_csv(a_csv, index=False)
    main(["--grid-a", a_csv, "--grid-b", str(tmp_path / "none.csv"),
          "--out-dir", str(tmp_path / "plots"), "--coverage-region", ""])
    assert os.path.exists(str(tmp_path / "plots" / "grid_a_runtimes.png"))


def test_stream_demo_cli(tmp_path):
    from auvtpu.cli.stream_demo import main

    out = str(tmp_path / "mosaic.npy")
    rmse, span = main([
        "--mosaic", "192", "192", "--steps", "40", "--beams", "96",
        "--fill-every", "20", "--window", "96", "--out-npy", out,
    ])
    # observed-cell error is bounded by the sounding noise (default 0.5 m)
    assert rmse < 1.0
    snap = np.load(out)
    assert snap.shape == (192, 192)
    assert np.isfinite(snap).any()

    # --shard 8: the row-band-sharded mosaic runs the same survey and lands
    # the same RMSE (full bit-parity is pinned in test_streaming_sharded)
    rmse_s, _ = main([
        "--mosaic", "192", "192", "--steps", "40", "--beams", "96",
        "--fill-every", "20", "--window", "96", "--shard", "8",
    ])
    assert rmse_s == rmse

    # --shard2d 4 2: the 2-D block-sharded mosaic likewise
    rmse_s2, _ = main([
        "--mosaic", "192", "192", "--steps", "40", "--beams", "96",
        "--fill-every", "20", "--window", "96", "--shard2d", "4", "2",
    ])
    assert rmse_s2 == rmse


def test_prototype_cli(capsys, tmp_path):
    # fast smoke: same flow as the full-tile run, on a 220x260 crop
    from auvtpu.cli.prototype import main

    res = str(tmp_path / "proto.csv")
    main(["--region", "mid_atlantic", "--subset", "0.02", "--methods", "idw",
          "--k", "8", "--density", "strip", "--results", res,
          "--crop", "120", "160", "--standin"])
    out = capsys.readouterr().out
    assert "idw" in out and "% of range" in out and "(strip)" in out
    import pandas as pd

    df = pd.read_csv(res)
    assert len(df) == 1 and df["Machine"].iloc[0].endswith("-proto-strip")
    assert list(df["GridType"]) == ["P"]
    assert df["MAE"].iloc[0] > 0 and df["RMSE"].iloc[0] >= df["MAE"].iloc[0]


@pytest.mark.slow
def test_prototype_cli_full_tile(capsys, tmp_path):
    from auvtpu.cli.prototype import main

    res = str(tmp_path / "proto_full.csv")
    main(["--region", "mid_atlantic", "--subset", "0.02", "--methods", "idw",
          "--k", "8", "--density", "strip", "--results", res])
    out = capsys.readouterr().out
    assert "idw" in out and "% of range" in out and "(strip)" in out
    import pandas as pd

    df = pd.read_csv(res)
    assert len(df) == 1 and df["Machine"].iloc[0].endswith("-proto-strip")


def test_fig_variogram_models(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from auvtpu.cli.figures import fig_variogram_models

    rows = []
    for mach, mae in [("GPU", 14.8), ("GPU-gaussian", 12.9), ("GPU-spherical", 14.9)]:
        rows.append(dict(
            Machine=mach, InterpolationType="Kriging", GridType="B",
            BatchSize=1303, Time=16.0, RemovalFraction=0.01, MAE=mae,
            RMSE=mae * 1.6, **{"Max Error": 160.0}, Region="mid_atlantic",
        ))
    csv = str(tmp_path / "b.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)
    out = str(tmp_path / "zoo.png")
    assert fig_variogram_models(csv, out) is True
    assert os.path.exists(out)


def test_learned_eval_cli_synthetic(tmp_path):
    pytest.importorskip("flax")
    from auvtpu.cli.learned_eval import main

    results = str(tmp_path / "res.csv")
    main([
        "--synthetic", "48", "64", "--removal", "0.1", "--steps", "8",
        "--width", "8", "--depth", "1", "--tile", "24", "--batch", "2",
        "--results", results,
    ])
    df = pd.read_csv(results)
    assert len(df) == 1
    assert df["InterpolationType"].iloc[0] == "Learned"
    assert np.isfinite(df["RMSE"].iloc[0])
    assert df["Region"].iloc[0] == "synthetic48x64"


def test_demo_cli(capsys):
    # rebuild of the reference's de-facto smoke (main.cpp:184-203): toy grid
    # side-by-side values + benchmark validation loop; main() exits nonzero
    # if any batch's golden-vs-device validation fails
    from auvtpu.cli.demo import main

    main(["--batches", "200", "1000", "--grid-shape", "60", "80"])
    out = capsys.readouterr().out
    assert "toy 10x8 grid" in out
    assert out.count("validation PASSED") == 2
    assert "FAILED" not in out


def test_mission_cli(tmp_path, capsys):
    # mission serving surface: synthetic band mission routes 'band', serves
    # finite depths, writes the predictions CSV, and exports the AOT pair
    from auvtpu.cli.mission import main

    out_csv = str(tmp_path / "mission.csv")
    exp_dir = str(tmp_path / "aot")
    rc = main([
        "--grid-shape", "128", "256", "--removal", "0.1",
        "--synthetic", "band", "--pings", "4096", "--chunk", "128",
        "--fill-backend", "xla", "--force", "band",
        "--out", out_csv, "--export-dir", exp_dir,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "route: band (forced)" in out
    assert "resolved in-band:" in out
    import numpy as np

    track = np.genfromtxt(out_csv, delimiter=",", names=True)
    assert len(track["interpolated_value"]) == 4096
    assert np.isfinite(track["interpolated_value"]).all()
    import os

    assert os.path.getsize(os.path.join(exp_dir, "mission_fill.bin")) > 0
    assert os.path.getsize(os.path.join(exp_dir, "mission_resample.bin")) > 0
