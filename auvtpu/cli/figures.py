"""Paper-figure reproductions from results CSVs (graph_results /
performance_results notebook analogs):

- runtime vs batch size, semi-log (paper Figs. 3-4) with the reference's
  published GPU/CPU curves overlaid for context;
- Grid B MAE per region/method, reference vs centered convention;
- bilinear coverage vs removal fraction (paper Fig. 10 hole growth).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

# published reference curves (BASELINE.md Grid A table)
_REF_BATCH = [1e3, 5e3, 1e4, 5e4, 1e5, 1e6, 5e6]
_REF = {
    "CPU Bilinear": [0.2, 0.8, 1.4, 8.8, 15.4, 170.8, 830.6],
    "GPU Bilinear": [8.6, 1.6, 2.4, 6.8, 13.2, 116.8, 684.6],
    "CPU Cubic": [0.0, 3.4, 7.0, 33.6, 74.0, 678.6, 3404.4],
    "GPU Cubic": [27.4, 2.6, 6.0, 27.8, 53.2, 486.6, 2393.2],
    "CPU Kriging": [4.0, 18.0, 35.8, 165.6, 333.4, 3212.4, 16252.2],
    "GPU Kriging": [4.6, 5.8, 11.4, 47.6, 93.0, 903.2, 4484.2],
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def fig_runtimes(grid_a_csv: str, out: str):
    plt = _plt()
    df = pd.read_csv(grid_a_csv)
    a = df[df["GridType"] == "A"]
    fig, ax = plt.subplots(figsize=(8, 6), dpi=120)
    for name, ys in _REF.items():
        style = "--" if name.startswith("CPU") else ":"
        ax.plot(_REF_BATCH, ys, style, alpha=0.5, label=f"ref {name}")
    for method, sub in a.groupby("InterpolationType"):
        sub = sub.groupby("BatchSize")["Time"].mean().sort_index()
        ax.plot(sub.index, sub.values, "-o", linewidth=2, label=f"auvtpu {method}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("batch size (points)")
    ax.set_ylabel("time (ms)")
    machines = ", ".join(sorted(a["Machine"].astype(str).unique()))
    ax.set_title(f"Grid A batch interpolation runtime ({machines} vs reference)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def fig_accuracy(grid_b_csv: str, out: str):
    plt = _plt()
    df = pd.read_csv(grid_b_csv)
    b = df[(df["GridType"] == "B") & (df["InterpolationType"] != "Bilinear")]
    if "Region" not in b.columns:
        return
    fig, ax = plt.subplots(figsize=(9, 6), dpi=120)
    # a '<machine>-centered' row pairs with the '<machine>' row of the same
    # run (bench_grid_b labels the convention by that suffix)
    centered = b["Machine"].astype(str).str.endswith("-centered")
    bases = {m[: -len("-centered")] for m in b.loc[centered, "Machine"].unique()}
    labels, ref_vals, cen_vals = [], [], []
    for (region, removal, method), sub in b.groupby(
        ["Region", "RemovalFraction", "InterpolationType"]
    ):
        r = sub[sub["Machine"].isin(bases)]["MAE"].mean()
        c = sub[sub["Machine"].astype(str).str.endswith("-centered")]["MAE"].mean()
        if np.isnan(r) or np.isnan(c):
            continue
        labels.append(f"{region[:8]} {removal:g} {method[:4]}")
        ref_vals.append(r)
        cen_vals.append(c)
    x = np.arange(len(labels))
    ax.bar(x - 0.2, ref_vals, 0.4, label="reference convention")
    ax.bar(x + 0.2, cen_vals, 0.4, label="centered convention")
    ax.set_xticks(x, labels, rotation=70, fontsize=7)
    ax.set_ylabel("MAE (m)")
    ax.set_title("Grid B recovery error: reference vs centered distance convention")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)


def fig_variogram_models(grid_b_csv: str, out: str):
    """Kriging MAE per region for each variogram-model variant (Machine
    column suffix written by bench_grid_b --variogram-model)."""
    plt = _plt()
    df = pd.read_csv(grid_b_csv)
    b = df[(df["GridType"] == "B") & (df["InterpolationType"] == "Kriging")]
    if "Region" not in b.columns or b.empty:
        return False
    # variant = a KNOWN model suffix appended by bench_grid_b; -exact and
    # -centered are accuracy MODES, not model variants.  Any other machine
    # name (dashed hostnames included) is a baseline exponential row.
    models = ("linear", "spherical", "gaussian", "exponential", "best")

    def variant_of(mach):
        tail = mach.rsplit("-", 1)[-1]
        return tail if tail in models else None

    # group machines by VARIANT (collapsing every non-suffixed machine —
    # dashed hostnames included — into one baseline series), so each model
    # gets exactly one bar series regardless of how many hosts produced rows
    by_variant: dict[str, list[str]] = {}
    for mach in b["Machine"].unique():
        if mach.endswith(("-exact", "-centered")):
            continue
        key = variant_of(mach) or "exponential (ref constants)"
        by_variant.setdefault(key, []).append(mach)
    if len(by_variant) < 2:
        return False
    variants = sorted(by_variant)
    groups = sorted(
        {(r, f) for r, f in zip(b["Region"], b["RemovalFraction"])}
    )
    fig, ax = plt.subplots(figsize=(9, 5), dpi=120)
    width = 0.8 / len(variants)
    x = np.arange(len(groups))
    for i, var in enumerate(variants):
        vals = []
        for region, removal in groups:
            sub = b[(b["Region"] == region) & (b["RemovalFraction"] == removal) & b["Machine"].isin(by_variant[var])]
            vals.append(sub["MAE"].mean() if len(sub) else np.nan)
        ax.bar(x + (i - len(variants) / 2 + 0.5) * width, vals, width, label=var)
    ax.set_xticks(x, [f"{r[:10]} {f:g}" for r, f in groups], rotation=30, fontsize=8)
    ax.set_ylabel("Kriging MAE (m)")
    ax.set_title("Variogram model zoo: Grid B recovery error")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def fig_coverage(
    out_png: str,
    out_csv: str,
    region: str = "mid_atlantic",
    gebco_root: str = "/root/reference/GEBCO-Data",
    removals=(0.01, 0.05, 0.10, 0.15, 0.20, 0.30, 0.50),
):
    """Paper Fig. 10 reproduction: bilinear hole growth vs removal fraction.

    The reference's bilinear has no NaN fallback, so a masked cell whose three
    other corners are also masked stays a hole; the paper observes holes
    roughly doubling from removal 0.05 to 0.10 (graph_results.ipynb cells
    32-70).  We sweep the removal fraction on a real tile, measure the hole
    fraction among masked cells for bilinear (and the always-1.0 coverage of
    the fallback methods), and overlay the analytic expectation f^3 (given
    the center masked, all three remaining corners masked independently).
    """
    import jax

    jax.config.update("jax_platforms", jax.config.jax_platforms or "cpu")
    from ..grid import RegularGrid
    from ..masking import mask_grid
    from ..metrics import coverage
    from ..ops import fill_bilinear, fill_window_mean
    from .bench_grid_b import load_region

    elev, ext = load_region(region, gebco_root)
    rows = []
    for f in removals:
        reduced, rc, truth = mask_grid(elev, f)
        grid = RegularGrid.from_nan_array(reduced, ext)

        def at_cells(plane):
            return np.asarray(plane)[rc[:, 0], rc[:, 1]]

        pb = at_cells(fill_bilinear(grid))
        pc = at_cells(fill_window_mean(grid, k=4))
        rows.append(
            dict(
                removal=f,
                masked_pts=len(truth),
                bilinear_coverage=float(coverage(pb)),
                bilinear_holes=int(np.isnan(pb).sum()),
                cubic_fallback_coverage=float(coverage(pc)),
                analytic_hole_fraction=f**3,
            )
        )
    df = pd.DataFrame(rows)
    df.to_csv(out_csv, index=False)

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=120)
    ax.plot(df["removal"], 1.0 - df["bilinear_coverage"], "-o", linewidth=2,
            label="bilinear hole fraction (measured)")
    ax.plot(df["removal"], df["analytic_hole_fraction"], "--", alpha=0.7,
            label=r"analytic $f^3$ (3 remaining corners masked)")
    ax.plot(df["removal"], 1.0 - df["cubic_fallback_coverage"], "-s", linewidth=2,
            label="cubic/kriging fallback (no holes)")
    ax.set_xlabel("removal fraction")
    ax.set_ylabel("hole fraction among masked cells")
    ax.set_yscale("symlog", linthresh=1e-5)
    ax.set_title(f"Bilinear hole growth vs removal fraction ({region}; paper Fig. 10)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return df


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid-a", default="results_local/TestingResults1.csv")
    p.add_argument("--grid-b", default="results_local/TestingResults1.csv")
    p.add_argument("--out-dir", default="results/plots")
    p.add_argument("--coverage-region", default="mid_atlantic",
                   help="tile for the Fig. 10 hole-growth sweep ('' to skip)")
    p.add_argument("--gebco-root", default="/root/reference/GEBCO-Data")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if os.path.exists(args.grid_a):
        fig_runtimes(args.grid_a, os.path.join(args.out_dir, "grid_a_runtimes.png"))
        print("wrote grid_a_runtimes.png")
    if os.path.exists(args.grid_b):
        fig_accuracy(args.grid_b, os.path.join(args.out_dir, "grid_b_accuracy.png"))
        print("wrote grid_b_accuracy.png")
        if fig_variogram_models(
            args.grid_b, os.path.join(args.out_dir, "grid_b_variogram_models.png")
        ):
            print("wrote grid_b_variogram_models.png")
    if args.coverage_region:
        fig_coverage(
            os.path.join(args.out_dir, "bilinear_hole_growth.png"),
            os.path.join(args.out_dir, "bilinear_hole_growth.csv"),
            region=args.coverage_region,
            gebco_root=args.gebco_root,
        )
        print("wrote bilinear_hole_growth.{png,csv}")


if __name__ == "__main__":
    main()
