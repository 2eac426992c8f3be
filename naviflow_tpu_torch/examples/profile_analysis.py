"""Analyze HDF5 solver profiles (analog of the reference's
``main_scripts/h5_profiler_analysis.ipynb``).

Loads one or more ``*_profile.h5`` files written by the profiler
(``utils/profiler.py``), prints a summary table, and plots residual
histories and pressure inner iterations (h5py; matplotlib for ``--plot``).

    python -m naviflow_tpu_torch.examples.profile_analysis results/*.h5 --plot profiles.png
"""

import argparse
import os

import numpy as np

from naviflow_tpu_torch.utils.profiler import require_h5py


def load_profile(path):
    h5py = require_h5py("profile_analysis")
    with h5py.File(path, "r") as f:
        out = {
            "file": os.path.basename(path),
            "algorithm": f["simulation"].attrs.get("algorithm", "?"),
            "nx": int(f["simulation"].attrs.get("mesh_nx", 0)),
            "reynolds": float(f["simulation"].attrs.get("reynolds_number", 0)),
            "total_time": float(f["performance"].attrs.get("total_time", 0)),
            "iterations": int(f["performance"].attrs.get("iterations", 0)),
            "converged": bool(f["convergence"].attrs.get("converged", False)),
            "final_residual": float(f["convergence"].attrs.get("final_residual", 0)),
            "residuals": np.asarray(f["convergence"].get("residual_history", [])),
            "accelerator": f["system"].attrs.get("accelerator", "?"),
        }
        if "pressure_solver" in f and "inner_iterations_history" in f["pressure_solver"]:
            out["inner"] = np.asarray(f["pressure_solver"]["inner_iterations_history"])
        return out


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("profiles", nargs="+")
    ap.add_argument("--plot", default=None)
    return ap.parse_args(argv)


def run(args):
    """The loaded profiles, one dict each, after printing the table."""
    rows = [load_profile(p) for p in args.profiles]
    hdr = (f"{'file':40s} {'algo':8s} {'grid':>6s} {'Re':>7s} {'iters':>6s} "
           f"{'wall[s]':>8s} {'ms/it':>7s} {'residual':>10s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        msit = 1000 * r["total_time"] / max(r["iterations"], 1)
        print(f"{r['file'][:40]:40s} {r['algorithm']:8s} {r['nx']:>6d} "
              f"{r['reynolds']:>7.0f} {r['iterations']:>6d} {r['total_time']:>8.2f} "
              f"{msit:>7.2f} {r['final_residual']:>10.2e}")
    return rows


def plot(rows, filename):
    from naviflow_tpu_torch.postprocessing.visualization import _plt

    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for r in rows:
        if r["residuals"].size:
            axes[0].semilogy(r["residuals"], label=r["file"][:28])
        if "inner" in r and r["inner"].size:
            axes[1].plot(r["inner"], label=r["file"][:28])
    axes[0].set(title="Residual history", xlabel="outer iteration")
    axes[1].set(title="Pressure inner iterations", xlabel="outer iteration")
    for ax in axes:
        ax.grid(alpha=0.3)
        ax.legend(fontsize=7)
    fig.savefig(filename, dpi=140, bbox_inches="tight")
    plt.close(fig)
    print(f"plot -> {filename}")


def main(argv=None):
    args = parse(argv)
    rows = run(args)
    if args.plot:
        plot(rows, args.plot)


if __name__ == "__main__":
    main()
