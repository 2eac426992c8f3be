"""Shared scaffolding for the example drivers: the common flags (with
``--device``, the card by default), the report line and the plots."""

import argparse
import os
import time


def parse(default_nx=63, default_re=100, default_tol=1e-5, argv=None, **extra):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=default_nx)
    p.add_argument("--re", type=float, default=default_re)
    p.add_argument("--tolerance", type=float, default=default_tol)
    p.add_argument("--max-iterations", type=int, default=8000)
    p.add_argument("--alpha-p", type=float, default=0.3)
    p.add_argument("--alpha-u", type=float, default=0.7)
    p.add_argument("--outdir", default="results")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default, 'cpu' for the CPU")
    for k, v in extra.items():
        p.add_argument(f"--{k.replace('_', '-')}", type=type(v), default=v)
    return p.parse_args(argv)


def report(name, algo, result, t0):
    wall = time.time() - t0
    print(f"[{name}] iters={result.iterations} converged={result.converged} "
          f"wall={wall:.2f}s max_div={result.get_max_divergence():.2e}")
    v = result.validate_against_benchmark()
    print(f"[{name}] Ghia: inf={v['infinity_norm_error']:.4f} "
          f"l2={v['l2_norm_error']:.4f} passed={v['passed']}")
    return wall


def save_plots(name, result, outdir):
    os.makedirs(outdir, exist_ok=True)
    result.plot_combined_results(filename=os.path.join(outdir, f"{name}_combined.png"))
    result.plot_final_residuals(filename=os.path.join(outdir, f"{name}_residuals.png"))
    print(f"[{name}] plots -> {outdir}")
