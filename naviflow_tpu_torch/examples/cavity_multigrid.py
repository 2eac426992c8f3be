"""Geometric-multigrid SIMPLE cavity (reference study 05 geo_multigrid).

Mirrors the reference's ``GS_vcycle.py``: red-black smoothing,
full-weighting restriction, V (or FMG) cycles, outer tolerance 1e-5.
``main`` also writes the HDF5 profile (h5py).
"""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    MatrixFreeMomentumSolver,
    MultiGridSolver,
    SimpleSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report, save_plots


def run(args):
    """The solve and its report; the result carries the solver's
    ``profiler`` for ``main`` to write."""
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)

    pressure = MultiGridSolver(tolerance=1e-2, max_iterations=8,
                               pre_smoothing=2, post_smoothing=2,
                               cycle_type=args.cycle, coarsest_grid_size=7)
    momentum = MatrixFreeMomentumSolver(tolerance=1e-6, max_iterations=25)
    algo = SimpleSolver(mesh, fluid, pressure, momentum, StandardVelocityUpdater(),
                        alpha_p=args.alpha_p, alpha_u=args.alpha_u, device=args.device)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})

    t0 = time.time()
    result = algo.solve(max_iterations=args.max_iterations, tolerance=args.tolerance)
    report("multigrid", algo, result, t0)
    result.profiler = algo.profiler
    return result


def main(argv=None):
    args = parse(default_nx=63, default_re=100, argv=argv, cycle="v")
    result = run(args)
    result.profiler.save(profile_dir=args.outdir)
    save_plots(f"multigrid_{args.nx}_Re{int(args.re)}", result, args.outdir)


if __name__ == "__main__":
    main()
