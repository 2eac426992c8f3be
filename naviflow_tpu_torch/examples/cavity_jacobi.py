"""Jacobi-pressure SIMPLE cavity (reference study 03 jacobi).

Mirrors the reference's ``jacobi_cavity_steady_oo.py``: weighted Jacobi
(omega=0.8) pressure solve + Krylov momentum, 63^2, Re=100, alpha_p=0.1,
alpha_u=0.8, outer tolerance 1e-3.  ``main`` also writes the HDF5 profile
(h5py).
"""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    AMGMomentumSolver,
    JacobiSolver,
    SimpleSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report, save_plots


def run(args):
    """The solve and its report; the result carries the solver's
    ``profiler`` for ``main`` to write."""
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re,
                               characteristic_velocity=1.0)
    print(f"Created mesh with {args.nx}x{args.nx} cells; "
          f"dx={mesh.dx:.6f}, viscosity={fluid.get_viscosity():.6f}")

    pressure = JacobiSolver(tolerance=1e-5, max_iterations=10000, omega=0.8)
    momentum = AMGMomentumSolver(tolerance=1e-5, max_iterations=100)
    algo = SimpleSolver(mesh, fluid, pressure, momentum, StandardVelocityUpdater(),
                        alpha_p=0.1, alpha_u=0.8, device=args.device)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})

    t0 = time.time()
    result = algo.solve(max_iterations=args.max_iterations,
                        tolerance=args.tolerance, track_infinity_norm=True)
    report("jacobi", algo, result, t0)
    result.profiler = algo.profiler
    return result


def main(argv=None):
    args = parse(default_nx=63, default_re=100, default_tol=1e-3, argv=argv)
    result = run(args)
    result.profiler.save(profile_dir=args.outdir)
    save_plots(f"jacobi_{args.nx}_Re{int(args.re)}", result, args.outdir)


if __name__ == "__main__":
    main()
