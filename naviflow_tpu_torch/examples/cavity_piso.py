"""PISO with two pressure corrections (reference 01 basic_cavity/pisoBasic.py)."""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    AMGMomentumSolver,
    GaussSeidelSolver,
    PisoSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report, save_plots


def run(args):
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    algo = PisoSolver(mesh, fluid, GaussSeidelSolver(tolerance=1e-6),
                      AMGMomentumSolver(), StandardVelocityUpdater(),
                      alpha_p=args.alpha_p, alpha_u=args.alpha_u,
                      n_corrections=2, device=args.device)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    t0 = time.time()
    result = algo.solve(max_iterations=args.max_iterations, tolerance=args.tolerance)
    report("piso", algo, result, t0)
    return result


def main(argv=None):
    args = parse(default_nx=63, default_re=100, argv=argv)
    save_plots(f"piso_{args.nx}_Re{int(args.re)}", run(args), args.outdir)


if __name__ == "__main__":
    main()
