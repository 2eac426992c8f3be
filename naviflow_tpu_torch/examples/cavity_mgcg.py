"""Multigrid-preconditioned CG pressure solve (reference studies 06 AMG and
07 AMG_CG: algebraic multigrid replaced by the geometric hierarchy)."""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    GeoMultigridPrecondCGSolver,
    MatrixFreeMomentumSolver,
    SimpleSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report, save_plots


def run(args):
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    algo = SimpleSolver(mesh, fluid,
                        GeoMultigridPrecondCGSolver(tolerance=1e-7, mg_cycles=1),
                        MatrixFreeMomentumSolver(tolerance=1e-6, max_iterations=40),
                        StandardVelocityUpdater(),
                        alpha_p=args.alpha_p, alpha_u=args.alpha_u, device=args.device)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    t0 = time.time()
    result = algo.solve(max_iterations=args.max_iterations, tolerance=args.tolerance)
    report("mgcg", algo, result, t0)
    return result


def main(argv=None):
    args = parse(default_nx=127, default_re=1000, argv=argv)
    save_plots(f"mgcg_{args.nx}_Re{int(args.re)}", run(args), args.outdir)


if __name__ == "__main__":
    main()
