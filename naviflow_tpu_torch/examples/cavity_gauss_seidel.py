"""Red-black Gauss-Seidel pressure solve (reference study 04 gauss_seidel)."""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    AMGMomentumSolver,
    GaussSeidelSolver,
    SimpleSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report, save_plots


def run(args):
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    algo = SimpleSolver(mesh, fluid,
                        GaussSeidelSolver(tolerance=1e-6, omega=1.5),
                        AMGMomentumSolver(), StandardVelocityUpdater(),
                        alpha_p=args.alpha_p, alpha_u=args.alpha_u, device=args.device)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    t0 = time.time()
    result = algo.solve(max_iterations=args.max_iterations, tolerance=args.tolerance)
    report("gauss_seidel", algo, result, t0)
    return result


def main(argv=None):
    args = parse(default_nx=63, default_re=400, argv=argv)
    save_plots(f"gs_{args.nx}_Re{int(args.re)}", run(args), args.outdir)


if __name__ == "__main__":
    main()
