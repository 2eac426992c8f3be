"""QUICK vs power-law accuracy study on a coarse grid."""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.api import (
    GaussSeidelSolver,
    MatrixFreeMomentumSolver,
    SimpleSolver,
    StandardVelocityUpdater,
)
from naviflow_tpu_torch.examples._common import parse, report


def run(args):
    """``{scheme: SimulationResult}`` for power-law and QUICK."""
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    results = {}
    for scheme in ("power_law", "quick"):
        algo = SimpleSolver(
            mesh, fluid, GaussSeidelSolver(tolerance=1e-7),
            MatrixFreeMomentumSolver(tolerance=1e-8, max_iterations=120,
                                     discretization_scheme=scheme),
            StandardVelocityUpdater(),
            alpha_p=args.alpha_p, alpha_u=args.alpha_u, device=args.device,
        )
        algo.set_boundary_condition("top", "velocity", {"u": 1.0})
        t0 = time.time()
        results[scheme] = algo.solve(max_iterations=args.max_iterations,
                                     tolerance=args.tolerance)
        report(scheme, algo, results[scheme], t0)
    return results


def main(argv=None):
    run(parse(default_nx=31, default_re=400, argv=argv))


if __name__ == "__main__":
    main()
