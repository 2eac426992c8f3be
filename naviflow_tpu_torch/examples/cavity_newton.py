"""Steady Newton-Krylov past the Hopf point (capability beyond the reference).

The reference's high-Re studies (Re=7500+ on 511^2) never converged: the
cavity's steady branch is unstable to every fixed-point iteration above
Re~8000.  This driver reproduces the failure mode on purpose (a bounded
SIMPLE run that limit-cycles) and then lands on the steady branch with
``algorithms/newton.newton_solve`` (exact Jacobian-vector products from
``torch.func.jvp``, SIMPLE-preconditioned GMRES, pseudo-transient
continuation).

    python -m naviflow_tpu_torch.examples.cavity_newton --nx 127 --re 7500 --scheme quick
"""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.algorithms import (NewtonConfig, SIMPLEConfig, newton_solve,
                                           simple_solve)
from naviflow_tpu_torch.examples._common import parse
from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error
from naviflow_tpu_torch.solvers import KrylovMomentumConfig
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig


def run(args):
    """``{'state', 'diag', 'newton', 'ghia_infinity_error'}`` (``newton``:
    the Newton diagnostics, None where SIMPLE converged)."""
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    bc = nt.lid_driven_cavity(1.0)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25, scheme=args.scheme)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, check_every=2,
                           coarsest_sweeps=32)

    t0 = time.time()
    state, diag = simple_solve(
        mesh, fluid, bc, nt.initialize_state(mesh, bc, device=args.device),
        SIMPLEConfig(max_iterations=min(args.max_iterations, 3000),
                     tolerance=args.tolerance,
                     alpha_p=args.alpha_p, alpha_u=args.alpha_u),
        momentum=mom, pressure=pres, loop="chunked:500")
    print(f"[simple/{args.scheme}] residual {float(diag.final_residual):.3e} "
          f"converged={bool(diag.converged)} ({time.time() - t0:.1f}s)")

    nd = None
    if not bool(diag.converged):
        t1 = time.time()
        state, nd = newton_solve(
            mesh, fluid, bc, state,
            NewtonConfig(tolerance=args.tolerance, scheme=args.scheme),
            verbose=True)
        print(f"[newton] converged={nd.converged} iters={nd.iterations} "
              f"residual {nd.final_residual:.3e} "
              f"gmres_total={nd.gmres_iterations} ({time.time() - t1:.1f}s)")
    err = infinity_norm_error(state.u, state.v, mesh, args.re)
    print(f"[ghia] infinity error {float(err):.4f} "
          f"({'PASS' if err < 0.1 else 'FAIL'} 10% gate)")
    return dict(state=state, diag=diag, newton=nd, ghia_infinity_error=err)


def main(argv=None):
    run(parse(default_nx=127, default_re=7500, argv=argv, scheme="quick"))


if __name__ == "__main__":
    main()
