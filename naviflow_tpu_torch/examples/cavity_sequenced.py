"""Grid-sequenced / Reynolds-continuation cavity (new capability).

The reference has no analog (its FMG bootstraps only the linear pressure
solve); nonlinear grid sequencing and continuation is what converges the
1024^2-4096^2 grids and Re >= 7500 here.  Functional API (the sequencing
driver owns the per-level loop, so the object API does not apply).

    python -m naviflow_tpu_torch.examples.cavity_sequenced --nx 255 --re 1000
    python -m naviflow_tpu_torch.examples.cavity_sequenced --nx 511 --re 7500
"""

import argparse
import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.algorithms import (SIMPLEConfig, grid_sequence_solve,
                                           sequenced_continuation_solve, simple_solve)
from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error
from naviflow_tpu_torch.solvers import KrylovMomentumConfig
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--re", type=float, default=1000.0)
    ap.add_argument("--tolerance", type=float, default=1e-5)
    ap.add_argument("--coarsest", type=int, default=63)
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card by default, 'cpu' for the CPU")
    return ap.parse_args(argv)


def run(args):
    """``{'state', 'diag', 'levels', 'ghia_infinity_error', 'wall_s'}``
    (``levels``: the per-level summaries)."""
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    bc = nt.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=20000, tolerance=args.tolerance)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v",
                           check_every=2, coarsest_sweeps=32,
                           coarse_rebuild_every=8)

    t0 = time.time()
    if args.re > 5000:
        # high Re: walk the Reynolds schedule at the coarsest level first
        schedule = [r for r in (1000.0, 3200.0, 5000.0, 6500.0, 7500.0,
                                8500.0, 10000.0) if r <= args.re]
        if schedule[-1] != args.re:
            schedule.append(args.re)
        final, diag, summ = sequenced_continuation_solve(
            mesh, schedule, bc, simple_solve, cfg, momentum=mom,
            pressure=pres, loop="chunked:200", coarsest=args.coarsest,
            device=args.device)
    else:
        fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
        final, diag, summ = grid_sequence_solve(
            mesh, fluid, bc, simple_solve, cfg, momentum=mom, pressure=pres,
            loop="chunked:300", coarsest=args.coarsest, device=args.device)
    wall = time.time() - t0

    for s in summ:
        print(s)
    err = infinity_norm_error(final.u, final.v, mesh, args.re)
    print(f"wall {wall:.1f}s  converged={bool(diag.converged)}  "
          f"ghia_inf_err={err:.4f}")
    return dict(state=final, diag=diag, levels=summ, ghia_infinity_error=err, wall_s=wall)


def main(argv=None):
    run(parse(argv))


if __name__ == "__main__":
    main()
