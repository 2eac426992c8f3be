"""Command-line driver (port of ``naviflow_tpu/cli.py``).

The reference has no CLI: its configuration is constants copied into 20+
driver scripts plus a shell job farm that invokes a (missing) argparse
script with ``--nx/--reynolds`` flags.  This module is that driver: one
entry point covering every algorithm / solver combination, plus a sweep
mode in place of the shell farm.  It runs on the card unless
``--device cpu`` is given, and exits non-zero where the card is asked for
and there is none.

Examples::

    python -m naviflow_tpu_torch.cli run --nx 63 --re 100 --algorithm simple \
        --pressure multigrid --tolerance 1e-5 --save out.npz
    python -m naviflow_tpu_torch.cli sweep --nx 63 127 --re 100 1000 --out results/
    python -m naviflow_tpu_torch.cli run --nx 31 --device cpu --f64

``--plot``, ``--save *.h5`` and ``--profile``'s HDF5 need matplotlib /
h5py, which are imported when used.  ``--f64`` on the card runs composed:
every kernel gate admits float32 only.  Under ``torchrun``,
``--distributed`` brings the process group up from torchrun's environment
and rank 0 alone prints and writes files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _build_parser():
    p = argparse.ArgumentParser(prog="naviflow_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run one cavity case")
    _case_args(run)
    run.add_argument("--plot", default=None, help="write combined-results figure")
    run.add_argument("--save", default=None, help="write solution (.npz/.h5/.vtk)")
    run.add_argument("--profile", default=None, help="write HDF5 profile")
    run.add_argument("--checkpoint-dir", default=None,
                     help="periodic checkpoints at chunk boundaries")
    run.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint in --checkpoint-dir")

    sweep = sub.add_parser("sweep", help="grid x Reynolds sweep (replaces the shell job farm)")
    _case_args(sweep, multi=True)
    sweep.add_argument("--out", default="results", help="output directory")
    sweep.add_argument("--vmap", action="store_true",
                       help="batch all Reynolds numbers of each grid size "
                            "(algorithms.batch.batched_cavity_solve: the cases in "
                            "one lockstep loop; a step is one batched K6 launch "
                            "where its gate admits the configuration, else one "
                            "vmapped step whose kernels launch once for every case "
                            "where algorithms.batch.vmap_step_ok admits it, as for "
                            "--scheme quick|luds|upwind, odd grids such as --nx 511, "
                            "--momentum jacobi|rbgs and --pressure direct|mgcg; "
                            "--f64 with the default solvers steps case by case, "
                            "since no kernel admits float64)")
    return p


def _case_args(p, multi=False):
    nargs = "+" if multi else None
    p.add_argument("--nx", type=int, nargs=nargs, default=[63] if multi else 63)
    p.add_argument("--re", "--reynolds", dest="re", type=float, nargs=nargs,
                   default=[100.0] if multi else 100.0)
    p.add_argument("--algorithm", choices=["simple", "simplec", "simpler", "piso"],
                   default="simple")
    p.add_argument("--pressure",
                   choices=["rbgs", "jacobi", "cg", "bicgstab", "gmres",
                            "mgcg", "multigrid", "direct"],
                   default="multigrid")
    p.add_argument("--momentum",
                   choices=["jacobi", "rbgs", "bicgstab", "gmres", "idrs"],
                   default="bicgstab")
    p.add_argument("--scheme", choices=["power_law", "quick", "luds", "upwind"],
                   default="power_law")
    p.add_argument("--alpha-p", type=float, default=0.3)
    p.add_argument("--alpha-u", type=float, default=0.7)
    p.add_argument("--tolerance", type=float, default=1e-5)
    p.add_argument("--max-iterations", type=int, default=5000)
    p.add_argument("--pressure-tol", type=float, default=1e-3)
    p.add_argument("--loop", default="auto",
                   help="auto | fused | host | chunked[:K]")
    p.add_argument("--sequence", action="store_true",
                   help="grid-sequenced solve (coarse-to-fine warm starts)")
    p.add_argument("--newton", action="store_true",
                   help="finish with the steady Newton-Krylov solver "
                        "(algorithms/newton.py) from wherever the "
                        "fixed-point iteration lands; converges unstable "
                        "steady branches (e.g. QUICK at Re>=7500) that "
                        "SIMPLE-family iterations limit-cycle on")
    p.add_argument("--f64", action="store_true",
                   help="run in float64 (on the card: composed, no kernel)")
    p.add_argument("--distributed", action="store_true",
                   help="spatial domain decomposition over the ranks of "
                        "torchrun (torch.distributed halo exchange; one rank "
                        "without torchrun; algorithm simple/simplec/piso, "
                        "pressure cg/chebcg/rbgs/mgcg/mg/fmg, momentum "
                        "jacobi/bicgstab)")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default, 'cpu' for the CPU")


def _device(args) -> torch.device:
    from .core.state import resolve_device

    return resolve_device(args.device, "naviflow_tpu_torch.cli", hint="pass --device cpu")


def _dtype(args):
    return torch.float64 if args.f64 else torch.float32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _make_solvers(args):
    from .solvers import (
        BiCGSTABPressureConfig,
        CGPressureConfig,
        DirectPressureConfig,
        GMRESMomentumConfig,
        GMRESPressureConfig,
        IDRSMomentumConfig,
        JacobiMomentumConfig,
        JacobiPressureConfig,
        KrylovMomentumConfig,
        MGCGPressureConfig,
        MultigridConfig,
        RBGSMomentumConfig,
        RBGSPressureConfig,
    )

    pres = {
        "rbgs": lambda: RBGSPressureConfig(tolerance=args.pressure_tol, max_iterations=50000),
        "jacobi": lambda: JacobiPressureConfig(tolerance=args.pressure_tol, max_iterations=50000),
        "cg": lambda: CGPressureConfig(tolerance=args.pressure_tol, max_iterations=5000),
        "bicgstab": lambda: BiCGSTABPressureConfig(tolerance=args.pressure_tol,
                                                   max_iterations=5000),
        "gmres": lambda: GMRESPressureConfig(tolerance=args.pressure_tol, max_iterations=5000),
        "mgcg": lambda: MGCGPressureConfig(tolerance=args.pressure_tol, max_iterations=100),
        "multigrid": lambda: MultigridConfig(tolerance=args.pressure_tol, max_cycles=30),
        "direct": lambda: DirectPressureConfig(),
    }[args.pressure]()
    mom = {
        "jacobi": lambda: JacobiMomentumConfig(n_sweeps=2, scheme=args.scheme),
        "rbgs": lambda: RBGSMomentumConfig(n_sweeps=2, scheme=args.scheme),
        "bicgstab": lambda: KrylovMomentumConfig(tolerance=1e-6, max_iterations=60,
                                                 scheme=args.scheme),
        "gmres": lambda: GMRESMomentumConfig(tolerance=1e-6, max_iterations=40,
                                             scheme=args.scheme),
        "idrs": lambda: IDRSMomentumConfig(tolerance=1e-6, scheme=args.scheme),
    }[args.momentum]()
    return mom, pres


# nearest distributed equivalents of the single-device pressure names
PRES_MAP = {"cg": "cg", "chebcg": "chebcg", "rbgs": "rbgs",
            "mgcg": "mgcg", "mg": "mg", "fmg": "fmg",
            "multigrid": "mg", "jacobi": "cg", "bicgstab": "cg",
            "gmres": "cg", "direct": "mgcg"}


def _distributed_config(args):
    """The :class:`DistributedConfig` the CLI maps its flags onto."""
    from .parallel.dist_simple import DistributedConfig

    if args.algorithm == "simpler":
        raise SystemExit("--distributed supports simple/simplec/piso")
    mom = "bicgstab" if args.momentum in ("bicgstab", "gmres", "idrs") else "jacobi"
    pres = PRES_MAP[args.pressure]
    return DistributedConfig(
        algorithm=args.algorithm, alpha_p=args.alpha_p, alpha_u=args.alpha_u,
        max_iterations=args.max_iterations, tolerance=args.tolerance,
        momentum_solver=mom, scheme=args.scheme,
        pressure_solver=pres,
        pressure_tol=max(args.pressure_tol, 1e-6),
        pressure_max_iter=100 if pres in ("mgcg", "mg", "fmg") else 2000,
    )


def _run_case_distributed(args, nx, re):
    """Spatial domain decomposition over the ranks of the process group
    (``parallel/dist_simple.py``): the CLI surface for the multi-card path.
    Under torchrun the group comes up from its environment
    (``initialize_pod``); alone, one rank with no group.  Non-divisible
    grids are padded and masked."""
    import numpy as np

    import naviflow_tpu_torch as nt
    from .parallel.dist_simple import distributed_simple_solve
    from .parallel.sharding import initialize_pod, make_device_mesh
    from .postprocessing.result import SimulationResult
    from .postprocessing.validation import infinity_norm_error

    cfg = _distributed_config(args)
    device = _device(args)
    dmesh = make_device_mesh(device=None if initialize_pod(device) else device)
    mesh = nt.StructuredMesh(nx=nx, ny=nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=re)
    bc = nt.lid_driven_cavity(1.0)
    state = nt.initialize_state(mesh, bc, dtype=_dtype(args), device=dmesh.device)
    t0 = time.perf_counter()
    final, diag = distributed_simple_solve(mesh, fluid, bc, state, dmesh, cfg)
    _sync(dmesh.device)
    wall = time.perf_counter() - t0
    err = float(infinity_norm_error(final.u, final.v, mesh, re))

    result = SimulationResult(
        final.u, final.v, final.p, mesh,
        iterations=int(diag["iterations"]),
        residuals=np.asarray(diag["residual_history"]),
        reynolds=re, converged=bool(diag["converged"]),
    )
    result.algorithm = args.algorithm.upper()
    summary = dict(
        nx=nx, reynolds=re, algorithm=args.algorithm, distributed=True,
        device_mesh=dmesh.named_shape, pressure=cfg.pressure_solver,
        momentum=cfg.momentum_solver, scheme=args.scheme,
        iterations=int(diag["iterations"]), converged=bool(diag["converged"]),
        final_residual=float(diag["final_residual"]),
        wall_seconds=round(wall, 3), infinity_norm_error=round(err, 5),
    )
    return result, summary


def _algorithm(args):
    """``(config class, solve function)`` of ``--algorithm``."""
    from .algorithms import (
        PISOConfig, SIMPLECConfig, SIMPLERConfig, SIMPLEConfig,
        piso_solve, simple_solve, simplec_solve, simpler_solve,
    )

    return {
        "simple": (SIMPLEConfig, simple_solve),
        "simplec": (SIMPLECConfig, simplec_solve),
        "simpler": (SIMPLERConfig, simpler_solve),
        "piso": (PISOConfig, piso_solve),
    }[args.algorithm]


def _run_case(args, nx, re):
    import naviflow_tpu_torch as nt
    from .postprocessing.result import result_from_solve

    if getattr(args, "distributed", False):
        return _run_case_distributed(args, nx, re)

    device, dtype = _device(args), _dtype(args)
    mesh = nt.StructuredMesh(nx=nx, ny=nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=re)
    bc = nt.lid_driven_cavity(1.0)
    state = nt.initialize_state(mesh, bc, dtype=dtype, device=device)
    it0 = 0
    if getattr(args, "resume", False) and getattr(args, "checkpoint_dir", None):
        from .io.checkpoint import CheckpointManager, load_checkpoint

        latest = CheckpointManager(args.checkpoint_dir).latest()
        if latest:
            state, it0, _, _ = load_checkpoint(latest, device=device)
            print(f"[resume] {latest} (iteration {it0})", file=sys.stderr)
    mom, pres = _make_solvers(args)
    cfg_cls, solve = _algorithm(args)
    # a resumed run continues the original iteration budget rather than
    # restarting it, and numbers its checkpoints after the loaded one
    cfg = cfg_cls(alpha_p=args.alpha_p, alpha_u=args.alpha_u,
                  max_iterations=max(1, args.max_iterations - it0),
                  tolerance=args.tolerance)

    on_chunk = None
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    if ckpt_dir:
        from .core.state import FlowState
        from .io.checkpoint import CheckpointManager

        if not args.loop.startswith("chunked"):
            # checkpointing needs chunk boundaries; host/fused/auto loops
            # have none, so rewrite them rather than abort mid-run
            print(f"[checkpoint] --loop {args.loop} -> chunked:200 "
                  "(checkpoints are taken at chunk boundaries)", file=sys.stderr)
            args.loop = "chunked:200"
        manager = CheckpointManager(ckpt_dir, every=1)

        def on_chunk(it, total, carry):
            manager.maybe_save(
                FlowState(u=carry["u"], v=carry["v"], p=carry["p"]), it0 + it,
                histories={"total": carry["hist_total"][:it]},
            )
            print(f"[checkpoint] iter {it0 + it}  residual {total:.3e}",
                  file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    if getattr(args, "sequence", False):
        from .algorithms import grid_sequence_solve

        final, diag, _ = grid_sequence_solve(
            mesh, fluid, bc, solve, cfg, momentum=mom, pressure=pres,
            loop=args.loop, dtype=dtype, device=device,
        )
    else:
        final, diag = solve(mesh, fluid, bc, state, cfg, momentum=mom,
                            pressure=pres, loop=args.loop, on_chunk=on_chunk)
    _sync(device)

    newton_info = {}
    if getattr(args, "newton", False) and not bool(diag.converged):
        from .algorithms import NewtonConfig, newton_solve

        final, ndiag = newton_solve(
            mesh, fluid, bc, final,
            NewtonConfig(tolerance=args.tolerance, scheme=args.scheme))
        _sync(device)
        newton_info = dict(
            newton_iterations=ndiag.iterations,
            newton_converged=bool(ndiag.converged),
            newton_final_residual=float(ndiag.final_residual),
            newton_gmres_iterations=ndiag.gmres_iterations,
        )
    wall = time.perf_counter() - t0

    result = result_from_solve(mesh, fluid, final, diag,
                               algorithm=args.algorithm.upper())
    if newton_info.get("newton_converged"):
        result.converged = True
    summary = dict(
        nx=nx, reynolds=re, algorithm=args.algorithm,
        pressure=args.pressure, momentum=args.momentum, scheme=args.scheme,
        iterations=result.iterations, converged=result.converged,
        final_residual=float(diag.final_residual),
        max_divergence=result.get_max_divergence(),
        wall_seconds=round(wall, 3),
        **newton_info,
    )
    summary.update(result.validate_against_benchmark())
    return result, summary


def _run_batched(args, nx, res):
    """All Reynolds numbers at this grid size through
    ``algorithms.batch.batched_cavity_solve`` (the cases in one lockstep
    loop, each its single solve's bits)."""
    import naviflow_tpu_torch as nt
    from .algorithms import batched_cavity_solve
    from .postprocessing.result import result_from_solve

    device = _device(args)
    mesh = nt.StructuredMesh(nx=nx, ny=nx)
    bc = nt.lid_driven_cavity(1.0)
    mom, pres = _make_solvers(args)
    cfg_cls, _ = _algorithm(args)
    cfg = cfg_cls(alpha_p=args.alpha_p, alpha_u=args.alpha_u,
                  max_iterations=args.max_iterations, tolerance=args.tolerance)
    t0 = time.perf_counter()
    results = batched_cavity_solve(
        mesh, res, bc, cfg, mom, pres, algorithm=args.algorithm,
        dtype=_dtype(args), device=device,
    )
    _sync(device)
    wall = time.perf_counter() - t0
    rows = []
    for re, (final, diag) in zip(res, results):
        fluid = nt.FluidProperties(density=1.0, reynolds_number=re)
        result = result_from_solve(mesh, fluid, final, diag,
                                   algorithm=args.algorithm.upper())
        summary = dict(
            nx=nx, reynolds=re, algorithm=args.algorithm,
            pressure=args.pressure, momentum=args.momentum, scheme=args.scheme,
            iterations=result.iterations, converged=result.converged,
            final_residual=float(diag.final_residual),
            max_divergence=result.get_max_divergence(),
            wall_seconds_batch=round(wall, 3), batched=len(res),
        )
        summary.update(result.validate_against_benchmark())
        rows.append(summary)
        print(json.dumps(summary), flush=True)
    return rows


def main(argv=None):
    args = _build_parser().parse_args(argv)

    if args.command == "run":
        result, summary = _run_case(args, args.nx, args.re)
        if _rank() != 0:
            return 0
        print(json.dumps(summary), flush=True)
        if args.plot:
            from .postprocessing.visualization import plot_combined_results_matrix

            plot_combined_results_matrix(result, filename=args.plot)
        if args.save:
            from .io import exporters

            if args.save.endswith(".vtk"):
                exporters.export_vtk(result, args.save)
            elif args.save.endswith((".h5", ".hdf5")):
                exporters.export_hdf5(result, args.save)
            else:
                exporters.export_npz(result, args.save)
        if args.profile:
            os.makedirs(os.path.dirname(args.profile) or ".", exist_ok=True)
            # the object API writes the full HDF5 profile; here the summary
            # JSON goes next to the requested path
            with open(args.profile + ".json", "w") as f:
                json.dump(summary, f, indent=2)
        return 0

    if args.command == "sweep":
        rows = []
        if args.vmap:
            for nx in args.nx:
                rows.extend(_run_batched(args, nx, args.re))
        else:
            for nx in args.nx:
                for re in args.re:
                    _, summary = _run_case(args, nx, re)
                    rows.append(summary)
                    if _rank() == 0:
                        print(json.dumps(summary), flush=True)
        if _rank() == 0:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "sweep_summary.json"), "w") as f:
                json.dump(rows, f, indent=2)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
