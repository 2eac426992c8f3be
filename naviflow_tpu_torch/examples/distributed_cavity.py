"""Spatially decomposed cavity over a mesh of ranks (new capability: the
reference is single-process only).

One process per rank, each holding one block of the fields, the halos
exchanged by ``torch.distributed`` (NCCL between cards)::

    torchrun --nproc_per_node 4 -m naviflow_tpu_torch.examples.distributed_cavity

Alone it runs one rank with no process group (``--device cpu`` for the
CPU).  Rank 0 prints.
"""

import time

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.examples._common import parse
from naviflow_tpu_torch.parallel.dist_simple import (
    DistributedConfig,
    distributed_simple_solve,
)
from naviflow_tpu_torch.parallel.sharding import initialize_pod, make_device_mesh
from naviflow_tpu_torch.postprocessing.validation import validate_against_benchmark


def run(args):
    """``{'state', 'diag', 'mesh_shape', 'validation'}`` of this rank (the
    gathered global state on every rank)."""
    dmesh = make_device_mesh(device=None if initialize_pod(args.device) else args.device)
    say = print if dmesh.rank == 0 else (lambda *a, **k: None)
    say(f"ranks: {dmesh.size}, mesh {dmesh.named_shape}")

    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    bc = nt.lid_driven_cavity(1.0)
    state = nt.initialize_state(mesh, bc, device=dmesh.device)

    t0 = time.time()
    final, diag = distributed_simple_solve(
        mesh, fluid, bc, state, dmesh,
        DistributedConfig(max_iterations=args.max_iterations,
                          tolerance=args.tolerance,
                          alpha_p=args.alpha_p, alpha_u=args.alpha_u),
    )
    say(f"iters={diag['iterations']} converged={diag['converged']} "
        f"residual={diag['final_residual']:.2e} wall={time.time() - t0:.1f}s")
    validation = validate_against_benchmark(final.u, final.v, mesh, args.re)
    say(validation)
    return dict(state=final, diag=diag, mesh_shape=dmesh.named_shape, validation=validation)


def main(argv=None):
    run(parse(default_nx=64, default_re=100, default_tol=1e-4, argv=argv))


if __name__ == "__main__":
    main()
