"""Case batching: one cavity grid solved for a list of Reynolds numbers
(port of ``naviflow_tpu/algorithms/batch.py``).

The JAX package runs the cases as one ``jax.vmap`` over its
``lax.while_loop``: one program, each case frozen at its own iteration
count.  PyTorch has no counterpart that keeps the kernels:
``torch.func.vmap`` does not batch through the port's ``ctypes`` launches,
nor through the host loops whose conditions read each case's residual.
So the port runs each case's single-device solve in turn, on the device
of ``device``: each case launches the kernels its own solve launches, and
its result is that solve's, bit for bit.  Running the cases on concurrent
streams is later work.  Viscosity is the one per-case scalar (cavity Re =
rho U L / mu with U = L = 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.bc import BoundaryConditions
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state
from .base import SolveDiagnostics
from .piso import piso_solve
from .simple import simple_solve
from .simplec import simplec_solve
from .simpler import simpler_solve

_SOLVES = {
    "simple": simple_solve,
    "simplec": simplec_solve,
    "simpler": simpler_solve,
    "piso": piso_solve,
}


def batched_cavity_solve(
    mesh: StructuredMesh,
    reynolds: Sequence[float],
    bc: BoundaryConditions,
    cfg,
    momentum,
    pressure,
    *,
    algorithm: str = "simple",
    rho: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> List[Tuple[FlowState, SolveDiagnostics]]:
    """Solve one cavity grid for each Reynolds number, each case from rest
    with the fused loop.  Returns per-case ``(state, diagnostics)``."""
    if algorithm not in _SOLVES:
        raise ValueError(f"Unknown algorithm: {algorithm}")
    solve = _SOLVES[algorithm]
    out = []
    for re in reynolds:
        fluid = FluidProperties(density=rho, reynolds_number=re)
        state = initialize_state(mesh, bc, dtype=dtype, device=device)
        out.append(solve(mesh, fluid, bc, state, cfg, momentum=momentum, pressure=pressure,
                         loop="fused"))
    return out
