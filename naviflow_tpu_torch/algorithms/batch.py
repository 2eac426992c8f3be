"""Case batching: one cavity grid solved for a list of Reynolds numbers
(port of ``naviflow_tpu/algorithms/batch.py``).

The JAX package runs the cases as one ``jax.vmap`` over its
``lax.while_loop``: one program, all cases in lockstep, each case's carry
masked by its own predicate, so each case freezes at its own iteration
count and device time is set by the slowest case.  The port runs that
loop written out (``base.run_outer_loop_batched``): a leading case axis on
the state, the residuals and the histories, and one host read a step of
whether any case is still active.  Where the whole-step kernel's gate
admits the configuration, each lockstep step is one launch of K6's batched
entry (``ops/step.fused_outer_step_batched``: one thread-block cluster a
case, frozen cases leaving at once).  Otherwise each lockstep step runs
every active case's own step (composed, or with its own kernels): the CPU
path, and the configurations whose kernels have no case axis.  Either way
each case's result is its single solve's, bit for bit.  Viscosity is the
one per-case scalar (cavity Re = rho U L / mu with U = L = 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.bc import BoundaryConditions
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state
from ..ops.step import ALGO_SCALARS, fused_outer_step_batched
from .base import SolveDiagnostics, StepInfo, case_info, run_outer_loop_batched
from .lagged import make_lagged_mg, uses_lagged_mg
from .piso import make_piso_step
from .simple import family_parts, fused_step_ok, simple_parts, zero_carry
from .simplec import make_simplec_step, simplec_carry0
from .simpler import make_simpler_step

# algorithm -> (its step factory, cfg -> its initial scalar carry); SIMPLE
# builds its own parts (the lagged Gershgorin carry)
_FAMILY = {
    "simple": (None, lambda cfg: zero_carry),
    "simplec": (make_simplec_step, simplec_carry0),
    "simpler": (make_simpler_step, lambda cfg: zero_carry),
    "piso": (make_piso_step, lambda cfg: zero_carry),
}


def _per_case(steps):
    """The lockstep step of cases that each take their own step function
    ``steps[b](u, v, p, extra) -> (u, v, p, extra, StepInfo)``: the active
    cases step, the frozen ones hand back what they were given; ``extra``
    is the list of the cases' carries."""

    def step(u, v, p, extra, active, info):
        outs = [steps[b](u[b], v[b], p[b], extra[b]) if on
                else (u[b], v[b], p[b], extra[b], case_info(info, b))
                for b, on in enumerate(active.tolist())]
        us, vs, ps, extras, infos = zip(*outs)
        dt, dev = u.dtype, u.device

        def stack(xs, dtype=None):
            return torch.stack([torch.as_tensor(x, dtype=dtype, device=dev) for x in xs])

        un, vn, pn, inner, ru, rv, rp = zip(*infos)
        return (torch.stack(us), torch.stack(vs), torch.stack(ps), list(extras),
                StepInfo(stack(un, dt), stack(vn, dt), stack(pn, dt), stack(inner, torch.int32),
                         stack(ru), stack(rv), stack(rp)))

    return step


def _fused_step(algorithm, mus, kw):
    """The lockstep step as one launch of K6's batched entry; ``extra`` is
    the last step's scalar results (B, n_out), whose first n_in are the
    carries, and the lagged carry, which K6 passes through."""
    n_in = ALGO_SCALARS[algorithm][0]

    def step(u, v, p, extra, active, info):
        sc, lag = extra
        u2, v2, p2, sc2, cycles, r_u, r_v, r_p = fused_outer_step_batched(
            algorithm, u, v, p, sc[:, :n_in], active, mu=mus,
            held=(sc, info.inner_iterations, info.r_u, info.r_v, info.r_p), **kw)
        info2 = StepInfo(u_norm=sc2[:, n_in], v_norm=sc2[:, n_in + 1], p_norm=sc2[:, n_in + 2],
                         inner_iterations=cycles, r_u=r_u, r_v=r_v, r_p=r_p)
        return u2, v2, p2, (sc2, lag), info2

    return step


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
    """Solve one cavity grid for each Reynolds number, every case from rest,
    in one lockstep loop on ``device`` (the fused loop's semantics per
    case).  Returns per-case ``(state, diagnostics)``."""
    if algorithm not in _FAMILY:
        raise ValueError(f"Unknown algorithm: {algorithm}")
    make_step, carry0 = _FAMILY[algorithm]
    fluids = [FluidProperties(density=rho, reynolds_number=re) for re in reynolds]
    state = initialize_state(mesh, bc, dtype=dtype, device=device)
    dev, cases = state.u.device, len(fluids)
    dx, dy = mesh.get_cell_sizes()
    u0, v0, p0 = (torch.stack([x] * cases) for x in (state.u, state.v, state.p))
    refresh, every = None, 0
    if fused_step_ok(state.p, cfg, momentum, pressure, algorithm):
        carry = carry0(cfg)(dtype, dev)
        carry = carry if isinstance(carry, tuple) else (carry,)
        inf = torch.full((), float("inf"), dtype=dtype, device=dev)
        # the results a case frozen before its first step would hold: the
        # loop's initial norms
        sc0 = torch.stack([*carry, inf, inf, torch.zeros_like(inf)]).repeat(cases, 1)
        lag = None
        if uses_lagged_mg(pressure):  # the setup hierarchy: d = dy / dx, no mu; built once
            nx, ny = mesh.get_dimensions()
            lag = make_lagged_mg(pressure, dx=dx, dy=dy, rho=rho,
                                 variant=cfg.poisson_variant).extra0(dtype, nx, ny, dev)
        # every step is the same launch (K6 rebuilds the coarse operators
        # each step), so there is no refresh step
        step = _fused_step(algorithm, [f.get_viscosity() for f in fluids],
                           dict(dx=dx, dy=dy, rho=rho, bc=bc, cfg=cfg, mom_cfg=momentum,
                                pres_cfg=pressure))
        extra0 = (sc0, lag)
    else:
        args = (bc, cfg, momentum, pressure)
        parts = [simple_parts(mesh, f, *args, dtype=dtype, device=dev) if make_step is None
                 else family_parts(make_step, carry0(cfg), mesh, f, *args) for f in fluids]
        # the cases' initial carries are equal (the lagged hierarchy has no
        # mu): built once
        extra0 = [parts[0]["extra0_fn"](dtype, dev)] * cases
        step = _per_case([pt["step"] for pt in parts])
        if parts[0]["refresh_step"] is not None:
            refresh = _per_case([pt["refresh_step"] for pt in parts])
            every = parts[0]["refresh_every"]
    return run_outer_loop_batched(step, u0, v0, p0, extra0, max_iterations=cfg.max_iterations,
                                  tolerance=cfg.tolerance, dx=dx, dy=dy, refresh_step=refresh,
                                  refresh_every=every)
