"""SIMPLER, SIMPLE-Revised (port of ``naviflow_tpu/algorithms/simpler.py``).

Per outer iteration:

1. momentum prediction with the current p (relaxed);
2. the intermediate pressure p_bar from the starred field; ``p += p_bar``;
3. the momentum re-solve with the updated p (relaxed);
4. the correction pressure p' from the new starred field;
5. ``p += alpha_p p'`` and the velocity correction with p'.

Convergence is on ``max(u_rel, v_rel)`` of step 1's unrelaxed momentum
residuals; the pressure residual is ``||p - p_old|| / sqrt(n_cells)``.

Kernel paths on a CUDA float32 state: the whole-step kernel K6 with its
``simpler`` body (one launch per outer step) where its gate admits the
configuration; on large grids both momentum pairs go through K8, and
Chebyshev solves through K9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core.bc import BoundaryConditions, enforce_pressure_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.step import fused_outer_step
from ..solvers.momentum import JacobiMomentumConfig, solve_momentum_pair
from ..solvers.pressure import RBGSPressureConfig
from ..solvers.velocity import update_velocity
from .base import SolveDiagnostics, StepInfo
from .lagged import make_lagged_mg, uses_lagged_mg
from .simple import (SIMPLEConfig, build_family_solve, fused_step_ok, make_pressure_solve,
                     zero_carry)


@dataclasses.dataclass(frozen=True)
class SIMPLERConfig(SIMPLEConfig):
    pass


def make_simpler_step(*, dx, dy, rho, mu, bc, cfg: SIMPLERConfig, mom_cfg, pres_cfg,
                      coarse_mode: str = "carry"):
    """One SIMPLER outer iteration ``(u, v, p, extra) -> (u, v, p, extra,
    StepInfo)``; ``extra`` is the (unused) pressure rel-norm maximum plus
    the lagged multigrid carry where the pressure config has one."""
    lagged = uses_lagged_mg(pres_cfg)
    lg = (make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant)
          if lagged else None)
    pressure_solve = make_pressure_solve(dx=dx, dy=dy, rho=rho, cfg=cfg, pres_cfg=pres_cfg,
                                          lg=lg)

    def solve_momentum(u, v, p):
        ((u_star, d_u, r_u, u_norm), (v_star, d_v, r_v, v_norm)) = solve_momentum_pair(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=cfg.alpha_u, bc=bc, cfg=mom_cfg)
        return u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm

    def step(u, v, p, extra):
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        if fused_step_ok(p, cfg, mom_cfg, pres_cfg, "simpler"):
            (u_new, v_new, p_new, (p_max_new, u_norm, v_norm, p_rel),
             cycles, r_u, r_v, r_p) = fused_outer_step(
                "simpler", u, v, p, (p_max_l2,), dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
                cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
            info = StepInfo(u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
                            inner_iterations=cycles, r_u=r_u, r_v=r_v, r_p=r_p)
            extra_out = (p_max_new, (mg_extra[0] + 1, mg_extra[1])) if lagged else p_max_new
            return u_new, v_new, p_new, extra_out, info

        p_old = p
        # 1. momentum prediction (old p)
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = solve_momentum(u, v, p)
        # one coarse hierarchy per outer iteration, shared by both pressure
        # solves (the fine operator is always current)
        coarse = ((lg.rebuild(d_u, d_v) if coarse_mode == "rebuild" else mg_extra[1])
                  if lagged else None)
        # 2. intermediate pressure p_bar
        p_bar, info1 = pressure_solve(u_star, v_star, d_u, d_v, p, coarse)
        p = p + p_bar
        if cfg.overwrite_boundary_pressure:
            p = enforce_pressure_bcs(p, bc)
        # 3. momentum with the p_bar-updated pressure
        u_star, v_star, d_u, d_v, _, _, _, _ = solve_momentum(u, v, p)
        # 4. correction pressure p'
        p_prime, info2 = pressure_solve(u_star, v_star, d_u, d_v, p, coarse)
        # 5. final pressure and velocity
        p = p + cfg.alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p = enforce_pressure_bcs(p, bc)
        u, v = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)

        p_rel = torch.linalg.vector_norm(p - p_old) / (math.sqrt(p.numel()) + 1e-30)
        info = StepInfo(u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
                        inner_iterations=info1.iterations + info2.iterations,
                        r_u=r_u, r_v=r_v, r_p=info2.residual_field)
        extra_out = (p_max_l2, (mg_extra[0] + 1, coarse)) if lagged else p_max_l2
        return u, v, p, extra_out, info

    return step


def simpler_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLERConfig = SIMPLERConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    """Run SIMPLER to convergence (or ``max_iterations``) on the device of
    ``state``; the caller's tensors are never modified."""
    fn = build_family_solve(make_simpler_step, zero_carry, mesh, fluid, bc, cfg, momentum, pressure,
                            loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
