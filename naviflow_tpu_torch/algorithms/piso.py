"""PISO, pressure-implicit with splitting of operators (port of
``naviflow_tpu/algorithms/piso.py``).

One relaxed momentum prediction, then ``n_corrections`` pressure-correction
passes; between corrections the momentum equations are re-solved
unrelaxed (alpha = 1) with the updated pressure.  The correction loop is
unrolled over the configured count.

Kernel paths on a CUDA float32 state: the whole-step kernel K6 with its
``piso`` body (one launch per outer step) where its gate admits the
configuration; on large grids every momentum pair, predictor and
corrector, goes through K8, and Chebyshev solves through K9.
"""

from __future__ import annotations

import dataclasses
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
class PISOConfig(SIMPLEConfig):
    n_corrections: int = 2
    # The re-solve between corrections is unrelaxed.  'jacobi' (default):
    # ``corrector_sweeps`` fixed Jacobi sweeps, a gentle approximate update
    # (an exact unrelaxed re-solve destabilises these steady solves: at 31^2
    # Re=100 it diverges within ~26 outer iterations in the JAX package's
    # tests); 'exact': the reference's literal scheme, the configured
    # momentum solver at alpha = 1.
    corrector: str = "jacobi"
    corrector_sweeps: int = 1


def make_piso_step(*, dx, dy, rho, mu, bc, cfg: PISOConfig, mom_cfg, pres_cfg,
                   coarse_mode: str = "carry"):
    """One PISO outer iteration ``(u, v, p, extra) -> (u, v, p, extra,
    StepInfo)``; ``extra`` is the pressure rel-norm running max plus the
    lagged multigrid carry where the pressure config has one."""
    lagged = uses_lagged_mg(pres_cfg)
    lg = (make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant)
          if lagged else None)
    pressure_correct = make_pressure_solve(dx=dx, dy=dy, rho=rho, cfg=cfg, pres_cfg=pres_cfg,
                                            lg=lg)
    corrector_cfg = (mom_cfg if cfg.corrector == "exact"
                     else JacobiMomentumConfig(n_sweeps=cfg.corrector_sweeps))

    def solve_momentum(u, v, p, alpha, solver_cfg):
        ((u_star, d_u, r_u, u_norm), (v_star, d_v, r_v, v_norm)) = solve_momentum_pair(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha, bc=bc, cfg=solver_cfg)
        return u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm

    def step(u, v, p, extra):
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        if fused_step_ok(p, cfg, mom_cfg, pres_cfg, "piso"):
            (u_new, v_new, p_new, (p_max_new, u_norm, v_norm, p_rel),
             cycles, r_u, r_v, r_p) = fused_outer_step(
                "piso", u, v, p, (p_max_l2,), dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
                cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
            info = StepInfo(u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
                            inner_iterations=cycles, r_u=r_u, r_v=r_v, r_p=r_p)
            extra_out = (p_max_new, (mg_extra[0] + 1, mg_extra[1])) if lagged else p_max_new
            return u_new, v_new, p_new, extra_out, info

        # predictor (relaxed)
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = solve_momentum(
            u, v, p, cfg.alpha_u, mom_cfg)
        # one coarse hierarchy per outer iteration, shared by every correction
        coarse = ((lg.rebuild(d_u, d_v) if coarse_mode == "rebuild" else mg_extra[1])
                  if lagged else None)
        inner_total = 0
        for k in range(cfg.n_corrections):
            p_prime, pinfo = pressure_correct(u_star, v_star, d_u, d_v, p, coarse)
            inner_total = inner_total + pinfo.iterations
            p_l2 = torch.linalg.vector_norm(pinfo.residual_field[1:-1, 1:-1])
            p = p + cfg.alpha_p * p_prime
            if cfg.overwrite_boundary_pressure:
                p = enforce_pressure_bcs(p, bc)
            u, v = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)
            u_star, v_star = u, v
            if k < cfg.n_corrections - 1:
                # unrelaxed momentum re-solve with the updated pressure
                u_star, v_star, d_u, d_v, _, _, _, _ = solve_momentum(u, v, p, 1.0,
                                                                      corrector_cfg)
        p_max_l2 = torch.maximum(p_max_l2, p_l2)
        p_rel = torch.where(p_max_l2 > 0, p_l2 / p_max_l2, torch.ones_like(p_l2))
        info = StepInfo(u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
                        inner_iterations=inner_total, r_u=r_u, r_v=r_v,
                        r_p=pinfo.residual_field)
        extra_out = (p_max_l2, (mg_extra[0] + 1, coarse)) if lagged else p_max_l2
        return u, v, p, extra_out, info

    return step


def piso_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: PISOConfig = PISOConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    """Run PISO to convergence (or ``max_iterations``) on the device of
    ``state``; the caller's tensors are never modified."""
    fn = build_family_solve(make_piso_step, zero_carry, mesh, fluid, bc, cfg, momentum, pressure,
                            loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
