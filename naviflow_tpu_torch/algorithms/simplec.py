"""SIMPLEC, SIMPLE-Consistent (port of ``naviflow_tpu/algorithms/simplec.py``).

Deltas from SIMPLE, all kept from the reference:

* the d-coefficient modification ``d / (1 - (1 - alpha_u)) = d / alpha_u``
  in the pressure equation and the velocity correction;
* optional pressure-correction smoothing with the 0.6/0.1 five-point stencil
  (``smooth_p_prime``, off by default: under the consistent operator it
  breaks the continuity annihilation and the outer loop diverges);
* the dynamic alpha_p backoff: ×0.95 whenever the residual increased, so
  alpha_p is a carried value;
* residuals are max-abs field changes (``max|u - u_old|``), not algebraic
  norms.

Kernel paths on a CUDA float32 state: the whole-step kernel K6 with its
``simplec`` body (one launch per outer step) where its gate admits the
configuration; on large grids the momentum pair goes through K8 and, with
Chebyshev momentum, K9 (never K1: the pair is solved without the lagged
Gershgorin carry, as in the JAX package).
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
from .simple import SIMPLEConfig, build_family_solve, fused_step_ok, make_pressure_solve


@dataclasses.dataclass(frozen=True)
class SIMPLECConfig(SIMPLEConfig):
    alpha_p: float = 0.2  # the reference SimplecSolver's default
    smooth_p_prime: bool = False
    dynamic_alpha_p: bool = True


def _smooth_p_prime(p_prime):
    """0.6 centre / 0.1 neighbours smoothing, zeroing the boundary ring."""
    sm = torch.zeros_like(p_prime)
    sm[1:-1, 1:-1] = (0.6 * p_prime[1:-1, 1:-1]
                      + 0.1 * (p_prime[2:, 1:-1] + p_prime[:-2, 1:-1]
                               + p_prime[1:-1, 2:] + p_prime[1:-1, :-2]))
    return sm


def make_simplec_step(*, dx, dy, rho, mu, bc, cfg: SIMPLECConfig, mom_cfg, pres_cfg,
                      coarse_mode: str = "carry"):
    """One SIMPLEC outer iteration ``(u, v, p, extra) -> (u, v, p, extra,
    StepInfo)``; ``extra`` is ``(alpha_p, prev_total)`` plus the lagged
    multigrid carry ``(age, coarse)`` where the pressure config has one."""
    lagged = uses_lagged_mg(pres_cfg)
    lg = (make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant)
          if lagged else None)
    pressure_solve = make_pressure_solve(dx=dx, dy=dy, rho=rho, cfg=cfg, pres_cfg=pres_cfg,
                                         lg=lg)

    def step(u, v, p, extra):
        if lagged:
            alpha_p, prev_res, mg_extra = extra
        else:
            alpha_p, prev_res = extra

        if fused_step_ok(p, cfg, mom_cfg, pres_cfg, "simplec"):
            (u_new, v_new, p_new, (alpha_p_n, total, u_res, v_res, p_res),
             cycles, r_u, r_v, r_p) = fused_outer_step(
                "simplec", u, v, p, (alpha_p, prev_res), dx=dx, dy=dy, rho=rho, mu=mu,
                bc=bc, cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
            info = StepInfo(u_norm=u_res, v_norm=v_res, p_norm=p_res, inner_iterations=cycles,
                            r_u=r_u, r_v=r_v, r_p=r_p)
            # the lagged carry passes through: K6 rebuilds the coarse
            # hierarchy every step
            extra_out = ((alpha_p_n, total, (mg_extra[0] + 1, mg_extra[1])) if lagged
                         else (alpha_p_n, total))
            return u_new, v_new, p_new, extra_out, info

        ((u_star, d_u, r_u, _), (v_star, d_v, r_v, _)) = solve_momentum_pair(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=cfg.alpha_u, bc=bc, cfg=mom_cfg)
        d_u_c = d_u / cfg.alpha_u
        d_v_c = d_v / cfg.alpha_u

        coarse = None
        if lagged:
            coarse = lg.rebuild(d_u_c, d_v_c) if coarse_mode == "rebuild" else mg_extra[1]
        p_prime, pinfo = pressure_solve(u_star, v_star, d_u_c, d_v_c, p, coarse)
        if cfg.smooth_p_prime:
            p_prime = _smooth_p_prime(p_prime)

        p_new = p + alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p_new = enforce_pressure_bcs(p_new, bc)
        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u_c, d_v_c, bc)

        u_res = torch.max(torch.abs(u_new - u))
        v_res = torch.max(torch.abs(v_new - v))
        p_res = torch.max(torch.abs(p_new - p))
        total = torch.maximum(u_res, v_res)
        if cfg.dynamic_alpha_p:
            alpha_p = torch.where(total > prev_res, alpha_p * 0.95, alpha_p)

        info = StepInfo(u_norm=u_res, v_norm=v_res, p_norm=p_res,
                        inner_iterations=pinfo.iterations, r_u=r_u, r_v=r_v,
                        r_p=pinfo.residual_field)
        extra_out = ((alpha_p, total, (mg_extra[0] + 1, coarse)) if lagged
                     else (alpha_p, total))
        return u_new, v_new, p_new, extra_out, info

    return step


def simplec_carry0(cfg):
    """SIMPLEC's initial scalar carry ``(dtype, device) -> (alpha_p, the
    previous step's residual: none yet)``."""
    def carry0(dt, dev):
        return (torch.full((), cfg.alpha_p, dtype=dt, device=dev),
                torch.full((), float("inf"), dtype=dt, device=dev))

    return carry0


def simplec_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLECConfig = SIMPLECConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    """Run SIMPLEC to convergence (or ``max_iterations``) on the device of
    ``state``; the caller's tensors are never modified."""
    fn = build_family_solve(make_simplec_step, simplec_carry0(cfg), mesh, fluid, bc, cfg,
                            momentum, pressure, loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
