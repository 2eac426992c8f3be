"""SIMPLE pressure–velocity coupling (port of
``naviflow_tpu/algorithms/simple.py``).

One outer iteration:
1. u*, v* from the relaxed momentum systems, coefficients at the old
   (u, v, p*);
2. p' from the continuity defect of (u*, v*) with d_u, d_v;
3. ``p = p* + alpha_p p'``;
4. ``u = u* + d_u (p'_W - p'_P)`` etc., then velocity BCs;
5. convergence on ``max(u_norm, v_norm) <= tol``.

On a CUDA float32 state at >= 1024^2 with Chebyshev momentum and the
bench's fixed-cycle multigrid, a step launches K1 once, K2 (``strip_down``
and ``strip_up``) twice each and K3 once; everything else is composed
PyTorch.  The JAX package's whole-step kernel branch (``pallas_step``, K6)
is not ported: it needs BiCGSTAB momentum, which the port does not run yet
(ROADMAP §2 K6).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.bc import BoundaryConditions, enforce_pressure_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.poisson import poisson_coefficients, pressure_rhs
from ..solvers.dispatch import dispatch_pressure_solve
from ..solvers.momentum import (JacobiMomentumConfig, lagged_rho_enabled,
                                solve_momentum_pair)
from ..solvers.pressure import RBGSPressureConfig
from ..solvers.velocity import update_velocity
from .base import SolveDiagnostics, StepInfo, build_solver
from .lagged import make_lagged_mg, uses_lagged_mg


@dataclasses.dataclass(frozen=True)
class SIMPLEConfig:
    alpha_p: float = 0.3
    alpha_u: float = 0.7
    max_iterations: int = 1000
    tolerance: float = 1e-5
    poisson_variant: str = "consistent"
    overwrite_boundary_pressure: bool = False
    # 'auto': take d and the pressure-correction operator from the momentum
    # kernel where it runs; 'off' rebuilds them composed
    fold_poisson: str = "auto"


def make_simple_step(*, dx, dy, rho, mu, bc, cfg, mom_cfg, pres_cfg,
                     coarse_mode: str = "carry", lagged_rho: bool = False):
    """One SIMPLE outer iteration as a function (u, v, p, extra) -> ....

    ``lagged_rho``: the carry holds the momentum systems' Gershgorin ratio
    maxima and the merged kernel K1 runs (set from
    ``solvers.momentum.lagged_rho_enabled``).  ``extra`` is the pressure
    rel-norm running max; with a lagged-multigrid pressure config it also
    carries (age, coarse Stencil9 tuple).  ``coarse_mode``: 'carry' uses
    the carried coarse hierarchy, 'rebuild' rebuilds it from this
    iteration's d-coefficients (the refresh step)."""
    pin = cfg.poisson_variant == "reference"
    lagged = uses_lagged_mg(pres_cfg)
    if lagged:
        lg = make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant)

    def step(u, v, p, extra):
        rho_pair = None
        if lagged_rho:
            extra, rho_pair = extra
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        p_star = p
        fold = getattr(cfg, "fold_poisson", "auto") == "auto"
        res = solve_momentum_pair(
            u, v, p_star, dx=dx, dy=dy, rho=rho, mu=mu,
            alpha=cfg.alpha_u, bc=bc, cfg=mom_cfg,
            poisson_variant=(cfg.poisson_variant if fold else None),
            lagged_rho=rho_pair,
        ) + (() if fold else (None,))
        if lagged_rho:
            ((u_star, d_u, r_u, u_norm),
             (v_star, d_v, r_v, v_norm), pc, rho_pair_new) = res
        else:
            ((u_star, d_u, r_u, u_norm),
             (v_star, d_v, r_v, v_norm), pc) = res

        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        if pc is None:
            pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                      variant=cfg.poisson_variant)
        if lagged:
            coarse = lg.rebuild(d_u, d_v) if coarse_mode == "rebuild" else mg_extra[1]
            p_prime, pinfo = lg.solve(b, pc, d_u, d_v, p, coarse)
        else:
            p_prime, pinfo = dispatch_pressure_solve(
                b, pc, torch.zeros_like(p), pres_cfg,
                d_u=d_u, d_v=d_v, dx=dx, dy=dy, rho=rho,
                variant=cfg.poisson_variant, pin=pin,
            )

        p_new = p_star + cfg.alpha_p * p_prime
        if cfg.overwrite_boundary_pressure:
            p_new = enforce_pressure_bcs(p_new, bc)

        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)

        # pressure relative norm: interior L2 over its running maximum
        p_l2 = torch.linalg.vector_norm(pinfo.residual_field[1:-1, 1:-1])
        p_max_l2 = torch.maximum(p_max_l2, p_l2)
        p_rel = torch.where(p_max_l2 > 0, p_l2 / p_max_l2, torch.ones_like(p_l2))

        info = StepInfo(
            u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
            inner_iterations=pinfo.iterations,
            r_u=r_u, r_v=r_v, r_p=pinfo.residual_field,
        )
        extra_out = (p_max_l2, (mg_extra[0] + 1, coarse)) if lagged else p_max_l2
        if lagged_rho:
            extra_out = (extra_out, rho_pair_new)
        return u_new, v_new, p_new, extra_out, info

    return step


def _build_solve(mesh, fluid, bc, cfg, mom_cfg, pres_cfg, loop, use_rho: bool):
    """The solve function for one configuration.  ``use_rho`` is
    :func:`~naviflow_tpu_torch.solvers.momentum.lagged_rho_enabled` of the
    state the solve will run on."""
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    nx, ny = mesh.get_dimensions()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg, lagged_rho=use_rho)
    step = make_simple_step(**common)
    refresh_step, refresh_every = None, 0

    def scalar(v, dt, dev):
        return torch.full((), v, dtype=dt, device=dev)

    if uses_lagged_mg(pres_cfg):
        mg_extra0 = make_lagged_mg(
            pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant).extra0

        def extra0_fn(dt, dev):
            return (scalar(0.0, dt, dev), mg_extra0(dt, nx, ny, dev))

        refresh_step = make_simple_step(**common, coarse_mode="rebuild")
        refresh_every = pres_cfg.coarse_rebuild_every
    else:
        def extra0_fn(dt, dev):
            return scalar(0.0, dt, dev)

    if use_rho:
        # first-iteration bounds: the conservative clamp ceiling rho = 0.999
        base_extra0 = extra0_fn

        def extra0_fn(dt, dev):
            return (base_extra0(dt, dev), (scalar(0.999, dt, dev), scalar(0.999, dt, dev)))

    return build_solver(
        step, max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        dx=dx, dy=dy, extra0_fn=extra0_fn, loop=loop,
        refresh_step=refresh_step, refresh_every=refresh_every,
    )


def simple_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: SIMPLEConfig = SIMPLEConfig(),
    momentum: object = JacobiMomentumConfig(),
    pressure: object = RBGSPressureConfig(),
    loop: str = "auto",
    on_chunk=None,
) -> Tuple[FlowState, SolveDiagnostics]:
    """Run SIMPLE to convergence (or ``max_iterations``) on the device of
    ``state``; the caller's tensors are never modified."""
    nx, ny = mesh.get_dimensions()
    use_rho = lagged_rho_enabled(
        nx, ny, momentum, fold_poisson=getattr(cfg, "fold_poisson", "auto") == "auto",
        dtype=state.u.dtype, device=state.u.device)
    fn = _build_solve(mesh, fluid, bc, cfg, momentum, pressure, loop, use_rho)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
