"""SIMPLE pressure–velocity coupling (port of
``naviflow_tpu/algorithms/simple.py``).

One outer iteration:
1. u*, v* from the relaxed momentum systems, coefficients at the old
   (u, v, p*);
2. p' from the continuity defect of (u*, v*) with d_u, d_v;
3. ``p = p* + alpha_p p'``;
4. ``u = u* + d_u (p'_W - p'_P)`` etc., then velocity BCs;
5. convergence on ``max(u_norm, v_norm) <= tol``.

Kernel paths on a CUDA float32 state:
* the 63^2 headline (odd grid, BiCGSTAB momentum, multigrid V-cycles): one
  step is one launch of the whole-step kernel K6 (``ops/step.py``) wherever
  its gate admits the configuration; the lagged coarse carry passes through
  untouched (K6 rebuilds the coarse operators every step);
* >= 1024^2 with Chebyshev momentum and the bench's fixed-cycle multigrid:
  a step launches K1 once, K2 (``strip_down`` and ``strip_up``) twice each
  and K3 once; everything else is composed PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.bc import BoundaryConditions, enforce_pressure_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops import _cuda
from ..ops.poisson import poisson_coefficients, pressure_rhs
from ..ops.step import fused_simple_step, supports_fused_step
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


def fused_step_ok(p, cfg, mom_cfg, pres_cfg, algo: str) -> bool:
    """The whole-step kernel's gate (K6) for ``algo``: a CUDA state, the
    kernel backend, and the reference's admission rule."""
    return (_cuda.kernel_device(p)
            and getattr(pres_cfg, "backend", "auto") in ("auto", "kernel")
            and supports_fused_step(p.shape[0], p.shape[1], cfg, mom_cfg, pres_cfg, p.dtype,
                                    algo=algo))


def zero_carry(dt, dev):
    """A 0-d zero of the state's dtype and device: the initial scalar carry
    (the pressure residual's running maximum)."""
    return torch.zeros((), dtype=dt, device=dev)


def lagged_extra0(mesh, pres_cfg, cfg, dx, dy, rho, base0):
    """The initial carry of a SIMPLE-family solve: ``base0(dtype, device)``
    (a scalar or a tuple of them), followed by the lagged multigrid carry
    ``(age, coarse)`` where the pressure config has one.  Returns
    ``(extra0_fn, refresh_every)``; ``refresh_every`` is 0 without the
    carry (no refresh step)."""
    if not uses_lagged_mg(pres_cfg):
        return base0, 0
    nx, ny = mesh.get_dimensions()
    mg_extra0 = make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho,
                               variant=cfg.poisson_variant).extra0

    def extra0_fn(dt, dev):
        b = base0(dt, dev)
        return (*b, mg_extra0(dt, nx, ny, dev)) if isinstance(b, tuple) else (
            b, mg_extra0(dt, nx, ny, dev))

    return extra0_fn, pres_cfg.coarse_rebuild_every


def make_pressure_solve(*, dx, dy, rho, cfg, pres_cfg, lg):
    """The pressure solve of a SIMPLE-family step: ``(u*, v*, d_u, d_v, p,
    coarse, pc=None) -> (p', PressureSolveInfo)``.  The continuity RHS of
    (u*, v*), the operator from d unless ``pc`` is given, then the lagged
    multigrid solve on ``coarse`` (``lg``, where the pressure config has the
    carry) or the dispatched solve from zeros."""
    pin = cfg.poisson_variant == "reference"

    def solve(u_star, v_star, d_u, d_v, p, coarse, pc=None):
        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        if pc is None:
            pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                      variant=cfg.poisson_variant)
        if lg is not None:
            return lg.solve(b, pc, d_u, d_v, p, coarse)
        return dispatch_pressure_solve(b, pc, torch.zeros_like(p), pres_cfg, d_u=d_u, d_v=d_v,
                                       dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant,
                                       pin=pin)

    return solve


def family_parts(make_step, base0, mesh, fluid, bc, cfg, mom_cfg, pres_cfg):
    """What a SIMPLE-family solve builds its loop from (``build_solver``'s
    arguments but the loop mode), from the algorithm's step factory
    ``make_step`` and its initial scalar carry ``base0(dtype, device)``,
    with the lagged multigrid carry and its refresh step where the pressure
    config has one."""
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg, mom_cfg=mom_cfg,
                  pres_cfg=pres_cfg)
    extra0_fn, refresh_every = lagged_extra0(mesh, pres_cfg, cfg, dx, dy, rho, base0)
    return dict(
        step=make_step(**common), max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        dx=dx, dy=dy, extra0_fn=extra0_fn,
        refresh_step=make_step(**common, coarse_mode="rebuild") if refresh_every else None,
        refresh_every=refresh_every)


def build_family_solve(make_step, base0, mesh, fluid, bc, cfg, mom_cfg, pres_cfg, loop):
    """The solve function of a SIMPLE-family algorithm (:func:`family_parts`
    under the loop mode ``loop``)."""
    return build_solver(**family_parts(make_step, base0, mesh, fluid, bc, cfg, mom_cfg,
                                       pres_cfg), loop=loop)


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
    lagged = uses_lagged_mg(pres_cfg)
    lg = (make_lagged_mg(pres_cfg, dx=dx, dy=dy, rho=rho, variant=cfg.poisson_variant)
          if lagged else None)
    pressure_solve = make_pressure_solve(dx=dx, dy=dy, rho=rho, cfg=cfg, pres_cfg=pres_cfg,
                                         lg=lg)

    def step(u, v, p, extra):
        rho_pair = None
        if lagged_rho:
            extra, rho_pair = extra
        if lagged:
            p_max_l2, mg_extra = extra
        else:
            p_max_l2 = extra

        if fused_step_ok(p, cfg, mom_cfg, pres_cfg, "simple"):
            (u_new, v_new, p_new, p_max_new, u_norm, v_norm, p_rel,
             cycles, r_u, r_v, r_p) = fused_simple_step(
                u, v, p, p_max_l2, dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
                simple_cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
            info = StepInfo(u_norm=u_norm, v_norm=v_norm, p_norm=p_rel,
                            inner_iterations=cycles, r_u=r_u, r_v=r_v, r_p=r_p)
            # the lagged carry passes through untouched: K6 rebuilds the
            # coarse hierarchy every step
            extra_out = (p_max_new, (mg_extra[0] + 1, mg_extra[1])) if lagged else p_max_new
            if lagged_rho:  # the K1 and K6 gates are disjoint (momentum kinds)
                extra_out = (extra_out, rho_pair)
            return u_new, v_new, p_new, extra_out, info

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

        coarse = None
        if lagged:
            coarse = lg.rebuild(d_u, d_v) if coarse_mode == "rebuild" else mg_extra[1]
        p_prime, pinfo = pressure_solve(u_star, v_star, d_u, d_v, p, coarse, pc=pc)

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


def rho_extra0(extra0_fn):
    """``extra0_fn``'s carry followed by the lagged Gershgorin pair of the
    merged kernel K1: the first iteration's bounds come from the
    conservative clamp ceiling rho = 0.999."""

    def fn(dt, dev):
        ceiling = torch.full((), 0.999, dtype=dt, device=dev)
        return (extra0_fn(dt, dev), (ceiling, ceiling.clone()))

    return fn


def simple_parts(mesh, fluid, bc, cfg, mom_cfg, pres_cfg, *, dtype, device):
    """What :func:`simple_solve` builds its loop from (``build_solver``'s
    arguments but the loop mode) for a state of ``dtype`` on ``device``,
    which decide :func:`~naviflow_tpu_torch.solvers.momentum.lagged_rho_enabled`."""
    nx, ny = mesh.get_dimensions()
    use_rho = lagged_rho_enabled(
        nx, ny, mom_cfg, fold_poisson=getattr(cfg, "fold_poisson", "auto") == "auto",
        dtype=dtype, device=device)
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    common = dict(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg, lagged_rho=use_rho)

    extra0_fn, refresh_every = lagged_extra0(mesh, pres_cfg, cfg, dx, dy, rho, zero_carry)
    if use_rho:
        extra0_fn = rho_extra0(extra0_fn)
    return dict(
        step=make_simple_step(**common), max_iterations=cfg.max_iterations,
        tolerance=cfg.tolerance, dx=dx, dy=dy, extra0_fn=extra0_fn,
        refresh_step=(make_simple_step(**common, coarse_mode="rebuild") if refresh_every
                      else None),
        refresh_every=refresh_every,
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
    fn = build_solver(**simple_parts(mesh, fluid, bc, cfg, momentum, pressure,
                                     dtype=state.u.dtype, device=state.u.device), loop=loop)
    return fn(state.u, state.v, state.p, on_chunk=on_chunk)
