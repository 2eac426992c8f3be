"""Pressure-solver dispatch for the algorithm layer (port of
``naviflow_tpu/solvers/dispatch.py``).  The Krylov pressure solvers are not
ported yet (ROADMAP §1 item 10)."""

from __future__ import annotations

from .multigrid import MultigridConfig, multigrid_solve
from .pressure import RBGSPressureConfig, solve_pressure

STATIONARY_KINDS = ("jacobi", "rbgs", "direct")
KRYLOV_KINDS = ("cg", "bicgstab", "gmres", "mgcg")

PRESSURE_CONFIG_TYPES = (RBGSPressureConfig, MultigridConfig)


def dispatch_pressure_solve(
    b, pc, p0, cfg, *, d_u, d_v, dx, dy, rho, variant, pin
):
    """Route a pressure solve to the configured implementation."""
    if cfg.kind in STATIONARY_KINDS:
        return solve_pressure(b, pc, p0, cfg, pin=pin)
    if cfg.kind in KRYLOV_KINDS:
        raise NotImplementedError(
            f"{cfg.kind} pressure solve: solvers/krylov.py is not ported yet "
            "(ROADMAP §1 item 10)")
    if cfg.kind == "multigrid":
        return multigrid_solve(
            b, d_u, d_v, p0, cfg, dx=dx, dy=dy, rho=rho, variant=variant
        )
    raise ValueError(f"Unknown pressure solver kind: {cfg.kind}")
