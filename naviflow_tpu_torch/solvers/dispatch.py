"""Pressure-solver dispatch for the algorithm layer (port of
``naviflow_tpu/solvers/dispatch.py``)."""

from __future__ import annotations

from .krylov import (
    BiCGSTABPressureConfig,
    CGPressureConfig,
    GMRESPressureConfig,
    MGCGPressureConfig,
    solve_pressure_krylov,
)
from .multigrid import MultigridConfig, multigrid_solve
from .pressure import (
    DirectPressureConfig,
    JacobiPressureConfig,
    RBGSPressureConfig,
    solve_pressure,
)

STATIONARY_KINDS = ("jacobi", "rbgs", "direct")
KRYLOV_KINDS = ("cg", "bicgstab", "gmres", "mgcg")

PRESSURE_CONFIG_TYPES = (
    DirectPressureConfig,
    JacobiPressureConfig,
    RBGSPressureConfig,
    CGPressureConfig,
    BiCGSTABPressureConfig,
    GMRESPressureConfig,
    MGCGPressureConfig,
    MultigridConfig,
)


def dispatch_pressure_solve(
    b, pc, p0, cfg, *, d_u, d_v, dx, dy, rho, variant, pin
):
    """Route a pressure solve to the configured implementation."""
    if cfg.kind in STATIONARY_KINDS:
        return solve_pressure(b, pc, p0, cfg, pin=pin)
    if cfg.kind in KRYLOV_KINDS:
        return solve_pressure_krylov(
            b, pc, p0, cfg, d_u=d_u, d_v=d_v, dx=dx, dy=dy, rho=rho, variant=variant
        )
    if cfg.kind == "multigrid":
        return multigrid_solve(
            b, d_u, d_v, p0, cfg, dx=dx, dy=dy, rho=rho, variant=variant
        )
    raise ValueError(f"Unknown pressure solver kind: {cfg.kind}")
