"""Pressure-correction solvers (port of ``naviflow_tpu/solvers/pressure.py``,
``simple_solve``'s default subset): red-black SOR sweeps and their
sweep-until-converged loop.  It runs on the host: it reads the
relative residual back after every ``check_every`` sweeps.

The weighted-Jacobi and dense direct solves are not ported yet (ROADMAP §1
item 10); their kinds raise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from ..ops.stencil import index_grids, shift_e, shift_n, shift_s, shift_w, where_set


@dataclasses.dataclass(frozen=True)
class PressureSolveInfo:
    """Residual info returned by every pressure solve."""

    iterations: int  # inner-iteration count
    residual_field: torch.Tensor  # b - A p (full grid)
    rel_residual: torch.Tensor  # ||b - Ap|| / ||b|| at exit (0-d)


@dataclasses.dataclass(frozen=True)
class RBGSPressureConfig:
    """Red-black Gauss-Seidel with SOR (``simple_solve``'s default)."""

    tolerance: float = 1e-5
    max_iterations: int = 10000
    omega: float = 1.5
    check_every: int = 1
    kind: str = "rbgs"


def rbgs_sweep(p, b, c: PoissonCoeffs, omega: float, *, pin: bool = True):
    """One red-black SOR sweep, as two masked whole-grid half-updates."""
    ii, jj = index_grids(p.shape, p.device)
    red = (ii + jj) % 2 == 0
    if pin:
        red = where_set(red, False, rows=0, cols=0)
    black = torch.logical_not(red)
    if pin:
        black = where_set(black, False, rows=0, cols=0)
    inv_ap = 1.0 / poisson_diagonal(c, pinned=pin)

    def half(p, color):
        nbsum = (
            c.a_e * shift_e(p)
            + c.a_w * shift_w(p)
            + c.a_n * shift_n(p)
            + c.a_s * shift_s(p)
        )
        p_new = (b + nbsum) * inv_ap
        return torch.where(color, p + omega * (p_new - p), p)

    p = half(p, red)
    p = half(p, black)
    if pin:
        p = where_set(p, 0.0, rows=0, cols=0)
    return p


def _iterate(p0, b, c: PoissonCoeffs, sweep_fn, tol, max_iter, check_every, pin):
    """Sweep-until-converged loop: ``check_every`` sweeps per residual
    evaluation, stop on ||b - Ap||/||b|| < tol (host check)."""
    bnorm = torch.linalg.vector_norm(b)
    safe_bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    p, k = p0, 0
    rel = torch.full((), float("inf"), dtype=p0.dtype, device=p0.device)
    while k < max_iter and float(rel) >= tol:
        for _ in range(check_every):
            p = sweep_fn(p)
        r = b - apply_poisson(p, c, pinned=pin)
        rel = torch.linalg.vector_norm(r) / safe_bnorm
        k += check_every
    if not pin:
        p = p - torch.mean(p)
    r = b - apply_poisson(p, c, pinned=pin)
    return p, PressureSolveInfo(iterations=k, residual_field=r, rel_residual=rel)


def solve_pressure(b, c: PoissonCoeffs, p0, cfg, *, pin: bool = False):
    """Dispatch on the solver config (``pin``: gauge by the (0,0) identity
    row; otherwise by mean removal)."""
    if cfg.kind in ("direct", "jacobi"):
        raise NotImplementedError(
            f"{cfg.kind} pressure solve is not ported yet (ROADMAP §1 item 10)")
    if cfg.kind != "rbgs":
        raise ValueError(f"Unknown pressure solver kind: {cfg.kind}")

    def sweep(p):
        return rbgs_sweep(p, b, c, cfg.omega, pin=pin)

    if pin:
        p0 = where_set(p0, 0.0, rows=0, cols=0)
    return _iterate(p0, b, c, sweep, cfg.tolerance, cfg.max_iterations,
                    cfg.check_every, pin)
