"""Pressure-correction solvers (port of ``naviflow_tpu/solvers/pressure.py``):
red-black SOR and weighted-Jacobi sweeps with their sweep-until-converged
loop (``ops/while_loop.py``), which reads the relative residual back on
the host after every ``check_every`` sweeps, and the dense direct solve
(``torch.linalg.solve`` on the assembled matrix; intended for <= ~64^2
grids).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from ..ops.stencil import index_grids, shift_e, shift_n, shift_s, shift_w, where_set
from ..ops.while_loop import case_by_case, flatten, while_loop


@dataclasses.dataclass(frozen=True)
class PressureSolveInfo:
    """Residual info returned by every pressure solve."""

    # inner-iteration count (a loop's: its int32 count, a tensor)
    iterations: int | torch.Tensor
    residual_field: torch.Tensor  # b - A p (full grid)
    rel_residual: torch.Tensor  # ||b - Ap|| / ||b|| at exit (0-d)


@dataclasses.dataclass(frozen=True)
class JacobiPressureConfig:
    """Weighted Jacobi: p += omega * D^-1 (b - Ap)."""

    tolerance: float = 1e-5
    max_iterations: int = 10000
    omega: float = 0.8
    check_every: int = 1
    kind: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class DirectPressureConfig:
    """Dense direct solve: the exact answer on small grids (O(n^3))."""

    kind: str = "direct"


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


def jacobi_sweep(p, b, c: PoissonCoeffs, omega: float, *, pin: bool = True):
    """p_new = p + omega * D^-1 (b - Ap)."""
    diag = poisson_diagonal(c, pinned=pin)
    r = b - apply_poisson(p, c, pinned=pin)
    p_new = p + omega * r / diag
    if pin:
        p_new = where_set(p_new, 0.0, rows=0, cols=0)
    return p_new


def _iterate(p0, b, c: PoissonCoeffs, sweep_fn, tol, max_iter, check_every, pin):
    """Sweep-until-converged loop: ``check_every`` sweeps ``sweep_fn(p, b,
    c)`` per residual evaluation, stop on ||b - Ap||/||b|| < tol.  The loop
    is the JAX package's ``lax.while_loop`` over ``(p, k, rel)`` through
    ``ops/while_loop.py`` (one host read a check; under ``torch.func.vmap``
    one for every case, the norms and the mean case by case:
    ``while_loop.case_by_case``); ``iterations`` is its int32 count."""
    bnorm = case_by_case(torch.linalg.vector_norm, b)
    safe_bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    leaves, build = flatten(c)

    def cond(p, k, rel, b, safe_bnorm, *leaves):
        return (k < max_iter) & (rel.double() >= tol)

    def body(p, k, rel, b, safe_bnorm, *leaves):
        c = build(leaves)
        for _ in range(check_every):
            p = sweep_fn(p, b, c)
        r = b - apply_poisson(p, c, pinned=pin)
        rel = case_by_case(torch.linalg.vector_norm, r) / safe_bnorm
        return (p, k + check_every, rel, b, safe_bnorm, *leaves)

    k0 = torch.zeros((), dtype=torch.int32, device=p0.device)
    rel0 = torch.full((), float("inf"), dtype=p0.dtype, device=p0.device)
    p, k, rel, *_ = while_loop(cond, body, p0, k0, rel0, b, safe_bnorm, *leaves)
    if not pin:
        p = p - case_by_case(torch.mean, p)
    r = b - apply_poisson(p, c, pinned=pin)
    return p, PressureSolveInfo(iterations=k, residual_field=r, rel_residual=rel)


def _fortran(x):
    """Flatten with i fastest (cell k = i + j nx)."""
    return x.T.reshape(-1)


def dense_poisson_matrix(c: PoissonCoeffs, *, pin: bool):
    """The dense pressure matrix with Fortran cell numbering k = i + j nx.

    Unpinned (singular, symmetric variants): empty rows are floored to
    identity and a rank-one ones/n shift fixes the constant-mode gauge, so
    for a compatible b the solution satisfies A x = b with mean(x) ~ 0.
    Pinned: row 0 is the identity row.  Built out of place (each band a
    ``diag_embed``), so that ``torch.func.vmap`` takes it with a case's
    coefficients."""
    nx, ny = c.diag.shape
    n = nx * ny
    diag = _fortran(c.diag)
    if not pin:
        diag = torch.where(torch.abs(diag) < 1e-15, torch.ones_like(diag), diag)
    # each off-diagonal entry is one band's (a_e is zero where i == nx-1, so
    # its wrap into the next column of cells is harmless), added to zeros
    off = (torch.diag_embed(-_fortran(c.a_e)[:-1], 1)
           + torch.diag_embed(-_fortran(c.a_w)[1:], -1)
           + torch.diag_embed(-_fortran(c.a_n)[:-nx], nx)
           + torch.diag_embed(-_fortran(c.a_s)[nx:], -nx))
    eye = torch.eye(n, dtype=torch.bool, device=c.diag.device)
    A = torch.where(eye, torch.diag_embed(diag), off)
    if pin:
        first = torch.zeros(n, dtype=torch.bool, device=c.diag.device)
        first[0] = True
        A = torch.where(first.view(-1, 1), eye.to(A.dtype), A)
    else:
        A = A + torch.ones_like(A) / n
    return A


def solve_pressure_direct(b, c: PoissonCoeffs, *, pin: bool = False):
    """The exact dense solve of A p = b.  The solve, the mean and the norms
    run through ``while_loop.case_by_case``: under ``torch.func.vmap`` each
    case factors and rounds as its single solve (a batched LU need not)."""
    nx, ny = b.shape
    A = dense_poisson_matrix(c, pin=pin)
    x = case_by_case(torch.linalg.solve, A, _fortran(b))
    # contiguous, as each case's field under vmap is: the mean and the norms
    # below sum in memory order
    p = x.reshape(ny, nx).T.contiguous()
    if not pin:
        p = p - case_by_case(torch.mean, p)
    r = b - apply_poisson(p, c, pinned=pin)
    bnorm = case_by_case(torch.linalg.vector_norm, b)
    rel = (case_by_case(torch.linalg.vector_norm, r)
           / torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm)))
    return p, PressureSolveInfo(iterations=1, residual_field=r, rel_residual=rel)


def solve_pressure(b, c: PoissonCoeffs, p0, cfg, *, pin: bool = False):
    """Dispatch on the solver config (``pin``: gauge by the (0,0) identity
    row; otherwise by mean removal)."""
    if cfg.kind == "direct":
        return solve_pressure_direct(b, c, pin=pin)
    if cfg.kind == "jacobi":
        def sweep(p, b, c):
            return jacobi_sweep(p, b, c, cfg.omega, pin=pin)
    elif cfg.kind == "rbgs":
        def sweep(p, b, c):
            return rbgs_sweep(p, b, c, cfg.omega, pin=pin)
    else:
        raise ValueError(f"Unknown pressure solver kind: {cfg.kind}")
    if pin:
        p0 = where_set(p0, 0.0, rows=0, cols=0)
    return _iterate(p0, b, c, sweep, cfg.tolerance, cfg.max_iterations,
                    cfg.check_every, pin)
