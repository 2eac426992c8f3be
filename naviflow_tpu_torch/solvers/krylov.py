"""Matrix-free Krylov pressure solvers: CG, preconditioned CG, BiCGSTAB,
restarted GMRES and multigrid-preconditioned CG (port of
``naviflow_tpu/solvers/krylov.py``).

They run on the consistent / symmetric (singular, SPD on the range)
operator without pinning: for a compatible b the iterates stay in the
zero-mean complement, and the returned correction is mean-normalized.
Every matvec is the composed ``apply_poisson``; MGCG's preconditioner is
``multigrid.make_preconditioner`` (K2 / K3 per application on the kernel
path).  The JAX ``while_loop`` conditions become one host read per
iteration (the residual test and the breakdown guard read together; once
per restart cycle for GMRES).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from .multigrid import MultigridConfig, build_levels, make_preconditioner
from .pressure import PressureSolveInfo


@dataclasses.dataclass(frozen=True)
class CGPressureConfig:
    """(Preconditioned) conjugate gradients; use :class:`MGCGPressureConfig`
    for the multigrid preconditioner."""

    tolerance: float = 1e-7
    max_iterations: int = 2000
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "cg"


@dataclasses.dataclass(frozen=True)
class BiCGSTABPressureConfig:
    """Matrix-free BiCGSTAB."""

    tolerance: float = 1e-7
    max_iterations: int = 2000
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "bicgstab"


@dataclasses.dataclass(frozen=True)
class GMRESPressureConfig:
    """Matrix-free restarted GMRES(m)."""

    tolerance: float = 1e-7
    max_iterations: int = 2000  # total Arnoldi steps across restarts
    restart: int = 20
    preconditioner: str = "jacobi"  # 'none' | 'jacobi'
    kind: str = "gmres"


@dataclasses.dataclass(frozen=True)
class MGCGPressureConfig:
    """Multigrid-preconditioned CG: M = ``mg_cycles`` cycles of ``mg``."""

    tolerance: float = 1e-7
    max_iterations: int = 200
    mg_cycles: int = 1
    mg: MultigridConfig = MultigridConfig(pre_smoothing=2, post_smoothing=2)
    kind: str = "mgcg"


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(x):
    return torch.linalg.vector_norm(x)


def _zero_mean(x):
    return x - torch.mean(x)


def _tol_abs(b, tol):
    bnorm = _norm(b)
    return tol * torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))


def _eps(dtype):
    return torch.finfo(dtype).tiny * 1e6


def _safe(x):
    """``x`` with zeros replaced by one (a divisor the guards discard)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def _pcg(b, A, M, x0, tol, maxiter):
    """Flexible preconditioned CG (Polak-Ribière beta), tolerant of the
    mildly nonsymmetric multigrid preconditioner.  Breakdown guard: a step
    whose curvature is not above ``eps <p, p>`` (``eps = tiny * 1e6``) takes
    no step and ends the iteration."""
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    tol_abs = _tol_abs(b, tol)
    eps = _eps(b.dtype)
    k, go = 0, bool(_norm(r) > tol_abs)
    while go and k < maxiter:
        Ap = A(p)
        pAp = _dot(p, Ap)
        good = pAp > eps * _dot(p, p)
        alpha = torch.where(good, rz / _safe(pAp), torch.zeros_like(pAp))
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M(r_new)
        rz_new = _dot(r_new, z_new)
        beta = torch.where(torch.abs(rz) > eps, _dot(r_new - r, z_new) / rz,
                           torch.zeros_like(rz))
        p = z_new + beta * p
        r, rz = r_new, rz_new
        k += 1
        go = bool(good & (_norm(r) > tol_abs))
    return x, r, k


def _bicgstab(b, A, M, x0, tol, maxiter):
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x)
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(one)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    tol_abs = _tol_abs(b, tol)
    eps = _eps(b.dtype)
    k, go = 0, bool(_norm(r) > tol_abs)
    while go and k < maxiter:
        rho_new = _dot(rhat, r)
        good = (torch.abs(rho) > eps) & (torch.abs(omega) > eps)
        beta = torch.where(good, (rho_new / _safe(rho)) * (alpha / _safe(omega)), zero)
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = A(ph)
        denom = _dot(rhat, v)
        good = good & (torch.abs(denom) > eps)
        alpha = torch.where(good, rho_new / _safe(denom), zero)
        s = r - alpha * v
        sh = M(s)
        t = A(sh)
        tt = _dot(t, t)
        omega = torch.where(tt > eps, _dot(t, s) / _safe(tt), zero)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        k += 1
        go = bool(good & (_norm(r) > tol_abs))
    return x, r, k


def _lstsq(H, e1):
    """min_y ||e1 - H y|| by the pseudo-inverse with the JAX package's
    cutoff (singular values below ``eps * max(m, n) * s[0]`` dropped)."""
    return torch.linalg.pinv(H, rtol=torch.finfo(H.dtype).eps * max(H.shape)) @ e1


def gmres_solve(b, A, M, x0, tol, maxiter, restart):
    """Restarted GMRES(m) with right preconditioning: solves A x = b in the
    Krylov space of A∘M, x = M(z).  Each restart cycle runs the full m
    Arnoldi steps (modified Gram-Schmidt) and solves the (m+1) x m
    least-squares problem by the SVD.  On a happy breakdown
    (h_{j+1,j} ~ 0) the next basis vector is zeroed.  Returns
    ``(x, r, k)`` with k the Arnoldi steps taken (multiples of m)."""
    dtype = x0.dtype
    m = restart
    tiny = _eps(dtype)

    def cycle(x, r):
        beta = _norm(r)
        safe_beta = torch.clamp(beta, min=tiny)
        V = x.new_zeros((m + 1,) + tuple(x.shape))
        V[0] = r / safe_beta
        H = x.new_zeros((m + 1, m))
        for j in range(m):
            w = A(M(V[j]))
            hcol = x.new_zeros((m + 1,))
            # the basis vectors past j are still zero: their terms vanish
            for i in range(j + 1):
                hij = _dot(V[i], w)
                w = w - hij * V[i]
                hcol[i] = hij
            hn = _norm(w)
            hcol[j + 1] = hn
            breakdown = hn <= torch.finfo(dtype).eps * 100 * safe_beta
            V[j + 1] = torch.where(breakdown, torch.zeros_like(w),
                                   w / torch.clamp(hn, min=tiny))
            H[:, j] = hcol
        e1 = x.new_zeros((m + 1,))
        e1[0] = beta
        y = _lstsq(H, e1)
        x = x + M(torch.tensordot(y, V[:m], dims=1))
        return x, b - A(x)

    tol_abs = _tol_abs(b, tol)
    x = x0
    r = b - A(x)
    k = 0
    while k < maxiter and bool(_norm(r) > tol_abs):
        x, r = cycle(x, r)
        k += m
    return x, r, k


def _jacobi_M(c: PoissonCoeffs):
    inv_d = 1.0 / poisson_diagonal(c, pinned=False)
    return lambda r: r * inv_d


def solve_pressure_krylov(
    b, c: PoissonCoeffs, p0, cfg, *, d_u=None, d_v=None, dx=None, dy=None,
    rho=None, variant="consistent",
) -> Tuple[torch.Tensor, PressureSolveInfo]:
    """Krylov dispatch with the contract of ``solve_pressure``.  For
    ``mgcg`` the d-fields and grid spacing build the multigrid hierarchy."""
    def A(x):
        return apply_poisson(x, c, pinned=False)

    if cfg.kind == "mgcg":
        levels = build_levels(d_u, d_v, cfg.mg, dx=dx, dy=dy, rho=rho, variant=variant)
        M = make_preconditioner(levels, cfg.mg, cfg.mg_cycles)
        x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
    else:
        if cfg.preconditioner == "jacobi":
            M = _jacobi_M(c)
        elif cfg.preconditioner == "none":
            def M(r):
                return r
        else:
            raise ValueError(f"Unknown preconditioner: {cfg.preconditioner}")
        if cfg.kind == "cg":
            x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
        elif cfg.kind == "bicgstab":
            x, r, k = _bicgstab(b, A, M, p0, cfg.tolerance, cfg.max_iterations)
        elif cfg.kind == "gmres":
            x, r, k = gmres_solve(_zero_mean(b), A, M, _zero_mean(p0),
                                  cfg.tolerance, cfg.max_iterations, cfg.restart)
        else:
            raise ValueError(f"Unknown Krylov pressure solver: {cfg.kind}")

    x = _zero_mean(x)
    bnorm = _norm(b)
    rel = _norm(r) / torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    return x, PressureSolveInfo(iterations=k, residual_field=r, rel_residual=rel)
