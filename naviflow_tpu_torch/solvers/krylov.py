"""Matrix-free Krylov pressure solvers: CG, preconditioned CG, BiCGSTAB,
restarted GMRES and multigrid-preconditioned CG (port of
``naviflow_tpu/solvers/krylov.py``).

They run on the consistent / symmetric (singular, SPD on the range)
operator without pinning: for a compatible b the iterates stay in the
zero-mean complement, and the returned correction is mean-normalized.
Every matvec is the composed ``apply_poisson``; MGCG's preconditioner is
``multigrid.precondition`` (K2 / K3 per application on the kernel path).
Each loop is the JAX package's ``lax.while_loop`` (carry, ``cond``,
``body``) through ``ops/while_loop.py``: one host read an iteration (a
restart cycle for GMRES), and under ``torch.func.vmap`` one for every
case, each case stopping at its own count.  Every tensor the operator and
the preconditioner read is a loop operand.  The dots, norms, means and
GMRES's least-squares solve run through ``while_loop.case_by_case``: under
``vmap`` one case after another, each rounding as its single solve's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.poisson import PoissonCoeffs, apply_poisson, poisson_diagonal
from ..ops.while_loop import case_by_case, flatten, while_loop
from .multigrid import MultigridConfig, build_levels, precondition
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
    return case_by_case(_flat_dot, a, b)


def _flat_dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(x):
    return case_by_case(torch.linalg.vector_norm, x)


def _zero_mean(x):
    return x - case_by_case(torch.mean, x)


def _tol_abs(b, tol):
    bnorm = _norm(b)
    return tol * torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))


def _eps(dtype):
    return torch.finfo(dtype).tiny * 1e6


def _safe(x):
    """``x`` with zeros replaced by one (a divisor the guards discard)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def _count0(x):
    """A loop's int32 count at zero, on ``x``'s device."""
    return torch.zeros((), dtype=torch.int32, device=x.device)


def _true(x):
    """A loop's breakdown flag, set, on ``x``'s device."""
    return torch.ones((), dtype=torch.bool, device=x.device)


def _pcg(b, A, M, x0, tol, maxiter, data=()):
    """Flexible preconditioned CG (Polak-Ribière beta), tolerant of the
    mildly nonsymmetric multigrid preconditioner.  Breakdown guard: a step
    whose curvature is not above ``eps <p, p>`` (``eps = tiny * 1e6``) takes
    no step and ends the iteration.  ``A(x, *data)`` and ``M(r, *data)``
    read the tensors of ``data`` (a tuple of tensors or trees of them),
    which the loop takes as operands.  The loop is the JAX package's
    ``lax.while_loop`` over ``(x, r, p, rz, k, ok)`` through
    ``ops/while_loop.py``; returns ``(x, r, k)``, k an int32 count."""
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x, *data)
    z = M(r, *data)
    rz = _dot(r, z)
    tol_abs = _tol_abs(b, tol)
    eps = _eps(b.dtype)
    leaves, build = flatten(data)

    def cond(x, r, p, rz, k, ok, tol_abs, *leaves):
        return ok & (k < maxiter) & (_norm(r) > tol_abs)

    def body(x, r, p, rz, k, ok, tol_abs, *leaves):
        d = build(leaves)
        Ap = A(p, *d)
        pAp = _dot(p, Ap)
        good = pAp > eps * _dot(p, p)
        alpha = torch.where(good, rz / _safe(pAp), torch.zeros_like(pAp))
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M(r_new, *d)
        rz_new = _dot(r_new, z_new)
        beta = torch.where(torch.abs(rz) > eps, _dot(r_new - r, z_new) / rz,
                           torch.zeros_like(rz))
        p = z_new + beta * p
        return (x, r_new, p, rz_new, k + 1, good, tol_abs, *leaves)

    x, r, _, _, k, *_ = while_loop(cond, body, x, r, z, rz, _count0(b), _true(b), tol_abs,
                                   *leaves)
    return x, r, k


def _bicgstab(b, A, M, x0, tol, maxiter, data=()):
    """Preconditioned BiCGSTAB (``A``, ``M`` and ``data`` as in :func:`_pcg`);
    the loop is the JAX package's over ``(x, r, rho, alpha, omega, v, p, k,
    ok)``."""
    b = _zero_mean(b)
    x = _zero_mean(x0)
    r = b - A(x, *data)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    v = torch.zeros_like(b)
    tol_abs = _tol_abs(b, tol)
    eps = _eps(b.dtype)
    leaves, build = flatten(data)

    def cond(x, r, rho, alpha, omega, v, p, k, ok, rhat, tol_abs, *leaves):
        return ok & (k < maxiter) & (_norm(r) > tol_abs)

    def body(x, r, rho, alpha, omega, v, p, k, ok, rhat, tol_abs, *leaves):
        d = build(leaves)
        zero = torch.zeros_like(rho)
        rho_new = _dot(rhat, r)
        good = (torch.abs(rho) > eps) & (torch.abs(omega) > eps)
        beta = torch.where(good, (rho_new / _safe(rho)) * (alpha / _safe(omega)), zero)
        p = r + beta * (p - omega * v)
        ph = M(p, *d)
        v = A(ph, *d)
        denom = _dot(rhat, v)
        good = good & (torch.abs(denom) > eps)
        alpha = torch.where(good, rho_new / _safe(denom), zero)
        s = r - alpha * v
        sh = M(s, *d)
        t = A(sh, *d)
        tt = _dot(t, t)
        omega = torch.where(tt > eps, _dot(t, s) / _safe(tt), zero)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        return (x, r, rho_new, alpha, omega, v, p, k + 1, good, rhat, tol_abs, *leaves)

    x, r, *rest = while_loop(cond, body, x, r, one, one, one, v, v, _count0(b), _true(b), r,
                             tol_abs, *leaves)
    return x, r, rest[5]


def _lstsq(H, e1):
    """min_y ||e1 - H y|| by the pseudo-inverse with the JAX package's
    cutoff (singular values below ``eps * max(m, n) * s[0]`` dropped)."""
    return case_by_case(_pinv_solve, H, e1)


def _pinv_solve(H, e1):
    return torch.linalg.pinv(H, rtol=torch.finfo(H.dtype).eps * max(H.shape)) @ e1


def gmres_solve(b, A, M, x0, tol, maxiter, restart, data=()):
    """Restarted GMRES(m) with right preconditioning: solves A x = b in the
    Krylov space of A∘M, x = M(z).  Each restart cycle runs the full m
    Arnoldi steps (modified Gram-Schmidt) and solves the (m+1) x m
    least-squares problem by the SVD.  On a happy breakdown
    (h_{j+1,j} ~ 0) the next basis vector is zeroed.  ``A(x, *data)`` and
    ``M(r, *data)`` as in :func:`_pcg` (a solve that never runs under
    ``torch.func.vmap``, Newton's, may let them close over tensors).  The
    loop is the JAX package's ``lax.while_loop`` over restart cycles,
    ``(x, r, k)``; returns ``(x, r, k)`` with k the Arnoldi steps taken
    (multiples of m, an int32 count)."""
    dtype = x0.dtype
    m = restart
    tiny = _eps(dtype)

    def cycle(x, r, b, d):
        beta = _norm(r)
        safe_beta = torch.clamp(beta, min=tiny)
        V = x.new_zeros((m + 1,) + tuple(x.shape))
        V[0] = r / safe_beta
        H = x.new_zeros((m + 1, m))
        for j in range(m):
            w = A(M(V[j], *d), *d)
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
        x = x + M(torch.tensordot(y, V[:m], dims=1), *d)
        return x, b - A(x, *d)

    tol_abs = _tol_abs(b, tol)
    leaves, build = flatten(data)

    def cond(x, r, k, b, tol_abs, *leaves):
        return (k < maxiter) & (_norm(r) > tol_abs)

    def body(x, r, k, b, tol_abs, *leaves):
        x, r = cycle(x, r, b, build(leaves))
        return (x, r, k + m, b, tol_abs, *leaves)

    x, r, k, *_ = while_loop(cond, body, x0, b - A(x0, *data), _count0(b), b, tol_abs,
                             *leaves)
    return x, r, k


def solve_pressure_krylov(
    b, c: PoissonCoeffs, p0, cfg, *, d_u=None, d_v=None, dx=None, dy=None,
    rho=None, variant="consistent",
) -> Tuple[torch.Tensor, PressureSolveInfo]:
    """Krylov dispatch with the contract of ``solve_pressure``.  For
    ``mgcg`` the d-fields and grid spacing build the multigrid hierarchy.
    The operator's coefficients and the preconditioner's data (the
    hierarchy, the Jacobi inverse diagonal) reach the loop as its
    operands."""
    def A(x, c, pre):
        return apply_poisson(x, c, pinned=False)

    if cfg.kind == "mgcg":
        pre = build_levels(d_u, d_v, cfg.mg, dx=dx, dy=dy, rho=rho, variant=variant)

        def M(r, c, levels):
            return precondition(r, levels, cfg.mg, cfg.mg_cycles)

        x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations, (c, pre))
    else:
        if cfg.preconditioner == "jacobi":
            pre = 1.0 / poisson_diagonal(c, pinned=False)

            def M(r, c, inv_d):
                return r * inv_d
        elif cfg.preconditioner == "none":
            pre = None

            def M(r, c, pre):
                return r
        else:
            raise ValueError(f"Unknown preconditioner: {cfg.preconditioner}")
        data = (c, pre)
        if cfg.kind == "cg":
            x, r, k = _pcg(b, A, M, p0, cfg.tolerance, cfg.max_iterations, data)
        elif cfg.kind == "bicgstab":
            x, r, k = _bicgstab(b, A, M, p0, cfg.tolerance, cfg.max_iterations, data)
        elif cfg.kind == "gmres":
            x, r, k = gmres_solve(_zero_mean(b), A, M, _zero_mean(p0),
                                  cfg.tolerance, cfg.max_iterations, cfg.restart, data)
        else:
            raise ValueError(f"Unknown Krylov pressure solver: {cfg.kind}")

    x = _zero_mean(x)
    bnorm = _norm(b)
    rel = _norm(r) / torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    return x, PressureSolveInfo(iterations=k, residual_field=r, rel_residual=rel)
