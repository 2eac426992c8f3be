"""Pressure-correction Poisson operator, RHS, and divergence (port of
``naviflow_tpu/ops/poisson.py``).

Three operator variants, as in the JAX package:

* ``'reference'`` — the reference's boundary fold: at each wall the
  opposite-face coefficient of the boundary cell is added to the diagonal
  and then zeroed (an asymmetric operator);
* ``'symmetric'`` — boundary-face coefficients simply absent;
* ``'consistent'`` (the algorithms' default) — additionally masks the
  d-entries of faces the velocity corrector never updates, making the
  operator the exact Schur complement of the correction step.

Gauge pin: with ``pinned``, row (0,0) is an identity row.
"""

from __future__ import annotations

import dataclasses

import torch

from .stencil import pad2, shift_e, shift_n, shift_s, shift_w, where_add, where_set


@dataclasses.dataclass(frozen=True)
class PoissonCoeffs:
    """Row form: ``diag*p - a_e*p_E - a_w*p_W - a_n*p_N - a_s*p_S``."""

    a_e: torch.Tensor
    a_w: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    diag: torch.Tensor


def poisson_coefficients(d_u, d_v, *, dx, dy, rho, variant: str = "reference") -> PoissonCoeffs:
    """5-point pressure-correction coefficients from the momentum d-fields.

    a_E[i,j] = rho*d_u[i+1,j]*dy (i<nx-1),  a_W[i,j] = rho*d_u[i,j]*dy (i>0),
    a_N[i,j] = rho*d_v[i,j+1]*dx (j<ny-1),  a_S[i,j] = rho*d_v[i,j]*dx (j>0).
    """
    nxp1, _ = d_u.shape
    nx = nxp1 - 1
    ny = d_v.shape[1] - 1

    if variant == "consistent":
        d_u = where_set(where_set(d_u, 0.0, cols=0), 0.0, cols=ny - 1)
        d_v = where_set(where_set(d_v, 0.0, rows=0), 0.0, rows=nx - 1)

    a_e = pad2(rho * d_u[1:nx, :] * dy, 0, 1)
    a_w = pad2(rho * d_u[1:nx, :] * dy, 1, 0)
    a_n = pad2(rho * d_v[:, 1:ny] * dx, 0, 0, 0, 1)
    a_s = pad2(rho * d_v[:, 1:ny] * dx, 0, 0, 1, 0)

    diag = torch.zeros((nx, ny), dtype=d_u.dtype, device=d_u.device)
    if variant == "reference":
        diag = where_add(diag, a_e[0, :], rows=0)
        diag = where_add(diag, a_w[nx - 1, :], rows=nx - 1)
        diag = where_add(diag, a_n[:, 0], cols=0)
        diag = where_add(diag, a_s[:, ny - 1], cols=ny - 1)
        a_e = where_set(a_e, 0.0, rows=0)
        a_w = where_set(a_w, 0.0, rows=nx - 1)
        a_n = where_set(a_n, 0.0, cols=0)
        a_s = where_set(a_s, 0.0, cols=ny - 1)
    elif variant not in ("symmetric", "consistent"):
        raise ValueError(f"Unknown poisson operator variant: {variant}")

    diag = diag + a_e + a_w + a_n + a_s
    return PoissonCoeffs(a_e=a_e, a_w=a_w, a_n=a_n, a_s=a_s, diag=diag)


def apply_poisson(p, c: PoissonCoeffs, *, pinned: bool = True):
    """Matrix-free A @ p; with ``pinned`` row (0,0) acts as identity."""
    out = (
        c.diag * p
        - c.a_e * shift_e(p)
        - c.a_w * shift_w(p)
        - c.a_n * shift_n(p)
        - c.a_s * shift_s(p)
    )
    if pinned:
        out = where_set(out, p[0, 0], rows=0, cols=0)
    return out


def poisson_diagonal(c: PoissonCoeffs, *, pinned: bool = True, floor: float = 1e-15):
    """Diagonal for Jacobi-type smoothers (entries below ``floor`` -> 1)."""
    d = torch.where(c.diag < floor, torch.ones_like(c.diag), c.diag)
    if pinned:
        d = where_set(d, 1.0, rows=0, cols=0)
    return d


def pressure_rhs(u_star, v_star, *, dx, dy, rho, pin: bool = True):
    """Continuity defect b = rho * ((u_W - u_E) dy + (v_S - v_N) dx) per cell,
    with b[0,0]=0 under the pinned gauge."""
    b = rho * (
        (u_star[:-1, :] - u_star[1:, :]) * dy + (v_star[:, :-1] - v_star[:, 1:]) * dx
    )
    if pin:
        b = where_set(b, 0.0, rows=0, cols=0)
    return b


def divergence(u, v, *, dx, dy):
    """Cell-centered velocity divergence."""
    return (u[1:, :] - u[:-1, :]) / dx + (v[:, 1:] - v[:, :-1]) / dy


def max_interior_divergence(u, v, *, dx, dy):
    """Max |div| excluding one boundary ring."""
    div = divergence(u, v, dx=dx, dy=dy)
    return torch.max(torch.abs(div[1:-1, 1:-1]))
