"""Chebyshev polynomial smoothing and spectral-radius estimation (port of
``naviflow_tpu/solvers/chebyshev.py``).

* :func:`estimate_lambda_max`: power iteration on D^-1 A;
* :func:`chebyshev_smooth`: a first-kind Chebyshev smoother targeting the
  upper eigenvalue band [lambda_max/theta, lambda_max] (the multigrid
  smoothing band; the recurrence of hypre / PyAMG).

The power iterations start from a normal vector drawn by a seeded
``torch.Generator`` on the operator's device; its bits differ from the
JAX package's PRNG, so the estimates agree with the JAX package's only to
the power iteration's convergence, not bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.stencil9 import Stencil9, apply9, stencil9_diagonal


def _start_vector(st: Stencil9, shape, seed: int):
    g = torch.Generator(device=st.c.device).manual_seed(seed)
    x = torch.randn(tuple(shape), generator=g, dtype=st.c.dtype, device=st.c.device)
    return x / torch.linalg.vector_norm(x)


def _power(x, op, iterations: int):
    """``iterations`` power steps of ``op`` from ``x``; the last norm."""
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        y = op(x)
        lam = torch.linalg.vector_norm(y)
        x = y / torch.clamp(lam, min=1e-30)
    return lam


def estimate_lambda_max(st: Stencil9, shape, *, iterations: int = 25, seed: int = 7):
    """Largest eigenvalue of D^-1 A by power iteration (a 0-d tensor)."""
    inv_d = 1.0 / stencil9_diagonal(st)
    return _power(_start_vector(st, shape, seed), lambda x: inv_d * apply9(x, st), iterations)


def optimal_jacobi_omega(lam_max, lam_min=0.0):
    """Damped-Jacobi weight minimizing the smoothing radius over
    [lam_min, lam_max]: omega* = 2 / (lam_min + lam_max)."""
    return 2.0 / (lam_min + lam_max)


def estimate_smoother_spectral_radius(st: Stencil9, shape, omega: float,
                                      *, iterations: int = 40, seed: int = 11):
    """Spectral radius of the damped-Jacobi iteration matrix
    I - omega D^-1 A by power iteration."""
    inv_d = 1.0 / stencil9_diagonal(st)
    return _power(_start_vector(st, shape, seed),
                  lambda x: x - omega * inv_d * apply9(x, st), iterations)


def chebyshev_smooth(p, b, st: Stencil9, lam_max, *, degree: int = 4,
                     theta: float = 30.0):
    """``degree`` Chebyshev iterations on A p = b, preconditioned by D^-1.

    Eigenvalue band [lam_max/theta, 1.05*lam_max]; three-term recurrence:

        z_0 = D^-1 r / d;   rho_0 = 1/sigma
        p <- p + z;  r = D^-1 (b - A p)
        rho_k = 1/(2 sigma - rho_{k-1})
        z <- rho_k rho_{k-1} z + (2 rho_k / delta) r
    """
    inv_d = 1.0 / stencil9_diagonal(st)
    lmax = 1.05 * lam_max
    lmin = lam_max / theta
    d = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = d / delta
    rho = torch.as_tensor(1.0 / sigma, dtype=p.dtype, device=p.device)

    r = inv_d * (b - apply9(p, st))
    z = r / d
    for _ in range(degree - 1):
        p = p + z
        r = inv_d * (b - apply9(p, st))
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = rho_new * rho * z + (2.0 * rho_new / delta) * r
        rho = rho_new
    return p + z
