"""Lagged Galerkin coarse-hierarchy carry, shared by the SIMPLE-family
algorithms (port of ``naviflow_tpu/algorithms/lagged.py``).

With ``MultigridConfig(coarse_rebuild_every=K > 1)`` the coarse Galerkin
operators are rebuilt only every K outer iterations and carried across
iterations in the algorithm's ``extra``.  The fine operator is always
assembled from the current d-coefficients, so the pressure solve's fixed
point is the exact solution of the current system.  The harness runs the
rebuild as a separate *refresh step* at iterations 0, K, 2K, ...
(``base.run_outer_loop(refresh_step=..., refresh_every=K)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LaggedMG(NamedTuple):
    """``rebuild(d_u, d_v) -> coarse`` builds the coarse stencil tuple;
    ``solve(b, pc, d_u, d_v, p_like, coarse)`` runs the multigrid solve on
    [fresh fine level] + [given coarse levels]; ``extra0(dtype, nx, ny,
    device) -> (age0, coarse0)`` is the placeholder carry (the refresh step
    replaces it on the first iteration)."""

    rebuild: Callable
    solve: Callable
    extra0: Callable


def uses_lagged_mg(pres_cfg) -> bool:
    return (
        getattr(pres_cfg, "kind", "") == "multigrid"
        and getattr(pres_cfg, "coarse_rebuild_every", 1) > 1
        and getattr(pres_cfg, "smoother", "gs") != "chebyshev"
    )


def make_lagged_mg(pres_cfg, *, dx, dy, rho, variant) -> LaggedMG:
    """Build the lagged-hierarchy protocol pieces (see :class:`LaggedMG`).
    ``mg_extra`` is ``(age: int, coarse: tuple[Stencil9, ...])``."""
    from ..ops.stencil9 import from_poisson
    from ..solvers.multigrid import build_levels, coarse_stencils, multigrid_solve

    def rebuild(d_u, d_v):
        return coarse_stencils(
            build_levels(d_u, d_v, pres_cfg, dx=dx, dy=dy, rho=rho, variant=variant))

    def solve(b, pc, d_u, d_v, p_like, coarse):
        fine_st = from_poisson(pc)
        levels = [(fine_st, fine_st.shape, True, None)] + [
            (st, st.shape, False, None) for st in coarse
        ]
        return multigrid_solve(
            b, d_u, d_v, torch.zeros_like(p_like), pres_cfg,
            dx=dx, dy=dy, rho=rho, variant=variant, levels=levels)

    def extra0(dt, nx, ny, device=None):
        d_u0 = torch.ones((nx + 1, ny), dtype=dt, device=device) * dy
        d_v0 = torch.ones((nx, ny + 1), dtype=dt, device=device) * dx
        return (0, rebuild(d_u0, d_v0))

    return LaggedMG(rebuild=rebuild, solve=solve, extra0=extra0)
