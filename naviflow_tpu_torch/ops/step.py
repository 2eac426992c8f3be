"""K6: one whole SIMPLE outer step as one kernel launch.

Replaces ``naviflow_tpu/ops/pallas_step.py:fused_outer_step`` /
``fused_simple_step`` (the ``'simple'`` body); the CUDA kernel is
``csrc/step.cu`` (its header says the order of the step, what bounds it on
the H100 and how the grid stays in step).

The step differs from the composed ``algorithms/simple.make_simple_step``
as the reference kernel does: the momentum solves use compensated dots and
the compensated residual, the coarse operators are rebuilt every step
(``coarse_rebuild_every`` is ignored; the lagged carry passes through), and
the multigrid solve starts from zeros with the whole-solve kernel's
compensated stopping norms, mean-normalised unless the Poisson variant is
'reference'.  :func:`fused_outer_step_plain` is that step composed, the CPU
path and the kernel's oracle.

``simplec``, ``piso`` and ``simpler`` have step bodies in the reference
kernel; those algorithms are not in the port yet (ROADMAP §1 item 6), so
their bodies raise here.

The gate's budgets are the reference's TPU VMEM budgets, kept so that the
port dispatches as the reference does; they are not H100 limits.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _cuda
from .compensated import fold_norm2
from .mg import (RED_FLOATS, _padded_bytes, fused_mg_solve_plain, galerkin_levels_plain,
                 supports_fused)
from .poisson import poisson_coefficients, pressure_rhs
from .stencil9 import Stencil9, from_poisson

STEP_VMEM_BUDGET_BYTES = 12 * 2**20
_ALGO_VMEM_BUDGETS = {
    "simple": STEP_VMEM_BUDGET_BYTES,
    "simplec": 14 * 2**20,
    "piso": 14 * 2**20,
    "simpler": 14 * 2**20,
}
_ALGO_FINE_TEMPS = {"simple": 30, "simplec": 32, "piso": 38, "simpler": 36}

# (scalar carries in, scalar results out) per algorithm
ALGO_SCALARS = {
    "simple": (1, 4),   # p_max -> p_max', u_norm, v_norm, p_rel
    "simplec": (2, 5),  # alpha_p, prev -> alpha_p', total, u_res, v_res, p_res
    "piso": (1, 4),     # p_max -> p_max', u_norm, v_norm, p_rel
    "simpler": (1, 4),  # p_max (unused) -> p_max, u_norm, v_norm, p_rel
}

_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}
_SIDES = ("top", "bottom", "left", "right")

LAUNCHES = 0


def step_shapes(nx: int, ny: int, pres_cfg):
    """The multigrid level shapes of the step kernel (odd/vertex)."""
    shapes = [(nx, ny)]
    while min(shapes[-1]) > pres_cfg.coarsest_grid_size:
        shapes.append(((shapes[-1][0] - 1) // 2, (shapes[-1][1] - 1) // 2))
    return shapes


def supports_fused_step(nx, ny, simple_cfg, mom_cfg, pres_cfg, dtype,
                        algo: str = "simple") -> bool:
    """Gate: power-law BiCGSTAB momentum, a multigrid V-cycle config the
    fused solve takes, an odd square grid, everything within the TPU
    budget (the reference's rule)."""
    if dtype != torch.float32 or algo not in ALGO_SCALARS:
        return False
    if (getattr(mom_cfg, "kind", "") != "bicgstab"
            or getattr(mom_cfg, "scheme", "power_law") != "power_law"):
        return False
    if getattr(pres_cfg, "kind", "") != "multigrid":
        return False
    # no in-kernel FMG bootstrap: the step's solve starts from zeros
    if getattr(pres_cfg, "cycle_type", "v") != "v":
        return False
    if algo == "piso" and getattr(simple_cfg, "corrector", "jacobi") not in ("jacobi", "exact"):
        return False
    shapes = step_shapes(nx, ny, pres_cfg)
    z = torch.zeros((1, 1), dtype=dtype)
    fake_levels = [(Stencil9(*(z,) * 9), shp, lvl == 0, None)
                   for lvl, shp in enumerate(shapes)]
    if not supports_fused(fake_levels, pres_cfg):
        return False
    total = _ALGO_FINE_TEMPS[algo] * _padded_bytes(nx, ny)
    for lvl, (snx, sny) in enumerate(shapes):
        total += ((5 if lvl == 0 else 9) + 3) * _padded_bytes(snx, sny)
    return total <= _ALGO_VMEM_BUDGETS[algo]


def _unported_algo(algo):
    if algo not in ALGO_SCALARS:
        raise ValueError(f"Unknown algorithm: {algo}")
    if algo != "simple":
        raise NotImplementedError(
            f"the {algo!r} step body: algorithms/{algo}.py is not ported yet (ROADMAP §1 "
            "item 6); its K6 body comes with it")


def fused_outer_step_plain(algo, u, v, p, scalars, *, dx, dy, rho, mu, bc, cfg, mom_cfg,
                           pres_cfg):
    """The step composed (see the module docstring).  Returns ``(u', v',
    p', scalars_out, cycles, r_u, r_v, r_p)``."""
    from ..core.bc import enforce_pressure_bcs
    from ..solvers.momentum import solve_u_momentum, solve_v_momentum
    from ..solvers.velocity import update_velocity

    _unported_algo(algo)
    (p_max,) = scalars
    mom = dataclasses.replace(mom_cfg, backend="composed", compensated_dots=True,
                              compensated_residual=True)
    pin = cfg.poisson_variant == "reference"
    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, alpha=cfg.alpha_u, bc=bc, cfg=mom)
    u_star, d_u, r_u, u_norm = solve_u_momentum(u, v, p, **kw)
    v_star, d_v, r_v, v_norm = solve_v_momentum(u, v, p, **kw)
    b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
    fine = from_poisson(poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                             variant=cfg.poisson_variant))
    shapes = step_shapes(*p.shape, pres_cfg)
    levels = [(fine, shapes[0], True, None)] + [
        (st, shp, False, None)
        for st, shp in zip(galerkin_levels_plain(fine, shapes, True), shapes[1:])]
    p_prime, r_p, cycles, _ = fused_mg_solve_plain(torch.zeros_like(p), b, levels, pres_cfg,
                                                   mean_normalize=not pin)
    p_new = p + cfg.alpha_p * p_prime
    if cfg.overwrite_boundary_pressure:
        p_new = enforce_pressure_bcs(p_new, bc)
    u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)
    p_l2 = torch.sqrt(fold_norm2(r_p[1:-1, 1:-1]))
    p_max_new = torch.maximum(torch.as_tensor(p_max, dtype=p.dtype, device=p.device), p_l2)
    p_rel = torch.where(p_max_new > 0, p_l2 / p_max_new, torch.ones_like(p_l2))
    return (u_new, v_new, p_new, (p_max_new, u_norm, v_norm, p_rel), cycles,
            r_u, r_v, r_p)


def fused_outer_step(algo, u, v, p, scalars, *, dx, dy, rho, mu, bc, cfg, mom_cfg, pres_cfg):
    """One outer iteration of ``algo`` as one kernel launch (always-fresh
    coarse operators).  ``scalars`` is the algorithm's scalar carry (see
    ``ALGO_SCALARS``).  Returns ``(u', v', p', scalars_out, cycles, r_u,
    r_v, r_p)`` with the scalars as 0-d tensors."""
    global LAUNCHES
    _unported_algo(algo)
    if not u.is_cuda:
        return fused_outer_step_plain(algo, u, v, p, scalars, dx=dx, dy=dy, rho=rho, mu=mu,
                                      bc=bc, cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    nx, ny = p.shape
    _cuda.require(u, (nx + 1, ny), "u")
    _cuda.require(v, (nx, ny + 1), "v")
    _cuda.require(p, (nx, ny), "p")
    if cfg.poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {cfg.poisson_variant}")
    dev = u.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    (p_max,) = scalars
    pmax_in = torch.as_tensor(p_max, dtype=torch.float32, device=dev).reshape(1).contiguous()
    shapes = step_shapes(nx, ny, pres_cfg)
    nk = max((nx + 1) * ny, nx * (ny + 1))
    outs = [empty(nx + 1, ny), empty(nx, ny + 1), empty(nx, ny),      # u', v', p'
            empty(nx + 1, ny), empty(nx, ny + 1), empty(nx, ny),      # r_u, r_v, r_p
            empty(4), empty(1, dtype=torch.int32)]                    # scalars, cycles
    scratch = ([empty(nx + 1, ny), empty(nx, ny + 1)]                 # ub, vb
               + [empty(nx + 1, ny) for _ in range(8)]                # u coefficients
               + [empty(nx, ny + 1) for _ in range(8)]                # v coefficients
               + [empty(nx + 1, ny), empty(nx, ny + 1),               # u*, v*
                  empty(nx + 1, ny), empty(nx, ny + 1),               # d_u, d_v
                  empty(6 * nk), empty(nx, ny)]                       # Krylov, p before BCs
               + [empty(nx, ny) for _ in range(7)])                   # fine operator, b, p'
    coarse = [empty(ni, nj) for ni, nj in shapes[1:] for _ in range(11)]
    red = empty(RED_FLOATS)
    keep = [pmax_in, *outs, *scratch, *coarse, red]
    ptrs = [u.data_ptr(), v.data_ptr(), p.data_ptr()] + [t.data_ptr() for t in keep]
    sides = [bc.side(name) for name in _SIDES]
    vel = [int(s.kind.value == "velocity") for s in sides]
    ip = [nx, ny, len(shapes), pres_cfg.pre_smoothing, pres_cfg.post_smoothing,
          pres_cfg.coarsest_sweeps, pres_cfg.max_cycles, pres_cfg.check_every,
          mom_cfg.max_iterations, int(cfg.poisson_variant == "reference"),
          _VARIANTS[cfg.poisson_variant], int(cfg.overwrite_boundary_pressure), *vel]
    ip += [n for shp in shapes for n in shp]
    fp = [0.5 * rho * dy, 0.5 * rho * dx, mu * dy / dx, mu * dx / dy, dx, dy,
          cfg.alpha_u, 1.0 - cfg.alpha_u, rho, cfg.alpha_p, mom_cfg.tolerance,
          pres_cfg.tolerance, pres_cfg.omega]
    fp += [s.u for s in sides] + [s.v for s in sides]
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * len(fp))(*fp)
    _cuda.check(_cuda.library().nf_fused_simple_step(c_ptrs, c_ip, c_fp, _cuda.stream_of(u)),
                "fused_outer_step")
    LAUNCHES += 1
    u2, v2, p2, r_u, r_v, r_p, sc, cyc = outs
    return u2, v2, p2, tuple(sc[k] for k in range(4)), cyc[0], r_u, r_v, r_p


def fused_simple_step(u, v, p, p_max_l2, *, dx, dy, rho, mu, bc, simple_cfg, mom_cfg,
                      pres_cfg):
    """One SIMPLE outer iteration as one kernel launch.  Returns ``(u', v',
    p', p_max', u_norm, v_norm, p_rel, cycles, r_u, r_v, r_p)``, the step
    contract of ``make_simple_step``."""
    u2, v2, p2, (p_max2, u_norm, v_norm, p_rel), cycles, r_u, r_v, r_p = fused_outer_step(
        "simple", u, v, p, (p_max_l2,), dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
        cfg=simple_cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    return u2, v2, p2, p_max2, u_norm, v_norm, p_rel, cycles, r_u, r_v, r_p
