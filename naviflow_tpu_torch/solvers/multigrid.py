"""Geometric multigrid for the pressure-correction equation (port of
``naviflow_tpu/solvers/multigrid.py``).

Exact Galerkin coarse operators (``ops/stencil9.galerkin_coarsen``),
red-black SOR on the 5-point finest level, four-colour GS on the 9-point
Galerkin levels; vertex-centred transfers (``ops/transfer.py``) on odd
grids, cell-centred ones (``ops/transfer_cc.py``) on even grids; V, W and
FMG cycles.

Kernel path (CUDA tensors, ``backend`` 'auto' or 'kernel'):
* the coarse hierarchy of an odd grid comes from one launch of K4
  (``ops/mg.galerkin_levels``) from the first level its gate admits; the
  levels above it are coarsened composed;
* a solve whose whole hierarchy the fused gate admits is one launch of K5
  (``ops/mg.fused_mg_solve``: cycles, checks, mean normalisation and the
  residual), after the composed FMG bootstrap where ``cycle_type='fmg'``;
* otherwise each cycle is one launch of K3 (``ops/mg.fused_vcycle``) where
  the whole hierarchy fits, else the fine levels too big for it are peeled
  (each qualifying one as a K2 ``strip_down``/``strip_up`` pair) and the
  first tail K3 admits runs as one launch.  At a 1024^2 grid that is levels
  0 and 1 as strips and 256^2 -> 4^2 as K3.

Not yet ported (each raises :class:`NotImplementedError`): rediscretized
coarsening, cubic prolongation, the Jacobi, Chebyshev and bfloat16
smoothers (ROADMAP §1 item 10), and the colour-plane fine layout
(``ops/plane.py`` and K10, ROADMAP §2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import _cuda
from ..ops.mg import (fused_mg_solve, fused_vcycle, galerkin_levels, supports_fused,
                      supports_fused_rap)
from ..ops.poisson import poisson_coefficients
from ..ops.stencil import index_grids
from ..ops.stencil9 import (
    Stencil9,
    apply5,
    apply_five,
    from_poisson,
    galerkin_coarsen,
    gs4_sweep,
    stencil9_diagonal,
)
from ..ops.strip import strip_down, strip_up, supports_strip
from ..ops.transfer import coarse_size, prolong_linear, restrict_full_weighting, restrict_inject
from ..ops.transfer_cc import prolong_cc, restrict_cc
from ..ops.unported import not_ported
from .pressure import PressureSolveInfo


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Same knobs and defaults as the JAX package's ``MultigridConfig``;
    ``backend`` takes 'auto' | 'kernel' | 'composed'."""

    tolerance: float = 1e-3
    max_cycles: int = 100
    pre_smoothing: int = 2
    post_smoothing: int = 2
    cycle_type: str = "v"  # 'v' | 'w' | 'fmg'
    smoother: str = "gs"  # 'gs' ('jacobi', 'chebyshev' not ported)
    omega: float = 1.0
    cheby_degree: int = 4
    cheby_theta: float = 30.0
    coarsest_grid_size: int = 7
    coarsest_sweeps: int = 64
    restriction: str = "full_weighting"  # 'full_weighting' | 'inject'
    smoother_dtype: str = "float32"
    prolongation: str = "linear"  # 'linear' ('cubic' not ported)
    coarsening: str = "galerkin"
    check_every: int = 1
    # rebuild the coarse Galerkin operators only every K outer iterations
    # (the algorithm layer owns the carry, algorithms/lagged.py)
    coarse_rebuild_every: int = 1
    backend: str = "auto"  # 'auto' | 'kernel' | 'composed'
    fine_layout: str = "auto"  # 'auto' | 'interleaved' ('plane' not ported)
    kind: str = "multigrid"


def _kernel_path(cfg, x) -> bool:
    if cfg.backend not in ("auto", "kernel", "composed"):
        raise ValueError(f"backend {cfg.backend!r}: expected 'auto', 'kernel' or 'composed'")
    return cfg.backend != "composed" and _cuda.kernel_device(x)


def _rb2_sweep(p, b, st: Stencil9, omega: float):
    """Two-colour red-black SOR on a 5-point level (red = (i+j) even first)."""
    ii, jj = index_grids(p.shape, p.device)
    red = (ii + jj) % 2 == 0
    inv_c = 1.0 / stencil9_diagonal(st)

    def half(p, color):
        off = apply5(p, st) - st.c * p
        p_new = (b - off) * inv_c
        return torch.where(color, p + omega * (p_new - p), p)

    p = half(p, red)
    return half(p, torch.logical_not(red))


def _smooth(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    """``n`` Gauss-Seidel sweeps: red-black on 5-point levels, four-colour on
    9-point levels (float32 or float64 as the state is)."""
    if cfg.smoother != "gs" or getattr(cfg, "smoother_dtype", "float32") != "float32":
        raise NotImplementedError(
            f"smoother={cfg.smoother!r}, smoother_dtype={cfg.smoother_dtype!r}: only "
            "Gauss-Seidel in the state's dtype is ported (ROADMAP §1 item 10)")
    return _smooth_core(p, b, st, cfg, n, five_point, lam)


def _smooth_core(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    for _ in range(n):
        p = _rb2_sweep(p, b, st, cfg.omega) if five_point else gs4_sweep(p, b, st, cfg.omega)
    return p


def _restrict(r, cfg):
    if cfg.restriction == "full_weighting":
        return restrict_full_weighting(r)
    return restrict_inject(r)


def _level_transfers(nx, ny, cfg):
    """The transfers of one level by grid parity: vertex-centred on odd
    (2^k - 1) grids, cell-centred on even ones.  Returns
    ``(restrict_fn, prolong_fn, (nxc, nyc))``."""
    if nx % 2 == 1 and ny % 2 == 1:
        if cfg.prolongation != "linear":
            raise NotImplementedError(
                f"prolongation={cfg.prolongation!r}: only 'linear' is ported "
                "(ROADMAP §1 item 10)")
        return (lambda r: _restrict(r, cfg), prolong_linear,
                (coarse_size(nx), coarse_size(ny)))
    if nx % 2 == 0 and ny % 2 == 0:
        return restrict_cc, prolong_cc, (nx // 2, ny // 2)
    raise ValueError(f"mixed-parity grid ({nx}, {ny}) cannot be coarsened")


def build_levels(d_u, d_v, cfg: MultigridConfig, *, dx, dy, rho, variant):
    """List of (Stencil9, (nx, ny), five_point, lam_max) finest -> coarsest
    (``lam_max`` is None: the Chebyshev smoother is not ported)."""
    nx, ny = d_u.shape[0] - 1, d_v.shape[1] - 1
    if cfg.coarsening != "galerkin":
        raise NotImplementedError(
            f"coarsening={cfg.coarsening!r}: rediscretized coarsening is not "
            "ported yet (ROADMAP §1 item 10)")
    fine = from_poisson(
        poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=variant))
    levels = [(fine, (nx, ny), True, None)]
    shapes = [(nx, ny)]
    while min(shapes[-1]) > cfg.coarsest_grid_size:
        shapes.append(_level_transfers(*shapes[-1], cfg)[2])
    kernel = _kernel_path(cfg, d_u) and len(shapes) > 1

    def rap_ok(shp):
        return kernel and supports_fused_rap(*shp, cfg, fine.c.dtype)

    # levels too large for the one-launch RAP (K4) are coarsened composed;
    # K4 then builds the whole remaining sub-hierarchy
    st, cur = fine, 0
    while cur < len(shapes) - 1 and not rap_ok(shapes[cur]):
        rf, pf, _ = _level_transfers(*shapes[cur], cfg)
        st = galerkin_coarsen(st, rf, pf, *shapes[cur + 1])
        levels.append((st, shapes[cur + 1], False, None))
        cur += 1
    if cur < len(shapes) - 1:
        for stc, shp in zip(galerkin_levels(st, shapes[cur:], cur == 0), shapes[cur + 1:]):
            levels.append((stc, shp, False, None))
    return levels


def _cycle(p, b, levels, lvl, cfg):
    """One V/W cycle at level ``lvl``."""
    st, (nx, ny), five, lam = levels[lvl]
    if lvl == len(levels) - 1:
        return _smooth(p, b, st, cfg, cfg.coarsest_sweeps, five, lam)
    rf, pf, _ = _level_transfers(nx, ny, cfg)
    p = _smooth(p, b, st, cfg, cfg.pre_smoothing, five, lam)
    r = b - apply_five(p, st, five)
    rc = rf(r)
    ec = torch.zeros_like(rc)
    ec = _cycle(ec, rc, levels, lvl + 1, cfg)
    if cfg.cycle_type == "w" and lvl + 1 < len(levels) - 1:
        ec = _cycle(ec, rc, levels, lvl + 1, cfg)
    p = p + pf(ec)
    return _smooth(p, b, st, cfg, cfg.post_smoothing, five, lam)


def _tail_start(levels, cfg):
    """First level k >= 1 whose tail ``levels[k:]`` the fused V-cycle admits."""
    return next((k for k in range(1, len(levels))
                 if supports_fused(levels[k:], cfg)), None)


def _cycle0(p, b, levels, cfg):
    """One cycle at the finest level: the fused kernel K3 when it admits the
    whole hierarchy, else the peeled cycle with K2 strips and a K3 tail, on
    the kernel path; the composed :func:`_cycle` otherwise."""
    if _kernel_path(cfg, p):
        if supports_fused(levels, cfg):
            return fused_vcycle(p, b, levels, cfg)
        k = _tail_start(levels, cfg)
        if k is not None and cfg.cycle_type == "v":
            return _peeled_cycle(
                p, b, levels, cfg, k,
                lambda e0, rc: fused_vcycle(e0, rc, levels[k:], cfg),
                strip=True)
    return _cycle(p, b, levels, 0, cfg)


def _peeled_cycle(p, b, levels, cfg, k: int, tail_fn, strip: bool = False):
    """V-cycle with levels 0..k-1 peeled and the tail delegated to
    ``tail_fn(e0, rc)``.  With ``strip``, each peeled level the strip gate
    admits runs as one ``strip_down`` and one ``strip_up`` launch."""
    carry, bs = [], [b]
    for lvl in range(k):
        st, (nx, ny), five, lam = levels[lvl]
        x0 = p if lvl == 0 else torch.zeros_like(bs[-1])
        if strip and supports_strip(nx, ny, five, cfg, x0.dtype):
            x, rc = strip_down(x0, bs[-1], st, cfg, five)
            carry.append((x, None, st, five, lam, True))
            bs.append(rc)
        else:
            rf, pf, _ = _level_transfers(nx, ny, cfg)
            x = _smooth(x0, bs[-1], st, cfg, cfg.pre_smoothing, five, lam)
            carry.append((x, pf, st, five, lam, False))
            bs.append(rf(bs[-1] - apply_five(x, st, five)))
    ec = tail_fn(torch.zeros_like(bs[-1]), bs[-1])
    for lvl in reversed(range(k)):
        x, pf, st, five, lam, stripped = carry[lvl]
        if stripped:
            ec = strip_up(x, bs[lvl], st, ec, cfg, five)
        else:
            x = x + pf(ec)
            ec = _smooth(x, bs[lvl], st, cfg, cfg.post_smoothing, five, lam)
    return ec


def _fmg(b, levels, cfg):
    """Full-multigrid bootstrap: restrict b down the hierarchy, smooth on the
    coarsest level, then prolong and cycle level by level back up."""
    rhs = [b]
    for lvl in range(len(levels) - 1):
        rf, _, _ = _level_transfers(*levels[lvl][1], cfg)
        rhs.append(rf(rhs[-1]))
    st, _, five, lam = levels[-1]
    p = _smooth(torch.zeros_like(rhs[-1]), rhs[-1], st, cfg, cfg.coarsest_sweeps, five, lam)
    for lvl in range(len(levels) - 2, -1, -1):
        _, pf, _ = _level_transfers(*levels[lvl][1], cfg)
        p = _cycle(pf(p), rhs[lvl], levels, lvl, cfg)
    return p


def coarse_stencils(levels):
    """The carryable part of a hierarchy: the coarse-level Stencil9 tuple."""
    return tuple(st for st, _, _, _ in levels[1:])


def multigrid_solve(
    b, d_u, d_v, p0, cfg: MultigridConfig, *, dx, dy, rho, variant="consistent",
    levels=None,
) -> Tuple[torch.Tensor, PressureSolveInfo]:
    """Solve A(d_u, d_v) p = b to ``cfg.tolerance`` by repeated cycles
    (``tolerance <= 0``: exactly ``max_cycles`` cycles, no residual checks).
    Gauge-free: the correction is mean-normalized unless ``variant`` is
    'reference'.  ``levels`` optionally supplies a prebuilt hierarchy."""
    if levels is None:
        levels = build_levels(d_u, d_v, cfg, dx=dx, dy=dy, rho=rho, variant=variant)
    st_fine = levels[0][0]
    five_fine = levels[0][2]
    if cfg.cycle_type not in ("v", "w", "fmg"):
        raise ValueError(f"Unknown cycle_type: {cfg.cycle_type}")

    p_start = _fmg(b, levels, cfg) if cfg.cycle_type == "fmg" else p0

    if _kernel_path(cfg, b) and supports_fused(levels, cfg):
        # the whole cycle/check loop in one launch (K5)
        p, r, cycles, rel = fused_mg_solve(p_start, b, levels, cfg,
                                           mean_normalize=(variant != "reference"))
        return p, PressureSolveInfo(iterations=cycles, residual_field=r, rel_residual=rel)
    if getattr(cfg, "fine_layout", "auto") not in ("auto", "interleaved"):
        raise not_ported("the colour-plane fine layout (ops/plane.py, K10 plane_strip_*)",
                         "§2 K10")

    bnorm = torch.linalg.vector_norm(b)
    safe_bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    p = p_start
    if cfg.tolerance <= 0.0:
        for _ in range(cfg.max_cycles):
            p = _cycle0(p, b, levels, cfg)
        cycles, rel = cfg.max_cycles, None
    else:
        cycles = 0
        rel = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
        while cycles < cfg.max_cycles and float(rel) >= cfg.tolerance:
            for _ in range(cfg.check_every):
                p = _cycle0(p, b, levels, cfg)
            rel = torch.linalg.vector_norm(b - apply_five(p, st_fine, five_fine)) / safe_bnorm
            cycles += cfg.check_every
    if variant != "reference":
        p = p - torch.mean(p)
    r = b - apply_five(p, st_fine, five_fine)
    if rel is None:
        rel = torch.linalg.vector_norm(r) / safe_bnorm
    return p, PressureSolveInfo(iterations=cycles, residual_field=r, rel_residual=rel)
