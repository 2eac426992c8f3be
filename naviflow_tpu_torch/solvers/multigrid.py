"""Geometric multigrid for the pressure-correction equation (port of
``naviflow_tpu/solvers/multigrid.py``).

Exact Galerkin coarse operators (``ops/stencil9.galerkin_coarsen``), or
with ``coarsening='rediscretize'`` coarse 5-point operators rebuilt from
harmonically restricted d-fields; red-black SOR on 5-point levels and
four-colour GS on 9-point ones, or the damped-Jacobi or Chebyshev
smoothers, in the state's dtype or (``smoother_dtype='bfloat16'``) on the
error equation in bfloat16; vertex-centred transfers (``ops/transfer.py``,
linear or cubic prolongation) on odd grids, cell-centred ones
(``ops/transfer_cc.py``) on even grids; V, W and FMG cycles; and
:func:`precondition`, the cycles MGCG applies.

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

With ``fine_layout='plane'`` the (even, five-point) finest level is held as
its red and black colour planes for the whole solve (``ops/plane.py``): on
the kernel path each cycle's fine level is one K10 ``plane_strip_down`` and
one ``plane_strip_up`` launch (``ops/plane_strip.py``) where their gate
admits it, and the levels below run through the same ``_cycle0`` (K2 strips
and the K3 tail).  ``'auto'`` resolves to the interleaved layout, as in the
JAX package.

The kernels' gates take only Gauss-Seidel in float32 with the default
transfers: every other smoother, ``smoother_dtype`` and prolongation runs
composed, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import _cuda
from ..ops.mg import (fused_mg_solve, fused_vcycle, galerkin_levels, supports_fused,
                      supports_fused_rap)
from ..ops.plane import (PlaneStencil5, merge_planes, plane_fine_down, plane_fine_up,
                         plane_residual_norm, split_planes)
from ..ops.plane_strip import plane_strip_down, plane_strip_up, supports_plane_strip
from ..ops.poisson import poisson_coefficients
from ..ops.stencil9 import (
    Stencil9,
    apply_five,
    colour_sweeper,
    from_poisson,
    galerkin_coarsen,
    gs4_sweeper,
    jacobi9_sweep,
    red_black,
)
from ..ops.strip import strip_down, strip_up, supports_strip
from ..ops.transfer import (coarse_size, prolong_cubic, prolong_linear,
                            restrict_d_coefficients, restrict_full_weighting,
                            restrict_inject)
from ..ops.transfer_cc import prolong_cc, restrict_cc
from ..ops.while_loop import case_by_case, flatten, while_loop
from .chebyshev import chebyshev_smooth, estimate_lambda_max
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
    smoother: str = "gs"  # 'gs' (red-black / four-colour) | 'jacobi' | 'chebyshev'
    omega: float = 1.0
    cheby_degree: int = 4
    cheby_theta: float = 30.0
    coarsest_grid_size: int = 7
    coarsest_sweeps: int = 64
    restriction: str = "full_weighting"  # 'full_weighting' | 'inject'
    # 'bfloat16': the smoothing sweeps run on the float32 error equation in
    # bfloat16 (residuals, transfers and corrections stay float32)
    smoother_dtype: str = "float32"
    # correction prolongation on odd grids; 'cubic' requires
    # coarsening='rediscretize'
    prolongation: str = "linear"  # 'linear' | 'cubic'
    coarsening: str = "galerkin"  # 'galerkin' | 'rediscretize'
    check_every: int = 1
    # rebuild the coarse Galerkin operators only every K outer iterations
    # (the algorithm layer owns the carry, algorithms/lagged.py)
    coarse_rebuild_every: int = 1
    backend: str = "auto"  # 'auto' | 'kernel' | 'composed'
    # 'plane': hold the (even, five-point) finest level as red/black colour
    # planes across the whole solve; 'auto' resolves to 'interleaved' (the
    # JAX package's choice, from its TPU timings)
    fine_layout: str = "auto"  # 'auto' | 'interleaved' | 'plane'
    kind: str = "multigrid"


def _kernel_path(cfg, x) -> bool:
    if cfg.backend not in ("auto", "kernel", "composed"):
        raise ValueError(f"backend {cfg.backend!r}: expected 'auto', 'kernel' or 'composed'")
    return cfg.backend != "composed" and _cuda.kernel_device(x)


def _rb2_sweeper(b, st: Stencil9, omega: float, shape):
    """Two-colour red-black SOR on a 5-point level (red = (i+j) even first)
    as a function of the iterate (of ``shape``)."""
    return colour_sweeper(b, st, red_black(tuple(shape), st.c.device), 5, omega)


def _rb2_sweep(p, b, st: Stencil9, omega: float):
    """One sweep of :func:`_rb2_sweeper`."""
    return _rb2_sweeper(b, st, omega, p.shape)(p)


def _smooth(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    """``n`` smoothing sweeps.  With ``smoother_dtype='bfloat16'`` on a
    float32 level they run on the error equation A e = r from e = 0 in
    bfloat16 (the same affine map as n sweeps on A p = b from p), and e is
    added to p in float32."""
    if (getattr(cfg, "smoother_dtype", "float32") in ("bfloat16", "bf16")
            and p.dtype == torch.float32 and n > 0):
        r = b - apply_five(p, st, five_point)
        st16 = Stencil9(*(getattr(st, f.name).to(torch.bfloat16)
                          for f in dataclasses.fields(Stencil9)))
        e = torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        e = _smooth_core(e, r.to(torch.bfloat16), st16, cfg, n, five_point, lam)
        return p + e.to(p.dtype)
    return _smooth_core(p, b, st, cfg, n, five_point, lam)


def _smooth_core(p, b, st: Stencil9, cfg, n, five_point: bool, lam=None):
    """Red-black SOR on 5-point levels and four-colour GS on 9-point ones,
    damped Jacobi (omega capped at 0.9), or one Chebyshev application of
    degree ``max(cheby_degree, n)``."""
    if cfg.smoother == "chebyshev":
        return chebyshev_smooth(p, b, st, lam, degree=max(cfg.cheby_degree, n),
                                theta=cfg.cheby_theta)
    if n == 0:
        return p
    if cfg.smoother == "jacobi":
        def fn(q):
            return jacobi9_sweep(q, b, st, min(cfg.omega, 0.9))
    elif five_point:
        # the stencil stacked and its diagonal inverted once for the n sweeps
        fn = _rb2_sweeper(b, st, cfg.omega, p.shape)
    else:
        fn = gs4_sweeper(b, st, cfg.omega, p.shape)
    for _ in range(n):
        p = fn(p)
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
        pf = prolong_linear
        if cfg.prolongation == "cubic":
            if cfg.coarsening != "rediscretize":
                raise ValueError(
                    "prolongation='cubic' requires coarsening='rediscretize' "
                    "(its 4-wide support breaks the Galerkin comb recovery)")
            pf = prolong_cubic
        return (lambda r: _restrict(r, cfg), pf, (coarse_size(nx), coarse_size(ny)))
    if nx % 2 == 0 and ny % 2 == 0:
        return restrict_cc, prolong_cc, (nx // 2, ny // 2)
    raise ValueError(f"mixed-parity grid ({nx}, {ny}) cannot be coarsened")


def galerkin_shapes(nx, ny, cfg: MultigridConfig):
    """The level shapes of the Galerkin hierarchy of an (nx, ny) grid
    (:func:`build_levels`' shapes), finest first."""
    shapes = [(nx, ny)]
    while min(shapes[-1]) > cfg.coarsest_grid_size:
        shapes.append(_level_transfers(*shapes[-1], cfg)[2])
    return shapes


def rap_start(shapes, cfg: MultigridConfig, dtype) -> int:
    """On the kernel path, the first level of ``shapes`` (finest first) from
    which one K4 launch builds the rest of the Galerkin hierarchy, the
    levels above it coarsened composed; ``len(shapes) - 1`` where K4 takes
    none of them (every level composed)."""
    cur = 0
    while cur < len(shapes) - 1 and not supports_fused_rap(*shapes[cur], cfg, dtype):
        cur += 1
    return cur


def build_levels(d_u, d_v, cfg: MultigridConfig, *, dx, dy, rho, variant):
    """List of (Stencil9, (nx, ny), five_point, lam_max) finest -> coarsest
    (``lam_max`` only for the Chebyshev smoother, else None)."""
    nx, ny = d_u.shape[0] - 1, d_v.shape[1] - 1
    need_lam = cfg.smoother == "chebyshev"

    def lam_of(st, shape):
        return estimate_lambda_max(st, shape) if need_lam else None

    fine = from_poisson(
        poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=variant))
    levels = [(fine, (nx, ny), True, lam_of(fine, (nx, ny)))]
    if cfg.coarsening == "rediscretize":
        while min(nx, ny) > cfg.coarsest_grid_size:
            d_u, d_v = restrict_d_coefficients(d_u, d_v)
            nx, ny = coarse_size(nx), coarse_size(ny)
            dx, dy = 2 * dx, 2 * dy
            st = from_poisson(
                poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=variant))
            levels.append((st, (nx, ny), True, lam_of(st, (nx, ny))))
        return levels
    if cfg.coarsening != "galerkin":
        raise ValueError(f"Unknown coarsening: {cfg.coarsening}")
    shapes = galerkin_shapes(nx, ny, cfg)
    # levels too large for the one-launch RAP (K4) are coarsened composed;
    # K4 then builds the whole remaining sub-hierarchy
    first = (rap_start(shapes, cfg, fine.c.dtype) if _kernel_path(cfg, d_u)
             else len(shapes) - 1)
    st, cur = fine, 0
    while cur < first:
        rf, pf, _ = _level_transfers(*shapes[cur], cfg)
        st = galerkin_coarsen(st, rf, pf, *shapes[cur + 1])
        levels.append((st, shapes[cur + 1], False, lam_of(st, shapes[cur + 1])))
        cur += 1
    if cur < len(shapes) - 1:
        for stc, shp in zip(galerkin_levels(st, shapes[cur:], cur == 0), shapes[cur + 1:]):
            levels.append((stc, shp, False, lam_of(stc, shp)))
    return levels


def levels_from_stencil(st: Stencil9, nx: int, ny: int, cfg: MultigridConfig):
    """Continue Galerkin coarsening (composed) from an arbitrary 9-point
    operator: the replicated tail of the distributed multigrid
    (``parallel/dist_mg.py``), whose gathered stencil enters here as level
    0.  ``five_point`` is False throughout (Galerkin levels are 9-point);
    a mixed-parity level (a padded rectangular tail) ends the ladder."""
    need_lam = cfg.smoother == "chebyshev"

    def lam_of(s, shape):
        return estimate_lambda_max(s, shape) if need_lam else None

    levels = [(st, (nx, ny), False, lam_of(st, (nx, ny)))]
    while min(nx, ny) > cfg.coarsest_grid_size:
        if (nx % 2) != (ny % 2):
            break
        rf, pf, (nxc, nyc) = _level_transfers(nx, ny, cfg)
        st = galerkin_coarsen(st, rf, pf, nxc, nyc)
        levels.append((st, (nxc, nyc), False, lam_of(st, (nxc, nyc))))
        nx, ny = nxc, nyc
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


def cycle_tail(levels, cfg):
    """:func:`_cycle0`'s kernel path on ``levels``: 0 where K3 takes the
    whole hierarchy, the first level ``k >= 1`` of the K3 tail of a V-cycle
    whose levels above it are peeled (K2 strips where the strip gate takes
    a level, composed where it does not), or None (the composed cycle)."""
    if supports_fused(levels, cfg):
        return 0
    k = _tail_start(levels, cfg)
    return k if k is not None and cfg.cycle_type == "v" else None


def _cycle0(p, b, levels, cfg):
    """One cycle at the finest level: the fused kernel K3 when it admits the
    whole hierarchy, else the peeled cycle with K2 strips and a K3 tail, on
    the kernel path (:func:`cycle_tail`); the composed :func:`_cycle`
    otherwise."""
    if _kernel_path(cfg, p):
        k = cycle_tail(levels, cfg)
        if k == 0:
            return fused_vcycle(p, b, levels, cfg)
        if k is not None:
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
    (``tolerance <= 0``: exactly ``max_cycles`` cycles, no residual checks,
    and ``iterations`` the number; else a residual check every
    ``check_every`` cycles through ``ops/while_loop.py``, and ``iterations``
    the loop's int32 count).
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

    layout = getattr(cfg, "fine_layout", "auto")
    if layout not in ("auto", "interleaved", "plane"):
        raise ValueError(f"fine_layout {layout!r}: expected 'auto', 'interleaved' or 'plane'")
    use_plane = (
        layout == "plane"
        and five_fine and len(levels) > 1
        and cfg.cycle_type in ("v", "fmg") and cfg.smoother == "gs"
        and cfg.omega == 1.0
        and getattr(cfg, "smoother_dtype", "float32") == "float32"
        and b.shape[0] % 2 == 0 and b.shape[1] % 2 == 0
    )
    # the norms and the mean case by case under torch.func.vmap: each case
    # rounds as its single solve (ops/while_loop.case_by_case)
    bnorm = case_by_case(torch.linalg.vector_norm, b)
    safe_bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    # each cycle and check reads (b, levels, ps) through its arguments, so
    # that the tolerance loop's operands carry every tensor it reads
    if use_plane:
        # b and the stencil are split once per solve, the planes merged once
        ps = PlaneStencil5(st_fine, b)
        state = split_planes(p_start)
        plane_kernel = _kernel_path(cfg, b) and supports_plane_strip(*state[0].shape, cfg,
                                                                     b.dtype)

        def one_cycle(state, b, levels, ps):
            # the fine level in plane form (K10 on the kernel path), the
            # levels below it as an ordinary cycle on the standard layout
            R, B = state
            if plane_kernel:
                R, B, rc = plane_strip_down(R, B, ps, cfg)
                ec = _cycle0(torch.zeros_like(rc), rc, levels[1:], cfg)
                return plane_strip_up(R, B, ps, ec, cfg)
            R, B, rc = plane_fine_down(R, B, ps, cfg.pre_smoothing)
            ec = _cycle0(torch.zeros_like(rc), rc, levels[1:], cfg)
            return plane_fine_up(R, B, ps, ec, cfg.post_smoothing)

        def norm(state, b, levels, ps):
            return plane_residual_norm(*state, ps)
    else:
        ps, state = None, (p_start,)

        def one_cycle(state, b, levels, ps):
            return (_cycle0(state[0], b, levels, cfg),)

        def norm(state, b, levels, ps):
            return case_by_case(torch.linalg.vector_norm,
                                b - apply_five(state[0], levels[0][0], five_fine))

    if cfg.tolerance <= 0.0:
        for _ in range(cfg.max_cycles):
            state = one_cycle(state, b, levels, ps)
        cycles, rel = cfg.max_cycles, None
    else:
        # the JAX package's lax.while_loop over (state, cycles, rel): one
        # host read a check (one for every case under torch.func.vmap)
        consts, build = flatten((b, levels, ps, safe_bnorm))
        n = len(state)

        def cond(*ops):
            cycles, rel = ops[n:n + 2]
            return (cycles < cfg.max_cycles) & (rel.double() >= cfg.tolerance)

        def body(*ops):
            state, (cycles, _), rest = ops[:n], ops[n:n + 2], ops[n + 2:]
            b, levels, ps, safe_bnorm = build(rest)
            for _ in range(cfg.check_every):
                state = one_cycle(state, b, levels, ps)
            rel = norm(state, b, levels, ps) / safe_bnorm
            return (*state, cycles + cfg.check_every, rel, *rest)

        cycles = torch.zeros((), dtype=torch.int32, device=b.device)
        rel = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
        out = while_loop(cond, body, *state, cycles, rel, *consts)
        state, (cycles, rel) = out[:n], out[n:n + 2]
    p = merge_planes(*state) if use_plane else state[0]
    if variant != "reference":
        p = p - case_by_case(torch.mean, p)
    r = b - apply_five(p, st_fine, five_fine)
    if rel is None:
        rel = case_by_case(torch.linalg.vector_norm, r) / safe_bnorm
    return p, PressureSolveInfo(iterations=cycles, residual_field=r, rel_residual=rel)


def precondition(r, levels, cfg: MultigridConfig, n_cycles: int = 1):
    """M^{-1} r ~= ``n_cycles`` multigrid cycles from a zero guess (the
    preconditioner of MGCG), each through :func:`_cycle0`: on the kernel
    path a K3 launch, or K2 strips and a K3 tail, where the gates admit
    the hierarchy.  ``levels`` is an argument, so that a Krylov loop takes
    the hierarchy as its operand."""
    e = torch.zeros_like(r)
    for _ in range(n_cycles):
        e = _cycle0(e, r, levels, cfg)
    return e
