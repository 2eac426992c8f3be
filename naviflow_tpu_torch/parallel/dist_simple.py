"""Distributed SIMPLE / SIMPLEC / PISO on a 2-D mesh of ranks with explicit
halo exchange (port of ``naviflow_tpu/parallel/dist_simple.py``).

Every piece of the single-device step has a block-local counterpart here:

=====================  =======================================
single-device          distributed (this module)
=====================  =======================================
apply_velocity_bcs     apply_velocity_bcs_window (global masks)
u/v coefficient ops    ops/windowed.py on halo-extended blocks
Jacobi momentum sweep  masked sweep + per-sweep halo exchange
pressure RBGS / CG     global-parity sweeps / all-reduced dots
velocity correction    masked update with p' halo
residual norms         all-reduces, duplicated faces counted once
=====================  =======================================

Each rank runs the same Python on its own block.  Every loop decision (a
Krylov loop's condition, RBGS's tolerance, SIMPLEC's backoff, the outer
loop's stop) comes from an all-reduced value, which every rank holds bit
for bit, so no rank leaves a collective early.  In eager PyTorch each
Krylov iteration reads its condition on the host: on the card this path is
host-bound by design.  No CUDA kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.bc import BoundaryConditions, apply_velocity_bcs_window
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.highorder import _OFFSETS, MomentumCoeffs9, relax_coefficients9
from ..ops.powerlaw import relax_coefficients
from ..ops.stencil import StencilCoeffs
from ..ops.stencil9 import Stencil9, from_poisson
from ..ops.windowed import (
    global_indices,
    poisson_coefficients_window,
    u_coefficients9_window,
    u_coefficients_window,
    v_coefficients9_window,
    v_coefficients_window,
)
from ..solvers.multigrid import MultigridConfig
from .decompose import (
    Decomp,
    apply_stencil_halo,
    block,
    extend_p,
    extend_p2,
    extend_u,
    extend_u2,
    extend_v,
    extend_v2,
    from_blocked_u,
    from_blocked_v,
    gather_blocks,
    neighbor_sum_halo,
    pmax,
    pnorm2,
    psum,
    to_blocked_p,
    to_blocked_u,
    to_blocked_v,
)
from .dist_mg import apply9_halo, dist_mg_solve, make_dist_mg_preconditioner
from .sharding import RankMesh


def neighbor_sum9_halo(x_loc, c: MomentumCoeffs9, extend2_fn, dec: Decomp, rm):
    """sum(a_nb * x_nb) on a local block with two halo rings."""
    x = extend2_fn(x_loc, dec, rm)
    a, b = x_loc.shape
    out = torch.zeros_like(x_loc)
    for name, (di, dj) in _OFFSETS.items():
        out = out + getattr(c, name) * x[2 + di: 2 + di + a, 2 + dj: 2 + dj + b]
    return out


def apply_momentum9_halo(x_loc, c: MomentumCoeffs9, extend2_fn, dec: Decomp, rm):
    return c.a_p * x_loc - neighbor_sum9_halo(x_loc, c, extend2_fn, dec, rm)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Solver knobs of the distributed step (the JAX package's fields and
    defaults): Jacobi-sweep, Chebyshev or BiCGSTAB momentum; RBGS,
    (Chebyshev-/Jacobi-)PCG, distributed-MG-PCG, MG or FMG pressure;
    power-law or QUICK / LUDS discretization."""

    alpha_p: float = 0.3
    alpha_u: float = 0.7
    max_iterations: int = 1000
    tolerance: float = 1e-5
    # outer coupling: 'simple' | 'simplec' | 'piso'.  SIMPLEC: consistent
    # d-coefficients d/alpha_u, max-abs field-change residuals, dynamic
    # alpha_p backoff (a replicated aux scalar).  PISO: n_corrections
    # pressure passes with gentle Jacobi momentum re-solves between them
    algorithm: str = "simple"
    n_corrections: int = 2
    corrector_sweeps: int = 1
    dynamic_alpha_p: bool = True
    # 'jacobi' | 'bicgstab' (dots weighted to count duplicated shared faces
    # once) | 'chebyshev' (one all-reduced max a solve for the Gershgorin
    # bound, reduction-free iterations)
    momentum_solver: str = "jacobi"
    momentum_sweeps: int = 2
    momentum_tol: float = 1e-6
    momentum_max_iter: int = 20
    momentum_degree: int = 6
    # 'power_law' (5-pt, 1-ring halos) or 'quick' / 'luds' (9-pt, 2-ring)
    scheme: str = "power_law"
    # 'chebcg' | 'cg' | 'rbgs' | 'mgcg' | 'mg' | 'fmg'
    pressure_solver: str = "chebcg"
    pressure_tol: float = 1e-6
    pressure_max_iter: int = 2000
    rbgs_omega: float = 1.5
    cheby_degree: int = 8
    cheby_theta: float = 30.0
    check_every: int = 10
    # 'mgcg' / 'mg' / 'fmg': global level size below which the distributed
    # hierarchy is gathered to every rank (parallel/dist_mg.py)
    gather_cutoff: int = 32


def _cheby_mom_dist(x0, c, apply_fn, mask, degree, rm, margin=1.05):
    """Distributed fixed-degree Chebyshev momentum predictor: the
    Gershgorin radius is ONE all-reduced max a solve (the max over
    duplicated faces is duplication-safe) and the ``degree`` iterations are
    reduction-free.  Every rank computes the same interval scalars, so the
    duplicated shared-face copies stay bit-consistent."""
    dt = x0.dtype
    mask_f = mask.to(dt)
    safe_ap = torch.where(c.a_p == 0, torch.ones_like(c.a_p), c.a_p)
    if isinstance(c, MomentumCoeffs9):
        nb_abs = sum(torch.abs(getattr(c, name)) for name in _OFFSETS)
    else:
        nb_abs = torch.abs(c.a_e) + torch.abs(c.a_w) + torch.abs(c.a_n) + torch.abs(c.a_s)
    ratio = torch.where(mask, nb_abs / safe_ap, torch.zeros_like(nb_abs))
    rho = pmax(torch.max(ratio), rm)
    rho = torch.clamp(rho * margin, max=0.999)
    # the expressions of solvers/momentum._bounds_from_rho
    lmin = 1.0 - rho
    lmax = 1.0 + rho
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    inv_d = mask_f / safe_ap

    def A(x):
        return apply_fn(x) * mask_f

    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    d = (r * inv_d) / theta
    x = x + d
    rho_k = 1.0 / sigma1
    for _ in range(degree - 1):
        r = b - A(x)
        rho_next = 1.0 / (2.0 * sigma1 - rho_k)
        d = (rho_next * rho_k) * d + (2.0 * rho_next / delta) * (r * inv_d)
        x = x + d
        rho_k = rho_next
    return torch.where(mask, x, x0)


def _bicgstab_mom_dist(x0, src, apply_fn, mask, own, tol, maxiter, rm):
    """Distributed masked BiCGSTAB momentum predictor: the arithmetic of
    ``solvers/momentum._bicgstab_masked`` with the matvec halo-exchanged and
    every dot all-reduced, weighted by ``mask & own`` so duplicated shared
    faces count once.  Dots needed together share one all-reduce; the loop
    condition is one host read of an all-reduced flag.  Returns the
    solution and the iteration count."""
    dt = x0.dtype
    mask_f = mask.to(dt)
    dotw = (mask & own).to(dt)

    def pd(*pairs):
        return psum(torch.stack([torch.sum(a * b * dotw) for a, b in pairs]), rm)

    def A(x):
        return apply_fn(x) * mask_f

    b = src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    rhat = r
    one = torch.ones((), dtype=dt, device=x0.device)
    rho = alpha = omega_ = one
    v = p = torch.zeros_like(x0)
    tol2 = (tol * torch.clamp(torch.sqrt(pd((b, b))[0]), min=1e-30)) ** 2
    eps = torch.finfo(dt).tiny * 1e6
    ok = torch.ones((), dtype=torch.bool, device=x0.device)
    k = 0
    while k < maxiter:
        rr, rho_new = pd((r, r), (rhat, r)).unbind()
        if not bool(ok & (rr > tol2)):
            break
        good = (torch.abs(rho) > eps) & (torch.abs(omega_) > eps)
        beta = torch.where(good, (rho_new / torch.where(rho == 0, one, rho))
                           * (alpha / torch.where(omega_ == 0, one, omega_)), 0.0 * one)
        p = r + beta * (p - omega_ * v)
        v = A(p)
        denom = pd((rhat, v))[0]
        good = good & (torch.abs(denom) > eps)
        alpha = torch.where(good, rho_new / torch.where(denom == 0, one, denom), 0.0 * one)
        s = r - alpha * v
        t = A(s)
        tt, ts = pd((t, t), (t, s)).unbind()
        omega_ = torch.where(tt > eps, ts / torch.where(tt == 0, one, tt), 0.0 * one)
        x = x + alpha * p + omega_ * s
        r = s - omega_ * t
        rho, ok = rho_new, good
        k += 1
    return torch.where(mask, x, x0), k


def _make_local_step(dec: Decomp, rm: RankMesh, bc: BoundaryConditions,
                     cfg: DistributedConfig, *, dx, dy, rho, mu):
    """This rank's outer-iteration body ``(u, v, p, aux) -> (u, v, p, aux,
    total, inner)`` for ``cfg.algorithm`` (SIMPLE / SIMPLEC / PISO);
    ``inner`` is the step's pressure iterations (Python int).  ``aux`` is a
    (possibly empty) tuple of replicated scalars carried across steps:
    SIMPLEC's ``(alpha_p, prev_residual)`` (:func:`aux_init`)."""
    nx, ny = dec.nx, dec.ny
    nxl, nyl = dec.nxl, dec.nyl
    gi0, gj0 = rm.bx * nxl, rm.by * nyl

    def assemble(u, v, p, alpha):
        """Window-form assembly + relaxation fold; the unrelaxed and relaxed
        coefficient sets and the stencil closures."""
        if cfg.scheme == "power_law":
            u_ext, v_ext, p_ext = extend_u(u, dec, rm), extend_v(v, dec, rm), extend_p(p, dec, rm)
            kw = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny, dx=dx, dy=dy, rho=rho, mu=mu)
            cu = u_coefficients_window(u_ext, v_ext, p_ext, **kw)
            cv = v_coefficients_window(u_ext, v_ext, p_ext, **kw)
            cur, cvr = relax_coefficients(cu, u, alpha), relax_coefficients(cv, v, alpha)

            def nbsum_u(x, c):
                return neighbor_sum_halo(x, c, extend_u, dec, rm)

            def nbsum_v(x, c):
                return neighbor_sum_halo(x, c, extend_v, dec, rm)

            def apply_u(x, c):
                return apply_stencil_halo(x, c, extend_u, dec, rm)

            def apply_v(x, c):
                return apply_stencil_halo(x, c, extend_v, dec, rm)
        else:  # QUICK / LUDS: 9-point stencils, two halo rings
            u2, v2, p2 = extend_u2(u, dec, rm), extend_v2(v, dec, rm), extend_p2(p, dec, rm)
            kw = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny, dx=dx, dy=dy, rho=rho, mu=mu,
                      scheme=cfg.scheme)
            cu = u_coefficients9_window(u2, v2, p2, **kw)
            cv = v_coefficients9_window(u2, v2, p2, **kw)
            cur, cvr = relax_coefficients9(cu, u, alpha), relax_coefficients9(cv, v, alpha)

            def nbsum_u(x, c):
                return neighbor_sum9_halo(x, c, extend_u2, dec, rm)

            def nbsum_v(x, c):
                return neighbor_sum9_halo(x, c, extend_v2, dec, rm)

            def apply_u(x, c):
                return apply_momentum9_halo(x, c, extend_u2, dec, rm)

            def apply_v(x, c):
                return apply_momentum9_halo(x, c, extend_v2, dec, rm)
        return cu, cv, cur, cvr, (nbsum_u, nbsum_v, apply_u, apply_v)

    def interior_masks(u, v):
        GIu, GJu = global_indices(u.shape, gi0, gj0, u.device)
        GIv, GJv = global_indices(v.shape, gi0, gj0, v.device)
        mask_u = (GIu >= 1) & (GIu <= nx - 1) & (GJu >= 1) & (GJu <= ny - 2)
        mask_v = (GIv >= 1) & (GIv <= nx - 2) & (GJv >= 1) & (GJv <= ny - 1)
        return mask_u, mask_v

    def bcs(u, v):
        return apply_velocity_bcs_window(u, v, bc, gi0=gi0, gj0=gj0, nx=nx, ny=ny)

    def solve_momentum(u, v, cur, cvr, ops, masks, *, sweeps, kind):
        """Masked momentum solve on the (already relaxed) systems."""
        nbsum_u, nbsum_v, apply_u, apply_v = ops
        mask_u, mask_v = masks
        if kind == "chebyshev":
            u_star = _cheby_mom_dist(u, cur, lambda x: apply_u(x, cur), mask_u,
                                     cfg.momentum_degree, rm)
            v_star = _cheby_mom_dist(v, cvr, lambda x: apply_v(x, cvr), mask_v,
                                     cfg.momentum_degree, rm)
        elif kind == "bicgstab":
            own_su = torch.arange(u.shape[0], device=u.device).view(-1, 1) < nxl
            own_sv = torch.arange(v.shape[1], device=v.device).view(1, -1) < nyl
            u_star, _ = _bicgstab_mom_dist(u, cur.src, lambda x: apply_u(x, cur), mask_u,
                                           own_su, cfg.momentum_tol, cfg.momentum_max_iter, rm)
            v_star, _ = _bicgstab_mom_dist(v, cvr.src, lambda x: apply_v(x, cvr), mask_v,
                                           own_sv, cfg.momentum_tol, cfg.momentum_max_iter, rm)
        else:
            safe_apu = torch.where(cur.a_p == 0, torch.ones_like(cur.a_p), cur.a_p)
            safe_apv = torch.where(cvr.a_p == 0, torch.ones_like(cvr.a_p), cvr.a_p)
            u_star, v_star = u, v
            for _ in range(sweeps):
                u_star = torch.where(mask_u, (nbsum_u(u_star, cur) + cur.src) / safe_apu, u_star)
            for _ in range(sweeps):
                v_star = torch.where(mask_v, (nbsum_v(v_star, cvr) + cvr.src) / safe_apv, v_star)
        return bcs(u_star, v_star)

    def momentum_norms(u_star, v_star, cu, cv, ops, masks):
        """Unrelaxed residual norms (interior, duplicated faces once): one
        all-reduce for both."""
        _, _, apply_u, apply_v = ops
        mask_u, mask_v = masks
        own_u = torch.arange(u_star.shape[0], device=u_star.device).view(-1, 1) < nxl
        own_v = torch.arange(v_star.shape[1], device=v_star.device).view(1, -1) < nyl
        r_u = torch.where(mask_u & own_u, cu.src - apply_u(u_star, cu), 0.0)
        r_v = torch.where(mask_v & own_v, cv.src - apply_v(v_star, cv), 0.0)
        return torch.sqrt(psum(torch.stack([torch.sum(r_u * r_u), torch.sum(r_v * r_v)]),
                               rm)).unbind()

    def pressure_correct(u_star, v_star, d_u, d_v):
        b = rho * ((u_star[:-1, :] - u_star[1:, :]) * dy + (v_star[:, :-1] - v_star[:, 1:]) * dx)
        pc = poisson_coefficients_window(d_u, d_v, gi0=gi0, gj0=gj0, nx=nx, ny=ny, dx=dx,
                                         dy=dy, rho=rho, variant="consistent")
        return _solve_pressure_local(b, pc, dec, rm, cfg)

    def correct_velocity(u_star, v_star, p_prime, d_u, d_v, masks):
        mask_u, mask_v = masks
        pp_ext = extend_p(p_prime, dec, rm)
        grad_u = pp_ext[:-1, 1:-1] - pp_ext[1:, 1:-1]  # p'[I-1] - p'[I]
        u_new = torch.where(mask_u, u_star + d_u * grad_u, u_star)
        grad_v = pp_ext[1:-1, :-1] - pp_ext[1:-1, 1:]  # p'[J-1] - p'[J]
        v_new = torch.where(mask_v, v_star + d_v * grad_v, v_star)
        return bcs(u_new, v_new)

    def d_coeff(ap_u, ap_v):
        d_u = torch.where(torch.abs(ap_u) > 1e-12, dy / ap_u, torch.zeros_like(ap_u))
        d_v = torch.where(torch.abs(ap_v) > 1e-12, dx / ap_v, torch.zeros_like(ap_v))
        return d_u, d_v

    def predictor(u, v, p):
        u, v = bcs(u, v)
        cu, cv, cur, cvr, ops = assemble(u, v, p, cfg.alpha_u)
        masks = interior_masks(u, v)
        u_star, v_star = solve_momentum(u, v, cur, cvr, ops, masks, sweeps=cfg.momentum_sweeps,
                                        kind=cfg.momentum_solver)
        return u, v, cu, cv, cur, cvr, ops, masks, u_star, v_star

    def simple_step(u, v, p, aux):
        _, _, cu, cv, cur, cvr, ops, masks, u_star, v_star = predictor(u, v, p)
        d_u, d_v = d_coeff(cur.a_p, cvr.a_p)
        u_norm, v_norm = momentum_norms(u_star, v_star, cu, cv, ops, masks)
        p_prime, _, inner = pressure_correct(u_star, v_star, d_u, d_v)
        p_new = p + cfg.alpha_p * p_prime
        u_new, v_new = correct_velocity(u_star, v_star, p_prime, d_u, d_v, masks)
        return u_new, v_new, p_new, aux, torch.maximum(u_norm, v_norm), inner

    def simplec_step(u, v, p, aux):
        """SIMPLEC (``algorithms/simplec.py``): consistent d-coefficients
        ``d/alpha_u`` in the pressure and the correction, max-abs field-change
        residuals, dynamic alpha_p backoff through the aux carry."""
        alpha_p, prev_res = aux
        u, v, cu, cv, cur, cvr, ops, masks, u_star, v_star = predictor(u, v, p)
        d_u, d_v = d_coeff(cur.a_p, cvr.a_p)
        d_u_c, d_v_c = d_u / cfg.alpha_u, d_v / cfg.alpha_u
        p_prime, _, inner = pressure_correct(u_star, v_star, d_u_c, d_v_c)
        p_new = p + alpha_p * p_prime
        u_new, v_new = correct_velocity(u_star, v_star, p_prime, d_u_c, d_v_c, masks)
        # max-abs field changes (the max is insensitive to duplicated faces)
        u_res, v_res = pmax(torch.stack([torch.max(torch.abs(u_new - u)),
                                         torch.max(torch.abs(v_new - v))]), rm).unbind()
        total = torch.maximum(u_res, v_res)
        if cfg.dynamic_alpha_p:
            alpha_p = torch.where(total > prev_res, alpha_p * 0.95, alpha_p)
        return u_new, v_new, p_new, (alpha_p, total), total, inner

    def piso_step(u, v, p, aux):
        """PISO (``algorithms/piso.py``): relaxed predictor, then
        ``n_corrections`` pressure passes with a ``corrector_sweeps``-Jacobi
        unrelaxed momentum re-solve between corrections."""
        u, v, cu, cv, cur, cvr, ops, masks, u_star, v_star = predictor(u, v, p)
        d_u, d_v = d_coeff(cur.a_p, cvr.a_p)
        u_norm, v_norm = momentum_norms(u_star, v_star, cu, cv, ops, masks)
        inner = 0
        for k in range(cfg.n_corrections):
            p_prime, _, its = pressure_correct(u_star, v_star, d_u, d_v)
            inner += its
            p = p + cfg.alpha_p * p_prime
            u, v = correct_velocity(u_star, v_star, p_prime, d_u, d_v, masks)
            u_star, v_star = u, v
            if k < cfg.n_corrections - 1:
                # unrelaxed (alpha=1) re-solve with the updated pressure
                _, _, cur2, cvr2, _ = assemble(u, v, p, 1.0)
                u_star, v_star = solve_momentum(u, v, cur2, cvr2, ops, masks,
                                                sweeps=cfg.corrector_sweeps, kind="jacobi")
                d_u, d_v = d_coeff(cur2.a_p, cvr2.a_p)
        return u_star, v_star, p, aux, torch.maximum(u_norm, v_norm), inner

    steps = {"simple": simple_step, "simplec": simplec_step, "piso": piso_step}
    if cfg.algorithm not in steps:
        raise ValueError(f"Unknown distributed algorithm: {cfg.algorithm}")
    return steps[cfg.algorithm]


def aux_init(cfg: DistributedConfig, dtype=torch.float32, device="cpu"):
    """The initial replicated aux carry of ``cfg.algorithm``."""
    if cfg.algorithm == "simplec":
        return (torch.full((), cfg.alpha_p, dtype=dtype, device=device),
                torch.full((), float("inf"), dtype=dtype, device=device))
    return ()


def make_distributed_step(rank_mesh: RankMesh, dec: Decomp, bc: BoundaryConditions,
                          cfg: DistributedConfig, *, dx, dy, rho, mu):
    """``step(u, v, p, *aux) -> (u, v, p, *aux, total, inner)`` on this
    rank's blocks (``aux`` is empty for SIMPLE / PISO, SIMPLEC's two
    replicated scalars otherwise -- :func:`aux_init`; ``inner`` is the
    step's pressure iterations)."""
    local_step = _make_local_step(dec, rank_mesh, bc, cfg, dx=dx, dy=dy, rho=rho, mu=mu)

    def step(u, v, p, *aux):
        u, v, p, aux, tot, inner = local_step(u, v, p, tuple(aux))
        return (u, v, p) + tuple(aux) + (tot, inner)

    return step


def make_distributed_multistep(rank_mesh: RankMesh, dec: Decomp, bc: BoundaryConditions,
                               cfg: DistributedConfig, n_steps: int, *, dx, dy, rho, mu):
    """``n_steps`` steps with no host read of their residuals:
    ``multi(u, v, p, *aux) -> (u, v, p, *aux, totals, inners)``, ``totals``
    the (n_steps,) tensor of the steps' residuals and ``inners`` their
    pressure iterations (the distributed counterpart of the chunked loop;
    the caller reads the last total once a chunk)."""
    local_step = _make_local_step(dec, rank_mesh, bc, cfg, dx=dx, dy=dy, rho=rho, mu=mu)

    def multi(u, v, p, *aux):
        aux, totals, inners = tuple(aux), [], []
        for _ in range(n_steps):
            u, v, p, aux, tot, inner = local_step(u, v, p, aux)
            totals.append(tot)
            inners.append(inner)
        return (u, v, p) + tuple(aux) + (torch.stack(totals), inners)

    return multi


def _pcg_dist(A, M, b, n_cells, tol, max_iter, rm, real=None):
    """Flexible preconditioned CG with all-reduced dots: the shared body of
    the Jacobi / Chebyshev-PC and distributed-MG-PC pressure solves.
    Polak-Ribière beta; a non-SPD ``pAp`` stops the iteration with the
    current iterate; the blow-up guard stops it when the iterated residual
    grows far beyond the initial one, and a final true residual worse than
    the zero guess's gives the zero correction.  Dots needed together share
    one all-reduce (two a iteration).  Returns the zero-mean solution, its
    residual field and the iteration count.

    ``real``: optional padded-grid mask (1 on real cells); the caller masks
    ``A`` and ``b``, so here only the mean shift is restricted to real
    cells."""
    def zero_mean(x, s):
        return x - s / n_cells if real is None else (x - s / n_cells) * real

    bb, bsum = psum(torch.stack([torch.sum(b * b), torch.sum(b)]), rm).unbind()
    bnorm = torch.sqrt(bb)
    safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    tol_abs = tol * safe_b
    eps = torch.finfo(b.dtype).tiny * 1e6
    blow = 1e3 * safe_b

    b0 = zero_mean(b, bsum)
    x = torch.zeros_like(b)
    r = b0
    z = M(r)
    pvec = z
    rz, rr = psum(torch.stack([torch.sum(r * z), torch.sum(r * r)]), rm).unbind()
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter:
        rn = torch.sqrt(rr)
        if not bool(ok & (rn > tol_abs) & (rn < blow)):
            break
        Ap = A(pvec)
        pAp, pp = psum(torch.stack([torch.sum(pvec * Ap), torch.sum(pvec * pvec)]), rm).unbind()
        good = pAp > eps * pp
        alpha = torch.where(good, rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp),
                            torch.zeros_like(pAp))
        x = x + alpha * pvec
        r_new = r - alpha * Ap
        z_new = M(r_new)
        rz_new, num, rr = psum(torch.stack([torch.sum(r_new * z_new),
                                            torch.sum((r_new - r) * z_new),
                                            torch.sum(r_new * r_new)]), rm).unbind()
        beta = torch.where(torch.abs(rz) > eps,
                           num / torch.where(rz == 0, torch.ones_like(rz), rz),
                           torch.zeros_like(rz))
        pvec = z_new + beta * pvec
        r, z, rz, ok = r_new, z_new, rz_new, good
        k += 1
    r_true = pnorm2(b0 - A(x), rm)
    x = torch.where(r_true < safe_b, x, torch.zeros_like(x))
    p = zero_mean(x, psum(torch.sum(x), rm))
    return p, b - A(p), k


def _pc_as_stencil(pc):
    return StencilCoeffs(a_e=pc.a_e, a_w=pc.a_w, a_n=pc.a_n, a_s=pc.a_s, a_p=pc.diag,
                         src=torch.zeros_like(pc.diag))


def _mg_config(cycle_type="v") -> MultigridConfig:
    return MultigridConfig(pre_smoothing=2, post_smoothing=2, coarsest_sweeps=32,
                           smoother="gs", cycle_type=cycle_type)


def _masked_stencil(pc, real) -> Stencil9:
    st = from_poisson(pc)
    if real is None:
        return st
    return Stencil9(*(getattr(st, f.name) * real for f in dataclasses.fields(Stencil9)))


def _solve_pressure_local(b, pc, dec: Decomp, rm: RankMesh, cfg: DistributedConfig):
    """Distributed pressure solve on this rank's block.  Returns (p',
    residual, iterations).

    On padded (non-divisible) grids the system is masked to the real cells:
    ``b`` and every operator row are zeroed on padding, so the iterations
    run on the real subsystem and padded cells stay exactly zero.  The
    multigrid solvers run on the padded tiling with the fine stencil's
    padded rows zeroed."""
    n_cells = dec.nx * dec.ny
    gi0, gj0 = rm.bx * dec.nxl, rm.by * dec.nyl

    real = None
    if dec.padded:
        GI, GJ = global_indices(b.shape, gi0, gj0, b.device)
        real = ((GI < dec.nx) & (GJ < dec.ny)).to(b.dtype)
        b = b * real

    st5 = _pc_as_stencil(pc)

    def A(x):
        y = apply_stencil_halo(x, st5, extend_p, dec, rm)
        return y if real is None else y * real

    kind = cfg.pressure_solver
    if kind in ("mgcg", "mg", "fmg"):
        dec_mg = dec if real is None else Decomp(nx=dec.nxp, ny=dec.nyp, mx=dec.mx, my=dec.my)
        st = _masked_stencil(pc, real)
        if kind == "mgcg":
            M = make_dist_mg_preconditioner(st, dec_mg, rm, _mg_config(),
                                            gather_cutoff=cfg.gather_cutoff)
            return _pcg_dist(lambda x: apply9_halo(x, st, dec_mg, rm), M, b, n_cells,
                             cfg.pressure_tol, cfg.pressure_max_iter, rm, real=real)
        return dist_mg_solve(b, st, dec_mg, rm, _mg_config("fmg" if kind == "fmg" else "v"),
                             tol=cfg.pressure_tol, max_cycles=cfg.pressure_max_iter,
                             gather_cutoff=cfg.gather_cutoff, real=real, n_cells=n_cells)

    inv_d = 1.0 / torch.where(pc.diag < 1e-15, torch.ones_like(pc.diag), pc.diag)
    if kind == "rbgs":
        bnorm = pnorm2(b, rm)
        safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
        GI, GJ = global_indices(b.shape, gi0, gj0, b.device)
        red = (GI + GJ) % 2 == 0
        black = torch.logical_not(red)
        if real is not None:
            red = red & (real > 0)
            black = black & (real > 0)

        def half(p, color):
            nb = neighbor_sum_halo(p, st5, extend_p, dec, rm)
            p_new = (b + nb) * inv_d
            return torch.where(color, p + cfg.rbgs_omega * (p_new - p), p)

        p = torch.zeros_like(b)
        k, rel = 0, float("inf")
        while k < cfg.pressure_max_iter and rel >= cfg.pressure_tol:
            p = half(half(p, red), black)
            rel = float(pnorm2(b - A(p), rm) / safe_b)
            k += 1
        s = psum(torch.sum(p), rm)
        p = p - s / n_cells if real is None else (p - s / n_cells) * real
        return p, b - A(p), k

    if kind == "chebcg":
        # distributed power iteration for lambda_max(D^-1 A)
        GI, GJ = global_indices(b.shape, gi0, gj0, b.device)
        x = torch.sin(GI.to(b.dtype) * 0.7 + 1.0) * torch.cos(GJ.to(b.dtype) * 1.3 + 0.5)
        lam_max = torch.ones((), dtype=b.dtype, device=b.device)
        for _ in range(20):
            y = inv_d * A(x)
            lam_max = torch.sqrt(psum(torch.sum(y * y), rm))
            x = y / torch.clamp(lam_max, min=1e-30)
        lmax = 1.05 * lam_max
        lmin = lam_max / cfg.cheby_theta
        dd = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = dd / delta

        def M(r0):
            r = inv_d * r0
            z = r / dd
            p_ = torch.zeros_like(r0)
            rho_k = 1.0 / sigma
            for _ in range(cfg.cheby_degree - 1):
                p_ = p_ + z
                r = inv_d * (r0 - A(p_))
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                z = rho_next * rho_k * z + (2.0 * rho_next / delta) * r
                rho_k = rho_next
            return p_ + z
    elif kind == "cg":
        def M(r):
            return r * inv_d
    else:
        raise ValueError(f"Unknown distributed pressure solver: {kind}")
    return _pcg_dist(A, M, b, n_cells, cfg.pressure_tol, cfg.pressure_max_iter, rm, real=real)


def distributed_simple_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    rank_mesh: RankMesh,
    cfg: DistributedConfig = DistributedConfig(),
    loop: str = "chunked",
) -> Tuple[FlowState, dict]:
    """Distributed outer solve (``cfg.algorithm``: SIMPLE / SIMPLEC / PISO),
    called by every rank of ``rank_mesh`` with the same global ``state``.

    Runs on the device ``state`` lives on (``rank_mesh.device``'s type);
    returns the final global state on every rank and a diagnostics dict
    (the JAX package's keys, plus ``step_residuals`` and
    ``inner_iterations`` per step).  Grids need not divide the mesh: the
    layout is zero-padded and the padding masked out of every update and
    reduction.

    ``loop='chunked'`` (default): ``check_every`` steps between host reads
    of the residual (the count may overshoot ``max_iterations`` to the
    chunk's end, as the JAX package's chunked loop does);
    ``loop='per-step'``: a host read after every step.
    """
    if loop not in ("chunked", "per-step"):
        raise ValueError(f"loop {loop!r}: expected 'chunked' or 'per-step'")
    dev = state.u.device
    if dev.type != rank_mesh.device.type:
        raise ValueError(f"the state is on {dev}, the rank mesh on {rank_mesh.device}")
    mx, my = rank_mesh.shape
    dec = Decomp(nx=mesh.nx, ny=mesh.ny, mx=mx, my=my)
    dx, dy = mesh.get_cell_sizes()
    common = dict(dx=dx, dy=dy, rho=fluid.get_density(), mu=fluid.get_viscosity())
    aux = aux_init(cfg, state.p.dtype, dev)

    u = block(to_blocked_u(state.u, mx, my), rank_mesh)
    v = block(to_blocked_v(state.v, my, mx), rank_mesh)
    p = block(to_blocked_p(state.p, mx, my), rank_mesh)

    history, step_res, inner_its = [], [], []
    total = float("inf")
    it = 0
    if loop == "chunked":
        chunk = max(1, min(cfg.check_every, cfg.max_iterations))
        multi = make_distributed_multistep(rank_mesh, dec, bc, cfg, chunk, **common)
        while it < cfg.max_iterations and total > cfg.tolerance:
            u, v, p, *rest = multi(u, v, p, *aux)
            aux, totals, inners = tuple(rest[:-2]), rest[-2], rest[-1]
            it += chunk
            step_res += totals.tolist()
            inner_its += inners
            total = step_res[-1]
            history.append(total)
    else:
        step = make_distributed_step(rank_mesh, dec, bc, cfg, **common)
        while it < cfg.max_iterations and total > cfg.tolerance:
            for _ in range(min(cfg.check_every, cfg.max_iterations - it)):
                u, v, p, *rest = step(u, v, p, *aux)
                aux, total_t, inner = tuple(rest[:-2]), rest[-2], rest[-1]
                step_res.append(float(total_t))
                inner_its.append(inner)
                it += 1
            total = step_res[-1]
            history.append(total)

    nx, ny = mesh.nx, mesh.ny  # crop the layout padding (no-op if divisible)
    final = FlowState(
        u=from_blocked_u(gather_blocks(u, rank_mesh), mx)[: nx + 1, :ny],
        v=from_blocked_v(gather_blocks(v, rank_mesh), my)[:nx, : ny + 1],
        p=gather_blocks(p, rank_mesh)[:nx, :ny],
    )
    diag = dict(iterations=it, converged=total <= cfg.tolerance, final_residual=total,
                residual_history=history, step_residuals=step_res,
                inner_iterations=inner_its)
    return final, diag
