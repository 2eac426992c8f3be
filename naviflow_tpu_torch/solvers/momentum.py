"""Momentum predictor solvers (port of ``naviflow_tpu/solvers/momentum.py``,
main-path subset).

Each solve returns ``(star_field, d_coefficient, residual_field,
residual_norm)``: the linear system solved is the relaxed one, ``d =
spacing / a_p_relaxed``, and the residual is the unrelaxed
``r = src_un - A_un x`` with its L2 norm over interior nodes.

Ported: fixed-sweep Jacobi, fixed-degree Chebyshev and masked BiCGSTAB
inner solves on the power-law scheme, the compensated residual, and the
pair form :func:`solve_momentum_pair` with its merged kernel branch (K1,
``ops/asmcheby.py``) driven by lagged Gershgorin maxima and its batched
BiCGSTAB branch (:func:`_bicgstab_pair_masked`).  On a CUDA tensor a
BiCGSTAB solve whose field fits the reference kernel's budget is one launch
of K7 (``ops/krylov.py``).  Not yet ported (each raises
:class:`NotImplementedError`): the red-black GS, GMRES and IDR(s) inner
solves (ROADMAP §1 item 2) and the 9-point QUICK/LUDS schemes (item 11).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops import _cuda
from ..ops.asmcheby import fused_asmcheby_pair, supports_asmcheby
from ..ops.compensated import compensated_linear_combination, compensated_norm, fold_dot
from ..ops.krylov import bicgstab_momentum, supports_fused_bicgstab
from ..ops.powerlaw import (
    d_coefficient,
    relax_coefficients,
    u_momentum_coefficients,
    v_momentum_coefficients,
)
from ..ops.stencil import (StencilCoeffs, apply_stencil, interior_mask, neighbor_sum, pad2,
                           shift_e, shift_n, shift_s, shift_w)
from ..ops.unported import not_ported, supports_cheby_strips, supports_fused_assembly

BACKENDS = ("auto", "kernel", "composed")


def _apply(x, c):
    return apply_stencil(x, c)


def _nbsum(x, c):
    return neighbor_sum(x, c)


def _assemble_coeffs(u, v, p, *, dx, dy, rho, mu, scheme, is_u):
    if scheme != "power_law":
        raise NotImplementedError(
            f"momentum scheme {scheme!r}: ops/highorder.py is not ported yet "
            "(ROADMAP §1 item 11)")
    fn = u_momentum_coefficients if is_u else v_momentum_coefficients
    return fn(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu)


@dataclasses.dataclass(frozen=True)
class JacobiMomentumConfig:
    """Fixed-sweep weighted-Jacobi momentum solve."""

    n_sweeps: int = 1
    scheme: str = "power_law"
    compensated_residual: bool = False
    kind: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class ChebyshevMomentumConfig:
    """Fixed-degree Chebyshev iteration on the Jacobi-preconditioned relaxed
    momentum system (zero reductions inside the iteration; the interval
    comes from one Gershgorin max per solve, or from the previous outer
    step's maxima on the merged-kernel path)."""

    degree: int = 6
    bound_margin: float = 1.05
    scheme: str = "power_law"
    compensated_residual: bool = False
    # 'auto' / 'kernel': use the CUDA kernels where the gates admit them;
    # 'composed' forces the plain PyTorch path (parity escape hatch)
    backend: str = "auto"
    assembly_bounds: str = "auto"
    # 'auto': merge assembly + solve into one kernel (K1) on large CUDA
    # grids; 'off' keeps separate assembly and solve
    merged_assembly: str = "auto"
    kind: str = "chebyshev"


@dataclasses.dataclass(frozen=True)
class KrylovMomentumConfig:
    """Matrix-free BiCGSTAB momentum solve (Jacobi-free: the relaxed
    momentum system is strongly diagonally dominant)."""

    tolerance: float = 1e-7
    max_iterations: int = 50
    scheme: str = "power_law"
    compensated_residual: bool = False
    # compensated Krylov dots (set by the whole-step kernel's body, K6)
    compensated_dots: bool = False
    # 'auto' / 'kernel': one K7 launch per field where the reference's
    # per-field kernel budget admits it; 'composed' forces the plain path
    backend: str = "auto"
    # 'auto': batch the u and v solves into one Krylov loop where K7 does
    # not run; 'off' forces sequential solves
    batch_pair: str = "auto"
    kind: str = "bicgstab"


def _backend(cfg) -> str:
    b = getattr(cfg, "backend", "auto")
    if b not in BACKENDS:
        raise ValueError(f"backend {b!r}: expected one of {BACKENDS}")
    return b


def _u_interior_mask(shape, device=None):
    # u solved nodes: i in [1, nx-1], j in [1, ny-2]
    return interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1, device=device)


def _v_interior_mask(shape, device=None):
    return interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1, device=device)


def _jacobi_sweeps(x0, c, mask, n_sweeps: int):
    """n Jacobi sweeps on masked nodes: x_new = (sum(a_nb x_nb) + src) / a_p."""
    safe_ap = torch.where(c.a_p == 0, torch.ones_like(c.a_p), c.a_p)
    x = x0
    for _ in range(n_sweeps):
        x = torch.where(mask, (_nbsum(x, c) + c.src) / safe_ap, x)
    return x


def _bounds_from_rho(rho_raw, margin: float):
    """Chebyshev interval scalars ``(theta, delta, sigma1)`` from the raw
    masked Gershgorin ratio maximum."""
    rho = torch.clamp(rho_raw * margin, max=0.999)
    lmin = 1.0 - rho
    lmax = 1.0 + rho
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    return theta, delta, sigma1


def _chebyshev_bounds(c, mask, margin: float = 1.05):
    """Spectral interval for ``D^-1 A`` from Gershgorin: one global max."""
    safe_ap = torch.where(c.a_p == 0, torch.ones_like(c.a_p), c.a_p)
    nb_abs = (torch.abs(c.a_e) + torch.abs(c.a_w)
              + torch.abs(c.a_n) + torch.abs(c.a_s))
    ratio = torch.where(mask, nb_abs / safe_ap, torch.zeros_like(nb_abs))
    return _bounds_from_rho(torch.max(ratio), margin)


def _chebyshev_iterate(x0, c, mask, theta, delta, sigma1, degree: int):
    """``degree`` stencil applies + axpys of the three-term Chebyshev
    recurrence, given the interval scalars.  The plain version of the
    solve inside K1."""
    mask_f = mask.to(x0.dtype)
    safe_ap = torch.where(c.a_p == 0, torch.ones_like(c.a_p), c.a_p)
    inv_d = mask_f / safe_ap

    def A(x):
        return _apply(x, c) * mask_f

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


def _chebyshev_masked(x0, c, mask, degree: int, margin: float = 1.05,
                      bounds=None):
    if bounds is None:
        bounds = _chebyshev_bounds(c, mask, margin)
    theta, delta, sigma1 = bounds
    return _chebyshev_iterate(x0, c, mask, theta, delta, sigma1, degree)


def _bicgstab_masked(x0, c, mask, tol: float, maxiter: int,
                     compensated_dots: bool = False):
    """Matrix-free BiCGSTAB restricted to masked nodes (boundary nodes are
    held fixed; Practice-B folding makes the masked system self-contained).
    ``compensated_dots``: the dots and norms are :func:`fold_dot`."""
    mask_f = mask.to(x0.dtype)
    if compensated_dots:
        dot = fold_dot
    else:
        def dot(a, b):
            return torch.sum(a * b)

    def A(x):
        return _apply(x, c) * mask_f

    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    rhat = r
    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    rho = alpha = omega_ = one
    v = p = torch.zeros_like(x0)
    bnorm = torch.sqrt(dot(b, b))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    eps = torch.finfo(x0.dtype).tiny * 1e6
    k, ok = 0, True
    while ok and k < maxiter and bool(dot(r, r) > tol2):
        rho_new = dot(rhat, r)
        good = bool((torch.abs(rho) > eps) & (torch.abs(omega_) > eps))
        beta = ((rho_new / torch.where(rho == 0, one, rho))
                * (alpha / torch.where(omega_ == 0, one, omega_))) if good else 0.0 * one
        p = r + beta * (p - omega_ * v)
        v = A(p)
        denom = dot(rhat, v)
        good = good and bool(torch.abs(denom) > eps)
        alpha = rho_new / torch.where(denom == 0, one, denom) if good else 0.0 * one
        s = r - alpha * v
        t = A(s)
        tt = dot(t, t)
        omega_ = dot(t, s) / torch.where(tt == 0, one, tt) if bool(tt > eps) else 0.0 * one
        x = x + alpha * p + omega_ * s
        r = s - omega_ * t
        rho = rho_new
        k, ok = k + 1, good
    return torch.where(mask, x, x0)


def _bicgstab_pair_masked(xu0, cu, mask_u, xv0, cv, mask_v, tol: float, maxiter: int):
    """The u and v solves batched into one Krylov loop: the two systems are
    padded to one (2, M, N) stack, every dot is one reduction to a 2-vector
    and each system freezes once its own residual passes the tolerance, so
    per-system arithmetic is that of :func:`_bicgstab_masked`."""
    nxp1, ny = xu0.shape
    nx, nyp1 = xv0.shape
    M, N = max(nxp1, nx), max(ny, nyp1)

    def stack(fu, fv, fill=0.0):
        return torch.stack([pad2(fu, 0, M - fu.shape[0], 0, N - fu.shape[1], value=fill),
                            pad2(fv, 0, M - fv.shape[0], 0, N - fv.shape[1], value=fill)])

    mask = stack(mask_u.to(xu0.dtype), mask_v.to(xv0.dtype))
    a_e, a_w = stack(cu.a_e, cv.a_e), stack(cu.a_w, cv.a_w)
    a_n, a_s = stack(cu.a_n, cv.a_n), stack(cu.a_s, cv.a_s)
    a_p = stack(cu.a_p, cv.a_p, fill=1.0)
    b = stack(cu.src, cv.src) * mask
    x0 = stack(xu0, xv0)

    def sh(x, di, dj):  # x[:, i+di, j+dj], zero outside
        out = torch.zeros_like(x)
        out[:, max(-di, 0):M - max(di, 0), max(-dj, 0):N - max(dj, 0)] = \
            x[:, max(di, 0):M - max(-di, 0), max(dj, 0):N - max(-dj, 0)]
        return out

    def A(x):
        return (a_p * x - a_e * sh(x, 1, 0) - a_w * sh(x, -1, 0)
                - a_n * sh(x, 0, 1) - a_s * sh(x, 0, -1)) * mask

    def dot(a, bb):
        return torch.sum(a * bb, dim=(1, 2))

    def col(s):
        return s[:, None, None]

    x = x0 * mask
    r = b - A(x)
    rhat = r
    ones = torch.ones((2,), dtype=x0.dtype, device=x0.device)
    rho = alpha = omega_ = ones
    v = p = torch.zeros_like(x)
    bnorm = torch.sqrt(dot(b, b))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    eps = torch.finfo(x0.dtype).tiny * 1e6
    ok = torch.ones((2,), dtype=torch.bool, device=x0.device)
    k = 0
    while k < maxiter and bool(torch.any(ok & (dot(r, r) > tol2))):
        act = ok & (dot(r, r) > tol2)
        rho_new = dot(rhat, r)
        good = (torch.abs(rho) > eps) & (torch.abs(omega_) > eps)
        beta = torch.where(good, (rho_new / torch.where(rho == 0, ones, rho))
                           * (alpha / torch.where(omega_ == 0, ones, omega_)), 0.0 * ones)
        p_new = r + col(beta) * (p - col(omega_) * v)
        v_new = A(p_new)
        denom = dot(rhat, v_new)
        good = good & (torch.abs(denom) > eps)
        alpha_new = torch.where(good, rho_new / torch.where(denom == 0, ones, denom), 0.0 * ones)
        s = r - col(alpha_new) * v_new
        t = A(s)
        tt = dot(t, t)
        omega_new = torch.where(tt > eps, dot(t, s) / torch.where(tt == 0, ones, tt), 0.0 * ones)
        x_new = x + col(alpha_new) * p_new + col(omega_new) * s
        r_new = s - col(omega_new) * t
        a = col(act)
        x, r = torch.where(a, x_new, x), torch.where(a, r_new, r)
        v, p = torch.where(a, v_new, v), torch.where(a, p_new, p)
        rho = torch.where(act, rho_new, rho)
        alpha = torch.where(act, alpha_new, alpha)
        omega_ = torch.where(act, omega_new, omega_)
        ok = torch.where(act, good, ok)
        k += 1
    xu = torch.where(mask_u, x[0, :nxp1, :ny], xu0)
    xv = torch.where(mask_v, x[1, :nx, :nyp1], xv0)
    return xu, xv


def _inner_solve(x0, c_rel, mask, cfg, bounds=None):
    if cfg.kind == "jacobi":
        return _jacobi_sweeps(x0, c_rel, mask, cfg.n_sweeps)
    if cfg.kind == "chebyshev":
        return _chebyshev_masked(x0, c_rel, mask, cfg.degree,
                                 cfg.bound_margin, bounds=bounds)
    if cfg.kind == "bicgstab":
        if (_backend(cfg) != "composed" and _cuda.kernel_device(x0)
                and supports_fused_bicgstab(x0.shape, x0.dtype)):
            # the whole solve in one launch (K7), compensated dots
            return bicgstab_momentum(x0, c_rel, tol=cfg.tolerance, maxiter=cfg.max_iterations)
        return _bicgstab_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations,
                                compensated_dots=getattr(cfg, "compensated_dots", False))
    if cfg.kind in ("rbgs", "gmres", "idrs"):
        raise NotImplementedError(
            f"{cfg.kind} momentum solve is not ported yet (ROADMAP §1 item 2)")
    raise ValueError(f"Unknown momentum solver kind: {cfg.kind}")


def _unrelaxed_residual(x_star, c_un, *, is_u: bool, compensated: bool = False):
    """r = src_un - A_un x: border-zeroed field + interior L2 norm.
    ``compensated``: the residual as an error-free transformation and the
    norm with compensated accumulation (``ops/compensated.py``)."""
    if compensated:
        r, _ = compensated_linear_combination([
            c_un.src,
            (c_un.a_e, shift_e(x_star)),
            (c_un.a_w, shift_w(x_star)),
            (c_un.a_n, shift_n(x_star)),
            (c_un.a_s, shift_s(x_star)),
            (-c_un.a_p, x_star),
        ])
    else:
        r = c_un.src - _apply(x_star, c_un)
    ni, nj = r.shape
    zero = torch.zeros_like(r)
    if is_u:
        nx, ny = ni - 1, nj
        interior = r[1:nx, 1: ny - 1]
        rf = torch.where(interior_mask(r.shape, 2, 2, 1, 1, device=r.device), r, zero)
    else:
        nx, ny = ni, nj - 1
        interior = r[1: nx - 1, 1:ny]
        rf = torch.where(interior_mask(r.shape, 1, 1, 2, 2, device=r.device), r, zero)
    norm = compensated_norm(interior) if compensated else torch.linalg.vector_norm(interior)
    return rf, norm


def _refuse_cheby_strips(cfg, shape, dtype, device, c_rel):
    """K9 gate: where the reference runs its strip Chebyshev kernel, refuse."""
    if getattr(cfg, "kind", None) != "chebyshev" or _backend(cfg) == "composed":
        return
    if getattr(cfg, "compensated_residual", False) or not isinstance(c_rel, StencilCoeffs):
        return
    if supports_cheby_strips(shape, dtype, device):
        raise not_ported("K9 chebyshev_momentum_strips", "§2 K9")


def solve_u_momentum(u, v, p, *, dx, dy, rho, mu, alpha, bc: BoundaryConditions, cfg,
                     coeffs=None, gersh_rho=None, d_pre=None):
    """u-momentum predictor.  Returns (u_star, d_u, r_field, r_norm)."""
    u, v = apply_velocity_bcs(u, v, bc)
    if coeffs is not None:
        c_un, c_rel = coeffs
    else:
        c_un = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                                scheme=getattr(cfg, "scheme", "power_law"), is_u=True)
        c_rel = relax_coefficients(c_un, u, alpha)
    mask = _u_interior_mask(u.shape, device=u.device)
    d_u = d_pre if d_pre is not None else d_coefficient(c_rel.a_p, dy, is_u=True)
    bounds = (None if gersh_rho is None
              else _bounds_from_rho(gersh_rho, getattr(cfg, "bound_margin", 1.05)))
    _refuse_cheby_strips(cfg, u.shape, u.dtype, u.device, c_rel)
    u_star = _inner_solve(u, c_rel, mask, cfg, bounds=bounds)
    u_star, _ = apply_velocity_bcs(u_star, v, bc)
    r_field, r_norm = _unrelaxed_residual(
        u_star, c_un, is_u=True,
        compensated=getattr(cfg, "compensated_residual", False))
    return u_star, d_u, r_field, r_norm


def solve_v_momentum(u, v, p, *, dx, dy, rho, mu, alpha, bc: BoundaryConditions, cfg,
                     coeffs=None, gersh_rho=None, d_pre=None):
    """v-momentum predictor.  Returns (v_star, d_v, r_field, r_norm)."""
    u, v = apply_velocity_bcs(u, v, bc)
    if coeffs is not None:
        c_un, c_rel = coeffs
    else:
        c_un = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                                scheme=getattr(cfg, "scheme", "power_law"), is_u=False)
        c_rel = relax_coefficients(c_un, v, alpha)
    mask = _v_interior_mask(v.shape, device=v.device)
    d_v = d_pre if d_pre is not None else d_coefficient(c_rel.a_p, dx, is_u=False)
    bounds = (None if gersh_rho is None
              else _bounds_from_rho(gersh_rho, getattr(cfg, "bound_margin", 1.05)))
    _refuse_cheby_strips(cfg, v.shape, v.dtype, v.device, c_rel)
    v_star = _inner_solve(v, c_rel, mask, cfg, bounds=bounds)
    _, v_star = apply_velocity_bcs(u, v_star, bc)
    r_field, r_norm = _unrelaxed_residual(
        v_star, c_un, is_u=False,
        compensated=getattr(cfg, "compensated_residual", False))
    return v_star, d_v, r_field, r_norm


def asmcheby_enabled(nx, ny, cfg, scheme="power_law", dtype=torch.float32,
                     device=None) -> bool:
    """Gate for the merged assemble+solve kernel (K1, ``ops/asmcheby.py``)."""
    if getattr(cfg, "kind", None) != "chebyshev":
        return False
    if _backend(cfg) == "composed":
        return False
    if getattr(cfg, "merged_assembly", "auto") == "off":
        return False
    if getattr(cfg, "compensated_residual", False):
        return False
    if device is None:
        return False
    return supports_asmcheby(nx, ny, scheme, dtype, _backend(cfg), cfg.degree, device)


def lagged_rho_enabled(nx, ny, cfg, *, fold_poisson: bool, dtype, device) -> bool:
    """THE lagged-Gershgorin decision.  The SIMPLE loop calls it to decide
    whether its carry holds the ``(rho_u, rho_v)`` maxima, and
    :func:`solve_momentum_pair` calls it to decide whether the merged kernel
    may run; one rule, so the two cannot disagree.  The merged kernel emits
    the pressure operator, so it needs the poisson fold."""
    return fold_poisson and asmcheby_enabled(
        nx, ny, cfg, getattr(cfg, "scheme", "power_law"), dtype, device)


def solve_momentum_pair(u, v, p, *, dx, dy, rho, mu, alpha,
                        bc: BoundaryConditions, cfg,
                        poisson_variant: str | None = None,
                        lagged_rho=None):
    """Both momentum predictors.  Returns ``((u_star, d_u, r_u, u_norm),
    (v_star, d_v, r_v, v_norm))``, plus a third element (the pressure
    operator from the kernel, or ``None``: the caller builds it) when
    ``poisson_variant`` is set, plus a fourth (the fresh ``(rho_u, rho_v)``
    Gershgorin maxima) when ``lagged_rho`` is given: the previous outer
    step's maxima, which select the merged kernel K1."""
    nxp1, ny = u.shape
    scheme = getattr(cfg, "scheme", "power_law")
    if lagged_rho is not None:
        if not lagged_rho_enabled(nxp1 - 1, ny, cfg,
                                  fold_poisson=poisson_variant is not None,
                                  dtype=u.dtype, device=u.device):
            raise ValueError(
                "lagged_rho passed but lagged_rho_enabled() is False for this "
                "configuration (the merged kernel needs a CUDA float32 state, "
                "its grid gate, and the poisson fold)")
        margin = getattr(cfg, "bound_margin", 1.05)
        ub, vb = apply_velocity_bcs(u, v, bc)
        (u_star, r_u, v_star, r_v, d_u, d_v, pc,
         rho_u_new, rho_v_new) = fused_asmcheby_pair(
            ub, vb, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha,
            degree=cfg.degree,
            bounds_u=_bounds_from_rho(lagged_rho[0], margin),
            bounds_v=_bounds_from_rho(lagged_rho[1], margin),
            poisson_variant=poisson_variant)
        u_star, v_star = apply_velocity_bcs(u_star, v_star, bc)
        # the kernel's masked residual complement IS the norm region
        u_norm = torch.linalg.vector_norm(r_u)
        v_norm = torch.linalg.vector_norm(r_v)
        r_u = torch.where(interior_mask(r_u.shape, 2, 2, 1, 1, device=r_u.device),
                          r_u, torch.zeros_like(r_u))
        r_v = torch.where(interior_mask(r_v.shape, 1, 1, 2, 2, device=r_v.device),
                          r_v, torch.zeros_like(r_v))
        return ((u_star, d_u, r_u, u_norm), (v_star, d_v, r_v, v_norm),
                pc, (rho_u_new, rho_v_new))

    if supports_fused_assembly(nxp1 - 1, ny, scheme, u.dtype, _backend(cfg), u.device):
        raise not_ported("K8 fused_assembly_pair", "§2 K8")
    if _pair_krylov_applicable(cfg, u.shape, v.shape, u.dtype, scheme, u.device):
        # batched u+v BiCGSTAB: one Krylov loop for both systems
        ub, vb = apply_velocity_bcs(u, v, bc)
        kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, scheme=scheme)
        cu_un = _assemble_coeffs(ub, vb, p, is_u=True, **kw)
        cu_rel = relax_coefficients(cu_un, ub, alpha)
        cv_un = _assemble_coeffs(ub, vb, p, is_u=False, **kw)
        cv_rel = relax_coefficients(cv_un, vb, alpha)
        u_star, v_star = _bicgstab_pair_masked(
            ub, cu_rel, _u_interior_mask(ub.shape, device=ub.device),
            vb, cv_rel, _v_interior_mask(vb.shape, device=vb.device),
            cfg.tolerance, cfg.max_iterations)
        u_star, v_star = apply_velocity_bcs(u_star, v_star, bc)
        comp = getattr(cfg, "compensated_residual", False)
        r_u, u_norm = _unrelaxed_residual(u_star, cu_un, is_u=True, compensated=comp)
        r_v, v_norm = _unrelaxed_residual(v_star, cv_un, is_u=False, compensated=comp)
        out_u = (u_star, d_coefficient(cu_rel.a_p, dy, is_u=True), r_u, u_norm)
        out_v = (v_star, d_coefficient(cv_rel.a_p, dx, is_u=False), r_v, v_norm)
        return (out_u, out_v) if poisson_variant is None else (out_u, out_v, None)
    out_u = solve_u_momentum(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                             alpha=alpha, bc=bc, cfg=cfg)
    out_v = solve_v_momentum(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                             alpha=alpha, bc=bc, cfg=cfg)
    return ((out_u, out_v) if poisson_variant is None
            else (out_u, out_v, None))


def _pair_krylov_applicable(cfg, u_shape, v_shape, dtype, scheme, device) -> bool:
    """Batched-pair BiCGSTAB gate: 5-point power-law systems where the
    per-field kernel K7 does not run.  ``batch_pair='off'``, compensated
    dots and ``backend='composed'`` keep the sequential solves."""
    if getattr(cfg, "kind", None) != "bicgstab":
        return False
    if getattr(cfg, "batch_pair", "auto") == "off":
        return False
    if getattr(cfg, "compensated_dots", False):
        return False
    if _backend(cfg) == "composed":
        return False
    if scheme != "power_law":
        return False
    if (_cuda.kernel_device(device) and supports_fused_bicgstab(u_shape, dtype)
            and supports_fused_bicgstab(v_shape, dtype)):
        return False  # one K7 launch per field
    return True
