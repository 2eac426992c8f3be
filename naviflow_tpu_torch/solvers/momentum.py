"""Momentum predictor solvers (port of ``naviflow_tpu/solvers/momentum.py``,
main-path subset).

Each solve returns ``(star_field, d_coefficient, residual_field,
residual_norm)``: the linear system solved is the relaxed one, ``d =
spacing / a_p_relaxed``, and the residual is the unrelaxed
``r = src_un - A_un x`` with its L2 norm over interior nodes.

Ported: fixed-sweep Jacobi and fixed-degree Chebyshev inner solves on the
power-law scheme, and the pair form :func:`solve_momentum_pair` with its
merged kernel branch (K1, ``ops/asmcheby.py``) driven by lagged Gershgorin
maxima.  Not yet ported (each raises :class:`NotImplementedError`): the
red-black GS, BiCGSTAB, GMRES and IDR(s) inner solves (ROADMAP §1 item 2),
the 9-point QUICK/LUDS schemes (item 11), and the compensated residual
(item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops.asmcheby import fused_asmcheby_pair, supports_asmcheby
from ..ops.powerlaw import (
    d_coefficient,
    relax_coefficients,
    u_momentum_coefficients,
    v_momentum_coefficients,
)
from ..ops.stencil import StencilCoeffs, apply_stencil, interior_mask, neighbor_sum
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


def _inner_solve(x0, c_rel, mask, cfg, bounds=None):
    if cfg.kind == "jacobi":
        return _jacobi_sweeps(x0, c_rel, mask, cfg.n_sweeps)
    if cfg.kind == "chebyshev":
        return _chebyshev_masked(x0, c_rel, mask, cfg.degree,
                                 cfg.bound_margin, bounds=bounds)
    if cfg.kind in ("rbgs", "bicgstab", "gmres", "idrs"):
        raise NotImplementedError(
            f"{cfg.kind} momentum solve is not ported yet (ROADMAP §1 item 2; "
            "BiCGSTAB also carries kernels K6 and K7, ROADMAP §2)")
    raise ValueError(f"Unknown momentum solver kind: {cfg.kind}")


def _unrelaxed_residual(x_star, c_un, *, is_u: bool, compensated: bool = False):
    """r = src_un - A_un x: border-zeroed field + interior L2 norm."""
    if compensated:
        raise NotImplementedError(
            "compensated_residual: ops/compensated.py is not ported yet "
            "(ROADMAP §1 item 9)")
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
    return rf, torch.linalg.vector_norm(interior)


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
    out_u = solve_u_momentum(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                             alpha=alpha, bc=bc, cfg=cfg)
    out_v = solve_v_momentum(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                             alpha=alpha, bc=bc, cfg=cfg)
    return ((out_u, out_v) if poisson_variant is None
            else (out_u, out_v, None))
