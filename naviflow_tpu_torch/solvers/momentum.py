"""Momentum predictor solvers (port of ``naviflow_tpu/solvers/momentum.py``,
main-path subset).

Each solve returns ``(star_field, d_coefficient, residual_field,
residual_norm)``: the linear system solved is the relaxed one, ``d =
spacing / a_p_relaxed``, and the residual is the unrelaxed
``r = src_un - A_un x`` with its L2 norm over interior nodes.

Every inner solve of the JAX module is ported: fixed-sweep Jacobi,
red-black Gauss-Seidel (SOR), fixed-degree Chebyshev, masked BiCGSTAB,
restarted GMRES (``solvers/krylov.gmres_solve``) and IDR(s), on the
power-law scheme and on the 9-point QUICK / LUDS / upwind schemes
(``ops/highorder.py``), the compensated residual, and the
pair form :func:`solve_momentum_pair` with its merged kernel branch (K1,
``ops/asmcheby.py``) driven by lagged Gershgorin maxima, its one-pass
assembly branch (K8, ``ops/assembly.py``) and its batched BiCGSTAB branch
(:func:`_bicgstab_pair_masked`).  On a CUDA tensor a BiCGSTAB solve whose
field fits the reference kernel's budget is one launch of K7
(``ops/krylov.py``), and a large-grid Chebyshev solve outside K1 is one
launch of K9 (``ops/cheby.py``) per field.  Every kernel gate refuses a
9-point system (K1, K7, K8, K9, the batched pair), as the JAX package's
gates do; such a system runs composed.  The assembly gate (K8) does not
look at the momentum kind, as in the JAX package: RBGS, GMRES and IDR(s)
solves on large power-law float32 grids take their coefficients from K8.
Under ``torch.func.vmap`` (the batched lockstep step, ``algorithms/batch.py``)
``mu`` is one case's ``powerlaw.case_conductances`` row, and K1, K7, K8 and
K9 run their batching rules: one launch for every case, no host read.

IDR(s)'s shadow space: the JAX package draws it with
``jax.random.normal(PRNGKey(0), ...)``, which PyTorch cannot reproduce.
By default :func:`_idrs_masked` draws it from a ``torch.Generator``
seeded 0 on the CPU and moves it to the field's device, so the card and
the CPU use the same space; its iterates then differ from the JAX
package's and agree with them only to the solve's tolerance.  Passing
the JAX package's space (``shadow=``) reproduces its iterates.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops import _cuda
from ..ops.asmcheby import fused_asmcheby_pair, supports_asmcheby
from ..ops.assembly import fused_assembly_pair, supports_fused_assembly
from ..ops.cheby import chebyshev_momentum_strips, supports_cheby_strips
from ..ops.compensated import compensated_linear_combination, compensated_norm, fold_dot
from ..ops.highorder import (_OFFSETS, MomentumCoeffs9, apply_momentum9, neighbor_sum9,
                             relax_coefficients9, shift, u_momentum_coefficients9,
                             v_momentum_coefficients9)
from ..ops.krylov import bicgstab_momentum, supports_fused_bicgstab
from ..ops.powerlaw import (
    d_coefficient,
    relax_coefficients,
    u_momentum_coefficients,
    v_momentum_coefficients,
)
from ..ops.stencil import (StencilCoeffs, apply_stencil, index_grids, interior_mask,
                           neighbor_sum, pad2, shift_e, shift_n, shift_s, shift_w)
from ..ops.while_loop import flatten, while_loop

BACKENDS = ("auto", "kernel", "composed")


def _apply(x, c):
    return apply_momentum9(x, c) if isinstance(c, MomentumCoeffs9) else apply_stencil(x, c)


def _nbsum(x, c):
    return neighbor_sum9(x, c) if isinstance(c, MomentumCoeffs9) else neighbor_sum(x, c)


def _assemble_coeffs(u, v, p, *, dx, dy, rho, mu, scheme, is_u):
    if scheme == "power_law":
        fn = u_momentum_coefficients if is_u else v_momentum_coefficients
        return fn(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu)
    fn = u_momentum_coefficients9 if is_u else v_momentum_coefficients9
    return fn(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, scheme=scheme)


def _relax(coeffs, field, alpha):
    if isinstance(coeffs, MomentumCoeffs9):
        return relax_coefficients9(coeffs, field, alpha)
    return relax_coefficients(coeffs, field, alpha)


@dataclasses.dataclass(frozen=True)
class JacobiMomentumConfig:
    """Fixed-sweep weighted-Jacobi momentum solve."""

    n_sweeps: int = 1
    scheme: str = "power_law"
    compensated_residual: bool = False
    kind: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class RBGSMomentumConfig:
    """Fixed-sweep red-black Gauss-Seidel (SOR) momentum solve."""

    n_sweeps: int = 2
    omega: float = 1.0
    scheme: str = "power_law"
    kind: str = "rbgs"


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


@dataclasses.dataclass(frozen=True)
class IDRSMomentumConfig:
    """IDR(s) momentum solve (Sonneveld & van Gijzen), the biorthogonal
    variant with van Gijzen's basis update ``U_k = U_{k:s} c + om v``."""

    tolerance: float = 1e-7
    max_iterations: int = 30  # outer G-space builds (~(s+1) matvecs each)
    s: int = 4
    angle: float = 0.7
    scheme: str = "power_law"
    kind: str = "idrs"


@dataclasses.dataclass(frozen=True)
class GMRESMomentumConfig:
    """Matrix-free restarted GMRES(m) momentum solve with Jacobi right
    preconditioning."""

    tolerance: float = 1e-7
    max_iterations: int = 40  # total Arnoldi steps
    restart: int = 10
    scheme: str = "power_law"
    compensated_residual: bool = False
    kind: str = "gmres"


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


def _rbgs_sweeps(x0, c, mask, n_sweeps: int, omega: float):
    """Red-black Gauss-Seidel with SOR on masked nodes (red = (i+j) even
    first).  On a 9-point system the two-colour split is only an
    approximate Gauss-Seidel (the +-2 links join nodes of one colour)."""
    ii, jj = index_grids(x0.shape, x0.device)
    red = ((ii + jj) % 2 == 0) & mask
    black = ((ii + jj) % 2 == 1) & mask
    safe_ap = torch.where(c.a_p == 0, torch.ones_like(c.a_p), c.a_p)
    x = x0
    for _ in range(n_sweeps):
        for color in (red, black):
            x = torch.where(color, x + omega * ((_nbsum(x, c) + c.src) / safe_ap - x), x)
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
    if isinstance(c, MomentumCoeffs9):
        nb_abs = sum(torch.abs(getattr(c, name)) for name in _OFFSETS)
    else:
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
    ``compensated_dots``: the dots and norms are :func:`fold_dot`.  The
    loop is the JAX package's ``lax.while_loop`` (carry ``(x, r, rhat, rho,
    alpha, omega, v, p, k, ok)``) through ``ops/while_loop.py``: one host
    read an iteration, and under ``torch.func.vmap`` one for every case."""
    if compensated_dots:
        dot = fold_dot
    else:
        def dot(a, b):
            return torch.sum(a * b)

    eps = torch.finfo(x0.dtype).tiny * 1e6
    leaves, build = flatten(c)

    def A(x, cs, mask_f):
        return _apply(x, cs) * mask_f

    mask_f = mask.to(x0.dtype)
    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x, c, mask_f)
    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    zero = 0.0 * one
    v = p = torch.zeros_like(x0)
    bnorm = torch.sqrt(dot(b, b))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    k = torch.zeros((), dtype=torch.int32, device=x0.device)
    ok = torch.ones((), dtype=torch.bool, device=x0.device)

    def cond(x, r, rhat, rho, alpha, omega_, v, p, k, ok, *consts):
        return ok & (k < maxiter) & (dot(r, r) > consts[0])

    def body(x, r, rhat, rho, alpha, omega_, v, p, k, ok, *consts):
        tol2, mask_f, zero, *cl = consts
        cs = build(cl)
        rho_new = dot(rhat, r)
        good = (torch.abs(rho) > eps) & (torch.abs(omega_) > eps)
        beta = torch.where(good, (rho_new / rho) * (alpha / omega_), zero)
        p = r + beta * (p - omega_ * v)
        v = A(p, cs, mask_f)
        denom = dot(rhat, v)
        good = good & (torch.abs(denom) > eps)
        alpha = torch.where(good, rho_new / denom, zero)
        s = r - alpha * v
        t = A(s, cs, mask_f)
        tt = dot(t, t)
        omega_ = torch.where(tt > eps, dot(t, s) / tt, zero)
        x = x + alpha * p + omega_ * s
        r = s - omega_ * t
        return (x, r, rhat, rho_new, alpha, omega_, v, p, k + 1, good, *consts)

    x, *_ = while_loop(cond, body, x, r, r, one, one, one, v, p, k, ok,
                       tol2, mask_f, zero, *leaves)
    return torch.where(mask, x, x0)


def _bicgstab_pair_masked(xu0, cu, mask_u, xv0, cv, mask_v, tol: float, maxiter: int):
    """The u and v solves batched into one Krylov loop: the two systems are
    padded to one (2, M, N) stack, every dot is one reduction to a 2-vector
    and each system freezes once its own residual passes the tolerance, so
    per-system arithmetic is that of :func:`_bicgstab_masked`.  The loop is
    the JAX package's ``lax.while_loop`` through ``ops/while_loop.py``."""
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

    def A(x, a_e, a_w, a_n, a_s, a_p, mask):
        return (a_p * x - a_e * sh(x, 1, 0) - a_w * sh(x, -1, 0)
                - a_n * sh(x, 0, 1) - a_s * sh(x, 0, -1)) * mask

    def dot(a, bb):
        return torch.sum(a * bb, dim=(1, 2))

    def col(s):
        return s[:, None, None]

    system = (a_e, a_w, a_n, a_s, a_p, mask)
    x = x0 * mask
    r = b - A(x, *system)
    ones = torch.ones((2,), dtype=x0.dtype, device=x0.device)
    v = p = torch.zeros_like(x)
    bnorm = torch.sqrt(dot(b, b))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    eps = torch.finfo(x0.dtype).tiny * 1e6
    ok = torch.ones((2,), dtype=torch.bool, device=x0.device)
    k = torch.zeros((), dtype=torch.int32, device=x0.device)

    def cond(x, r, rhat, rho, alpha, omega_, v, p, k, ok, tol2, zeros, *system):
        return (k < maxiter) & torch.any(ok & (dot(r, r) > tol2))

    def body(x, r, rhat, rho, alpha, omega_, v, p, k, ok, tol2, zeros, *system):
        act = ok & (dot(r, r) > tol2)
        rho_new = dot(rhat, r)
        good = (torch.abs(rho) > eps) & (torch.abs(omega_) > eps)
        beta = torch.where(good, (rho_new / rho) * (alpha / omega_), zeros)
        p_new = r + col(beta) * (p - col(omega_) * v)
        v_new = A(p_new, *system)
        denom = dot(rhat, v_new)
        good = good & (torch.abs(denom) > eps)
        alpha_new = torch.where(good, rho_new / denom, zeros)
        s = r - col(alpha_new) * v_new
        t = A(s, *system)
        tt = dot(t, t)
        omega_new = torch.where(tt > eps, dot(t, s) / tt, zeros)
        x_new = x + col(alpha_new) * p_new + col(omega_new) * s
        r_new = s - col(omega_new) * t
        a = col(act)
        return (torch.where(a, x_new, x), torch.where(a, r_new, r), rhat,
                torch.where(act, rho_new, rho), torch.where(act, alpha_new, alpha),
                torch.where(act, omega_new, omega_), torch.where(a, v_new, v),
                torch.where(a, p_new, p), k + 1, torch.where(act, good, ok), tol2, zeros, *system)

    x, *_ = while_loop(cond, body, x, r, r, ones, ones, ones, v, p, k, ok, tol2, 0.0 * ones,
                       *system)
    xu = torch.where(mask_u, x[0, :nxp1, :ny], xu0)
    xv = torch.where(mask_v, x[1, :nx, :nyp1], xv0)
    return xu, xv


def _gmres_masked(x0, c, mask, tol: float, maxiter: int, restart: int):
    """Restarted GMRES(m) on the masked momentum system with Jacobi right
    preconditioning (one host read per restart cycle)."""
    from .krylov import gmres_solve

    mask_f = mask.to(x0.dtype)

    def A(x):
        return _apply(x, c) * mask_f

    inv_d = torch.where(c.a_p == 0, torch.zeros_like(c.a_p), 1.0 / c.a_p) * mask_f

    def M(r):
        return r * inv_d

    b = c.src * mask_f
    x, _, _ = gmres_solve(b, A, M, x0 * mask_f, tol, maxiter, restart)
    return torch.where(mask, x, x0)


def idrs_shadow_space(s: int, shape, dtype, device):
    """IDR(s)'s default shadow space: ``s`` standard-normal fields from a
    ``torch.Generator`` seeded 0 on the CPU, moved to ``device`` (the same
    numbers on every device)."""
    g = torch.Generator().manual_seed(0)
    return torch.randn((s,) + tuple(shape), generator=g, dtype=dtype).to(device)


def _idrs_masked(x0, c, mask, tol: float, max_outer: int, s: int, angle: float,
                 shadow=None):
    """IDR(s) on the masked momentum system (see :class:`IDRSMomentumConfig`;
    one host read per outer iteration).  ``shadow``: the ``(s,) +
    x0.shape`` shadow space, by default :func:`idrs_shadow_space`."""
    dtype = x0.dtype
    mask_f = mask.to(dtype)

    def A(x):
        return _apply(x, c) * mask_f

    def pdot(a, w):
        return torch.sum(a * w)

    def safe(d):
        return torch.where(d == 0, torch.full_like(d, 1e-30), d)

    b = c.src * mask_f
    x = x0 * mask_f
    r = b - A(x)
    P = idrs_shadow_space(s, x0.shape, dtype, x0.device) if shadow is None else shadow
    U = torch.zeros((s,) + tuple(x0.shape), dtype=dtype, device=x0.device)
    G = torch.zeros_like(U)
    Ms = torch.eye(s, dtype=dtype, device=x0.device)
    om = torch.ones((), dtype=dtype, device=x0.device)
    tolb = tol * torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    zero = torch.zeros((), dtype=dtype, device=x0.device)
    it = 0
    while it < max_outer and bool(torch.linalg.vector_norm(r) >= tolb):
        f = torch.stack([pdot(P[i], r) for i in range(s)])
        for k in range(s):
            ck = torch.linalg.solve_ex(Ms[k:, k:], f[k:])[0]
            v = r - torch.tensordot(ck, G[k:], dims=1)
            u_new = torch.tensordot(ck, U[k:], dims=1) + om * v
            g_new = A(u_new)
            for i in range(k):
                alpha = pdot(P[i], g_new) / safe(Ms[i, i])
                g_new = g_new - alpha * G[i]
                u_new = u_new - alpha * U[i]
            col = torch.stack([pdot(P[i], g_new) if i >= k else zero for i in range(s)])
            Ms = Ms.clone()
            Ms[:, k] = col
            beta = f[k] / safe(Ms[k, k])
            x = x + beta * u_new
            r = r - beta * g_new
            U, G = U.clone(), G.clone()
            U[k], G[k] = u_new, g_new
            if k < s - 1:
                f = torch.cat([f[:k + 1], f[k + 1:] + -beta * Ms[k + 1:, k]])
        # the dimension-reduction omega step
        t = A(r)
        nr = torch.linalg.vector_norm(r)
        nt = torch.linalg.vector_norm(t)
        ts = pdot(t, r)
        rho = torch.abs(ts / torch.clamp(nt * nr, min=1e-30))
        om = ts / torch.clamp(nt * nt, min=1e-30)
        om = torch.where(rho < angle, om * angle / torch.clamp(rho, min=1e-30), om)
        x = x + om * r
        r = r - om * t
        it += 1
    return torch.where(mask, x, x0)


def _inner_solve(x0, c_rel, mask, cfg, bounds=None):
    if cfg.kind == "jacobi":
        return _jacobi_sweeps(x0, c_rel, mask, cfg.n_sweeps)
    if cfg.kind == "rbgs":
        return _rbgs_sweeps(x0, c_rel, mask, cfg.n_sweeps, cfg.omega)
    if cfg.kind == "chebyshev":
        return _chebyshev_masked(x0, c_rel, mask, cfg.degree,
                                 cfg.bound_margin, bounds=bounds)
    if cfg.kind == "bicgstab":
        if (_backend(cfg) != "composed" and _cuda.kernel_device(x0)
                and not isinstance(c_rel, MomentumCoeffs9)
                and supports_fused_bicgstab(x0.shape, x0.dtype)):
            # the whole solve in one launch (K7), compensated dots
            return bicgstab_momentum(x0, c_rel, tol=cfg.tolerance, maxiter=cfg.max_iterations)
        return _bicgstab_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations,
                                compensated_dots=getattr(cfg, "compensated_dots", False))
    if cfg.kind == "gmres":
        return _gmres_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations, cfg.restart)
    if cfg.kind == "idrs":
        return _idrs_masked(x0, c_rel, mask, cfg.tolerance, cfg.max_iterations, cfg.s,
                            cfg.angle)
    raise ValueError(f"Unknown momentum solver kind: {cfg.kind}")


def _unrelaxed_residual(x_star, c_un, *, is_u: bool, compensated: bool = False):
    """r = src_un - A_un x: border-zeroed field + interior L2 norm.
    ``compensated``: the residual as an error-free transformation and the
    norm with compensated accumulation (``ops/compensated.py``)."""
    if compensated:
        if isinstance(c_un, MomentumCoeffs9):
            terms = [c_un.src] + [(getattr(c_un, name), shift(x_star, di, dj))
                                  for name, (di, dj) in _OFFSETS.items()] + [
                (-c_un.a_p, x_star)]
        else:
            terms = [
                c_un.src,
                (c_un.a_e, shift_e(x_star)),
                (c_un.a_w, shift_w(x_star)),
                (c_un.a_n, shift_n(x_star)),
                (c_un.a_s, shift_s(x_star)),
                (-c_un.a_p, x_star),
            ]
        r, _ = compensated_linear_combination(terms)
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


def _cheby_strips_applicable(cfg, shape, dtype, c_rel, device) -> bool:
    """Gate of the Chebyshev solve + residual kernel (K9): five-point
    systems on large CUDA grids, the plain residual."""
    if getattr(cfg, "kind", None) != "chebyshev" or _backend(cfg) == "composed":
        return False
    if getattr(cfg, "compensated_residual", False):
        return False
    if not isinstance(c_rel, StencilCoeffs):
        return False
    return supports_cheby_strips(shape, dtype, device)


def _cheby_strip_field(x0, c_un, c_rel, mask, cfg, *, is_u: bool, bounds=None):
    """One field through K9.  Returns ``(x_star, r_field, r_norm)`` as the
    composed path: the kernel's residual is zero exactly outside the norm
    region, so its L2 is the interior norm, and the diagnostics field is a
    further border mask of it."""
    if bounds is None:
        bounds = _chebyshev_bounds(c_rel, mask, cfg.bound_margin)
    theta, delta, sigma1 = bounds
    x_star, r_m = chebyshev_momentum_strips(x0, c_rel, c_un, theta=theta, delta=delta,
                                            sigma1=sigma1, degree=cfg.degree)
    margins = (2, 2, 1, 1) if is_u else (1, 1, 2, 2)
    r_field = torch.where(interior_mask(r_m.shape, *margins, device=r_m.device), r_m,
                          torch.zeros_like(r_m))
    return x_star, r_field, torch.linalg.vector_norm(r_m)


def solve_u_momentum(u, v, p, *, dx, dy, rho, mu, alpha, bc: BoundaryConditions, cfg,
                     coeffs=None, gersh_rho=None, d_pre=None):
    """u-momentum predictor.  Returns (u_star, d_u, r_field, r_norm)."""
    u, v = apply_velocity_bcs(u, v, bc)
    if coeffs is not None:
        c_un, c_rel = coeffs
    else:
        c_un = _assemble_coeffs(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu,
                                scheme=getattr(cfg, "scheme", "power_law"), is_u=True)
        c_rel = _relax(c_un, u, alpha)
    mask = _u_interior_mask(u.shape, device=u.device)
    d_u = d_pre if d_pre is not None else d_coefficient(c_rel.a_p, dy, is_u=True)
    bounds = (None if gersh_rho is None
              else _bounds_from_rho(gersh_rho, getattr(cfg, "bound_margin", 1.05)))
    if _cheby_strips_applicable(cfg, u.shape, u.dtype, c_rel, u.device):
        u_star, r_field, r_norm = _cheby_strip_field(u, c_un, c_rel, mask, cfg, is_u=True,
                                                     bounds=bounds)
        u_star, _ = apply_velocity_bcs(u_star, v, bc)
        return u_star, d_u, r_field, r_norm
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
        c_rel = _relax(c_un, v, alpha)
    mask = _v_interior_mask(v.shape, device=v.device)
    d_v = d_pre if d_pre is not None else d_coefficient(c_rel.a_p, dx, is_u=False)
    bounds = (None if gersh_rho is None
              else _bounds_from_rho(gersh_rho, getattr(cfg, "bound_margin", 1.05)))
    if _cheby_strips_applicable(cfg, v.shape, v.dtype, c_rel, v.device):
        v_star, r_field, r_norm = _cheby_strip_field(v, c_un, c_rel, mask, cfg, is_u=False,
                                                     bounds=bounds)
        _, v_star = apply_velocity_bcs(u, v_star, bc)
        return v_star, d_v, r_field, r_norm
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

    coeffs = None
    rho_u = rho_v = d_u_f = d_v_f = pc_f = None
    if supports_fused_assembly(nxp1 - 1, ny, scheme, u.dtype, _backend(cfg), u.device):
        # both fields' coefficients in one pass (K8); the Chebyshev bounds
        # and, with the fold, d and the pressure operator come out of it
        u, v = apply_velocity_bcs(u, v, bc)
        want_bounds = (getattr(cfg, "kind", None) == "chebyshev"
                       and getattr(cfg, "assembly_bounds", "auto") == "auto")
        res = fused_assembly_pair(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha,
                                  with_bounds=want_bounds, poisson_variant=poisson_variant)
        coeffs, rest = res[:4], res[4:]
        if want_bounds:
            (rho_u, rho_v), rest = rest[:2], rest[2:]
        if poisson_variant is not None:
            d_u_f, d_v_f, pc_f = rest
    if _pair_krylov_applicable(cfg, u.shape, v.shape, u.dtype, scheme, u.device):
        # batched u+v BiCGSTAB: one Krylov loop for both systems
        ub, vb = apply_velocity_bcs(u, v, bc)
        if coeffs is not None:
            cu_un, cu_rel, cv_un, cv_rel = coeffs
        else:
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
        d_u = d_u_f if d_u_f is not None else d_coefficient(cu_rel.a_p, dy, is_u=True)
        d_v = d_v_f if d_v_f is not None else d_coefficient(cv_rel.a_p, dx, is_u=False)
        out_u = (u_star, d_u, r_u, u_norm)
        out_v = (v_star, d_v, r_v, v_norm)
        return (out_u, out_v) if poisson_variant is None else (out_u, out_v, pc_f)
    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha, bc=bc, cfg=cfg)
    if coeffs is not None:
        cu_un, cu_rel, cv_un, cv_rel = coeffs
        out_u = solve_u_momentum(u, v, p, coeffs=(cu_un, cu_rel), gersh_rho=rho_u,
                                 d_pre=d_u_f, **kw)
        out_v = solve_v_momentum(u, v, p, coeffs=(cv_un, cv_rel), gersh_rho=rho_v,
                                 d_pre=d_v_f, **kw)
    else:
        out_u = solve_u_momentum(u, v, p, **kw)
        out_v = solve_v_momentum(u, v, p, **kw)
    return (out_u, out_v) if poisson_variant is None else (out_u, out_v, pc_f)


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
