"""K1: merged assembly + lagged-bound Chebyshev momentum solve of both fields.

Replaces ``naviflow_tpu/ops/pallas_asmcheby.py:fused_asmcheby_pair``; the
CUDA kernel is ``csrc/asmcheby.cu`` (its header says what bounds it on the
H100 and how the 2-D halo tiles deal with that).

One call assembles each field's power-law coefficients, relaxes them, runs
``degree`` Chebyshev steps with the given (lagged) interval scalars,
evaluates the unrelaxed residual, and folds out d_u / d_v, the 5-array
pressure-correction operator and each field's fresh masked Gershgorin ratio
maximum (the next outer step's bounds).  The first step uses the
conservative ``rho = 0.999`` (``algorithms/simple.py``).

On a CPU tensor :func:`fused_asmcheby_pair` runs
:func:`fused_asmcheby_pair_plain`, the composed PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .poisson import PoissonCoeffs, poisson_coefficients
from .powerlaw import (d_coefficient, relax_coefficients,
                       u_momentum_coefficients, v_momentum_coefficients)
from .stencil import apply_stencil

PAD = 16  # the TPU window halo: the gate keeps degree + 1 <= PAD

# The TPU kernel's window cap in cells (a VMEM budget), kept so the port
# admits exactly the grids the reference admits; not an H100 limit.
_CAP_CELLS = 224 * 1024

_TILE = 32  # csrc/asmcheby.cu TILE
_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}

LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)


def _strip_rows_merged(nx: int, ny: int) -> int:
    for T in (128, 64, 32, 16):
        if nx % T == 0 and (T + 2 * PAD) * ny <= _CAP_CELLS:
            return T
    return 0


def supports_asmcheby(nx, ny, scheme, dtype, backend, degree, device) -> bool:
    """Gate: kernel backend on a CUDA device, power-law f32 five-point
    systems, nx, ny >= 1024 (the reference's measured crossover), the apply
    chain within the halo."""
    if backend not in ("auto", "kernel") or not _cuda.kernel_device(device):
        return False
    if scheme != "power_law" or dtype != torch.float32:
        return False
    if degree + 1 > PAD:
        return False
    if nx < 1024 or ny < 1024:
        return False
    return _strip_rows_merged(nx, ny) > 0


def _masked_ratio_max(c_rel, mask):
    safe = torch.where(c_rel.a_p == 0, torch.ones_like(c_rel.a_p), c_rel.a_p)
    nb = (torch.abs(c_rel.a_e) + torch.abs(c_rel.a_w)
          + torch.abs(c_rel.a_n) + torch.abs(c_rel.a_s))
    return torch.max(torch.where(mask, nb / safe, torch.zeros_like(nb)))


def fused_asmcheby_pair_plain(u, v, p, *, dx, dy, rho, mu, alpha, degree,
                              bounds_u, bounds_v, poisson_variant="consistent"):
    """The composed version: global assembly -> relax -> Chebyshev with the
    given bounds -> masked unrelaxed residual -> d -> pressure operator ->
    masked Gershgorin ratio maxima."""
    from ..solvers.momentum import (_chebyshev_iterate, _u_interior_mask,
                                    _v_interior_mask)

    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    cu = u_momentum_coefficients(u, v, p, **kw)
    cu_rel = relax_coefficients(cu, u, alpha)
    cv = v_momentum_coefficients(u, v, p, **kw)
    cv_rel = relax_coefficients(cv, v, alpha)
    mask_u = _u_interior_mask(u.shape, device=u.device)
    mask_v = _v_interior_mask(v.shape, device=v.device)
    x_u = _chebyshev_iterate(u, cu_rel, mask_u, *bounds_u, degree)
    x_v = _chebyshev_iterate(v, cv_rel, mask_v, *bounds_v, degree)
    r_u = torch.where(mask_u, cu.src - apply_stencil(x_u, cu), torch.zeros_like(x_u))
    r_v = torch.where(mask_v, cv.src - apply_stencil(x_v, cv), torch.zeros_like(x_v))
    d_u = d_coefficient(cu_rel.a_p, dy, is_u=True)
    d_v = d_coefficient(cv_rel.a_p, dx, is_u=False)
    pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=poisson_variant)
    return (x_u, r_u, x_v, r_v, d_u, d_v, pc,
            _masked_ratio_max(cu_rel, mask_u), _masked_ratio_max(cv_rel, mask_v))


def fused_asmcheby_pair(u, v, p, *, dx, dy, rho, mu, alpha, degree,
                        bounds_u, bounds_v, poisson_variant="consistent"):
    """Assemble + Chebyshev-solve both momentum fields in one launch.

    ``u, v``: BC-applied staggered fields; ``bounds_u``/``bounds_v``:
    ``(theta, delta, sigma1)`` interval scalars.  Returns ``(u_star, r_u,
    v_star, r_v, d_u, d_v, pc, rho_u, rho_v)``: the ``r`` fields are the
    unrelaxed residuals, zero outside each field's solve mask, ``pc`` the
    :class:`PoissonCoeffs`, and ``rho_u/rho_v`` the fresh masked Gershgorin
    ratio maxima (0-d tensors)."""
    global LAUNCHES
    if not u.is_cuda:
        return fused_asmcheby_pair_plain(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha, degree=degree,
            bounds_u=bounds_u, bounds_v=bounds_v, poisson_variant=poisson_variant)
    nxp1, ny = u.shape
    nx = nxp1 - 1
    _cuda.require(u, (nx + 1, ny), "u")
    _cuda.require(v, (nx, ny + 1), "v")
    _cuda.require(p, (nx, ny), "p")
    if degree < 1 or degree + 1 > PAD:
        raise ValueError(f"degree {degree}: the kernel needs 1 <= degree <= {PAD - 1}")
    if poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {poisson_variant}")
    dev = u.device
    bounds = torch.stack([torch.as_tensor(s, dtype=torch.float32, device=dev).reshape(())
                          for s in (*bounds_u, *bounds_v)])
    gx = -(-(ny + 1) // _TILE)
    gy = -(-(nx + 1) // _TILE)

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [empty((nx + 1, ny)), empty((nx + 1, ny)), empty((nx, ny + 1)),
            empty((nx, ny + 1)), empty((nx + 1, ny)), empty((nx, ny + 1))]
    outs += [empty((nx, ny)) for _ in range(5)]
    outs += [empty((gy * gx,)), empty((gy * gx,))]
    ptrs = (ctypes.c_longlong * 17)(
        *[t.data_ptr() for t in (u, v, p, bounds, *outs)])
    ip = (ctypes.c_int * 6)(nx, ny, degree, _VARIANTS[poisson_variant], gx, gy)
    fp = (ctypes.c_float * 9)(0.5 * rho * dy, 0.5 * rho * dx, mu * dy / dx,
                              mu * dx / dy, dx, dy, alpha, 1.0 - alpha, rho)
    lib = _cuda.library()
    _cuda.check(lib.nf_asmcheby_pair(ptrs, ip, fp, _cuda.stream_of(u)),
                "fused_asmcheby_pair")
    LAUNCHES += 1
    u_star, r_u, v_star, r_v, d_u, d_v, pe, pw, pn, ps, pdiag, gu, gv = outs
    pc = PoissonCoeffs(a_e=pe, a_w=pw, a_n=pn, a_s=ps, diag=pdiag)
    return u_star, r_u, v_star, r_v, d_u, d_v, pc, torch.max(gu), torch.max(gv)
