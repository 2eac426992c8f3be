"""K8: both momentum fields' coefficient sets in one pass over u, v, p.

Replaces ``naviflow_tpu/ops/pallas_assembly.py:fused_assembly_pair``; the
CUDA kernel is ``csrc/assembly.cu`` (its header says what bounds it on the
H100 and how the design meets it).

One call assembles the power-law coefficients of both fields, relaxes them,
and folds out each field's masked Gershgorin ratio maximum and, with a
Poisson variant, d_u, d_v and the pressure-correction operator.  It runs
where the large-grid momentum solves do not go through the merged kernel K1
(SIMPLEC, PISO, SIMPLER, and SIMPLE with Jacobi or BiCGSTAB momentum).

On a CPU tensor :func:`fused_assembly_pair` runs
:func:`fused_assembly_pair_plain`, the composed PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .asmcheby import _masked_ratio_max
from .poisson import PoissonCoeffs, poisson_coefficients
from .powerlaw import (d_coefficient, relax_coefficients, u_momentum_coefficients,
                       v_momentum_coefficients)
from .stencil import StencilCoeffs

# The TPU kernel's folded-window cap in cells and its halo rows (a VMEM
# budget), kept so the port admits exactly the grids the reference admits;
# not an H100 limit.
_PAD = 16
_CAP_CELLS_FOLDED = 280 * 1024

_THREADS = 256  # csrc/assembly.cu THREADS
_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}

LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)


def supports_fused_assembly(nx, ny, scheme, dtype, backend, device) -> bool:
    """Gate (``pallas_assembly.supports_fused_assembly``): the kernel backend
    on a CUDA device, power-law f32, grids of at least 384 x 256 whose
    folded strip window fits the reference's budget."""
    if backend not in ("auto", "kernel") or not _cuda.kernel_device(device):
        return False
    if scheme != "power_law" or dtype != torch.float32:
        return False
    if nx < 384 or ny < 256:
        return False
    return any(nx % T == 0 and (T + 2 * _PAD) * ny <= _CAP_CELLS_FOLDED
               for T in (128, 64, 32, 16))


def _result(cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, fold, with_bounds):
    out = (cu_un, cu_rel, cv_un, cv_rel)
    if with_bounds:
        out = out + (rho_u, rho_v)
    if fold is not None:
        out = out + fold
    return out


def fused_assembly_pair_plain(u, v, p, *, dx, dy, rho, mu, alpha, with_bounds=False,
                              poisson_variant=None):
    """The composed version: global assembly -> relax -> masked Gershgorin
    ratio maxima -> d -> pressure operator."""
    from ..solvers.momentum import _u_interior_mask, _v_interior_mask

    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    cu_un = u_momentum_coefficients(u, v, p, **kw)
    cu_rel = relax_coefficients(cu_un, u, alpha)
    cv_un = v_momentum_coefficients(u, v, p, **kw)
    cv_rel = relax_coefficients(cv_un, v, alpha)
    rho_u = rho_v = fold = None
    if with_bounds:
        rho_u = _masked_ratio_max(cu_rel, _u_interior_mask(u.shape, device=u.device))
        rho_v = _masked_ratio_max(cv_rel, _v_interior_mask(v.shape, device=v.device))
    if poisson_variant is not None:
        d_u = d_coefficient(cu_rel.a_p, dy, is_u=True)
        d_v = d_coefficient(cv_rel.a_p, dx, is_u=False)
        fold = (d_u, d_v, poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                               variant=poisson_variant))
    return _result(cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, fold, with_bounds)


def fused_assembly_pair(u, v, p, *, dx, dy, rho, mu, alpha, with_bounds=False,
                        poisson_variant=None):
    """Both momentum fields' (unrelaxed, relaxed) coefficient sets in one
    launch.  ``u, v``: the BC-applied staggered fields.  Returns ``(cu_un,
    cu_rel, cv_un, cv_rel)`` (:class:`StencilCoeffs`, the relaxed sets
    sharing the unrelaxed links), then ``(rho_u, rho_v)`` (0-d tensors, the
    masked Gershgorin ratio maxima of the relaxed systems) when
    ``with_bounds``, then ``(d_u, d_v, pc)`` when ``poisson_variant`` is
    set ('consistent', 'symmetric' or 'reference')."""
    global LAUNCHES
    if poisson_variant is not None and poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {poisson_variant}")
    if not u.is_cuda:
        return fused_assembly_pair_plain(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha,
                                         with_bounds=with_bounds,
                                         poisson_variant=poisson_variant)
    nxp1, ny = u.shape
    nx = nxp1 - 1
    _cuda.require(u, (nx + 1, ny), "u")
    _cuda.require(v, (nx, ny + 1), "v")
    _cuda.require(p, (nx, ny), "p")
    dev = u.device
    stream = _cuda.stream_of(u)  # raises under a transform, before a pointer is read

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    blocks = -(-max((nx + 1) * ny, nx * (ny + 1)) // _THREADS)
    cu = [empty(nx + 1, ny) for _ in range(8)]
    cv = [empty(nx, ny + 1) for _ in range(8)]
    gmax = [empty(blocks), empty(blocks)]
    outs = cu + cv + gmax
    fold = None
    if poisson_variant is not None:
        fold = [empty(nx + 1, ny), empty(nx, ny + 1)] + [empty(nx, ny) for _ in range(5)]
        outs += fold
    ptrs = [u.data_ptr(), v.data_ptr(), p.data_ptr()] + [t.data_ptr() for t in outs]
    ip = [nx, ny, _VARIANTS[poisson_variant] if poisson_variant is not None else -1, blocks]
    fp = [0.5 * rho * dy, 0.5 * rho * dx, mu * dy / dx, mu * dx / dy, dx, dy, alpha,
          1.0 - alpha, rho]
    _cuda.check(_cuda.library().nf_fused_assembly_pair(
        (ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_int * len(ip))(*ip),
        (ctypes.c_float * len(fp))(*fp), stream), "fused_assembly_pair")
    LAUNCHES += 1
    cu_un = StencilCoeffs(a_e=cu[0], a_w=cu[1], a_n=cu[2], a_s=cu[3], a_p=cu[4], src=cu[5])
    cv_un = StencilCoeffs(a_e=cv[0], a_w=cv[1], a_n=cv[2], a_s=cv[3], a_p=cv[4], src=cv[5])
    cu_rel = cu_un.replace(a_p=cu[6], src=cu[7])
    cv_rel = cv_un.replace(a_p=cv[6], src=cv[7])
    if fold is not None:
        d_u, d_v, pe, pw, pn, ps, pdiag = fold
        fold = (d_u, d_v, PoissonCoeffs(a_e=pe, a_w=pw, a_n=pn, a_s=ps, diag=pdiag))
    rho_u, rho_v = (torch.max(gmax[0]), torch.max(gmax[1])) if with_bounds else (None, None)
    return _result(cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, fold, with_bounds)
