"""K7: the whole masked BiCGSTAB of one momentum field, in one launch.

Replaces ``naviflow_tpu/ops/pallas_krylov.py:bicgstab_momentum_pallas``; the
CUDA kernel is ``csrc/krylov.cu`` over the device solve of
``csrc/krylov.cuh`` (a cooperative launch; every block sums the per-block
partials of each dot in the same order, so the stopping test and the
breakdown guards are the same in every block; the header says what bounds
it on the H100).  Its dots and the stopping norm are compensated
(``ops/compensated.py``), as the reference kernel's are.

The plain version is ``solvers/momentum._bicgstab_masked`` with
``compensated_dots=True``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .mg import RED_FLOATS, _padded_bytes
from .stencil import StencilCoeffs, interior_mask

# The TPU kernel's per-field VMEM cap (x + 5 Krylov vectors + 6 coefficient
# arrays); kept so the port dispatches as the reference does.
MAX_FIELD_BYTES = 2**20

LAUNCHES = 0


def supports_fused_bicgstab(shape, dtype) -> bool:
    if dtype != torch.float32:
        return False
    return _padded_bytes(*shape) <= MAX_FIELD_BYTES


def bicgstab_momentum_plain(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                            margins=(1, 1, 1, 1)):
    from ..solvers.momentum import _bicgstab_masked

    mask = interior_mask(x0.shape, *margins, device=x0.device)
    return _bicgstab_masked(x0, c, mask, tol, maxiter, compensated_dots=True)


def bicgstab_momentum(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                      margins=(1, 1, 1, 1)):
    """Whole-solve masked BiCGSTAB of ``A x = src`` on the nodes inside
    ``margins`` (lo_i, hi_i, lo_j, hi_j); other nodes keep ``x0``."""
    global LAUNCHES
    if not x0.is_cuda:
        return bicgstab_momentum_plain(x0, c, tol=tol, maxiter=maxiter, margins=margins)
    shape = tuple(x0.shape)
    _cuda.require(x0, shape, "x0")
    arrays = [c.a_e, c.a_w, c.a_n, c.a_s, c.a_p, c.src]
    for name, a in zip(("a_e", "a_w", "a_n", "a_s", "a_p", "src"), arrays):
        _cuda.require(a, shape, name)
    out = torch.empty_like(x0)
    scratch = torch.empty((6,) + shape, dtype=torch.float32, device=x0.device)
    red = torch.empty((RED_FLOATS,), dtype=torch.float32, device=x0.device)
    ptrs = [x0.data_ptr()] + [a.data_ptr() for a in arrays]
    ptrs += [out.data_ptr(), scratch.data_ptr(), red.data_ptr()]
    ip = [shape[0], shape[1], maxiter, *margins]
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * 1)(tol)
    _cuda.check(_cuda.library().nf_bicgstab(c_ptrs, c_ip, c_fp, _cuda.stream_of(x0)),
                "bicgstab_momentum")
    LAUNCHES += 1
    return out
