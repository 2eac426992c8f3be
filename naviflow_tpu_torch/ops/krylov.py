"""K7: the whole masked BiCGSTAB of one momentum field, in one launch.

Replaces ``naviflow_tpu/ops/pallas_krylov.py:bicgstab_momentum_pallas``; the
CUDA kernels are ``csrc/krylov.cu`` (the source says what bounds them on
the H100), chosen by shape (:func:`band_layout`):

* where the band of every array fits a CTA's shared memory (the 63^2
  headline's fields and up to about 128^2): one thread-block cluster whose
  CTAs each own a band of rows, with three cluster reductions an
  iteration;
* larger fields: the solve of ``csrc/krylov.cuh`` over a cooperative grid
  of as many blocks as fit on the SMs (the band scheme in global memory
  was slower there: 16 SMs walking the L2 lose to 132).

Both sum each dot in the same order in every CTA or block, so the stopping
test and the breakdown guards agree everywhere; the dots and the stopping
norm are compensated (``ops/compensated.py``), as the reference kernel's
are.

The plain version is ``solvers/momentum._bicgstab_masked`` with
``compensated_dots=True``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .mg import CL_RED_FLOATS, SMEM_MAX, _cached, _padded_bytes
from .stencil import StencilCoeffs, interior_mask

# The TPU kernel's per-field VMEM cap (x + 5 Krylov vectors + 6 coefficient
# arrays); kept so the port dispatches as the reference does.
MAX_FIELD_BYTES = 2**20

# csrc/krylov.cu: the arrays of a CTA's band (KbArray); the vectors of the
# cooperative grid kernel's scratch, then its reduction partials (coop.cuh:
# 2 buffers x NF_RED_SLOTS x NF_MAX_BLOCKS floats)
BAND_ARRAYS = ("a_e", "a_w", "a_n", "a_s", "a_p", "src", "x", "r", "rhat", "p0", "p1",
               "v0", "v1", "s", "t")
GRID_VECTORS = ("r", "rhat", "v", "p", "s", "t")
GRID_RED_FLOATS = 2 * 8 * 1024

LAUNCHES = 0


def supports_fused_bicgstab(shape, dtype) -> bool:
    if dtype != torch.float32:
        return False
    return _padded_bytes(*shape) <= MAX_FIELD_BYTES


def band_layout(shape, size):
    """``(rows, band, smem_bytes)`` of K7's launch on a field of ``shape``
    for a cluster of ``size`` CTAs: the most rows a CTA's band has; whether
    every array's band, with a halo row above and below, fits the cluster
    launch's shared memory (``csrc/krylov.cu`` ``kb_smem_floats``), which
    selects the cluster kernel (else the cooperative grid); and that
    kernel's dynamic shared memory (the grid kernel's: 0)."""
    ni, nj = shape
    rows = -(-ni // size)
    nbytes = 4 * (CL_RED_FLOATS + len(BAND_ARRAYS) * (rows + 2) * nj)
    if nbytes <= SMEM_MAX:
        return rows, True, nbytes
    return rows, False, 0


def grid_scratch_floats(shape):
    """Floats of the cooperative grid kernel's scratch: its Krylov vectors,
    then the reduction partials."""
    return len(GRID_VECTORS) * shape[0] * shape[1] + GRID_RED_FLOATS


def bicgstab_momentum_plain(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                            margins=(1, 1, 1, 1)):
    from ..solvers.momentum import _bicgstab_masked

    mask = interior_mask(x0.shape, *margins, device=x0.device)
    return _bicgstab_masked(x0, c, mask, tol, maxiter, compensated_dots=True)


def cluster_size(device=None) -> int:
    """The thread-block cluster size K7's band kernel launches with on
    ``device`` (16 where one such cluster fits on the card, else 8)."""
    with torch.cuda.device(device):
        size = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_bicgstab_cluster_size(ctypes.byref(size)),
                    "bicgstab_cluster_size")
    return size.value


class _Launch:
    """K7's launch state for one (device, stream, shape, maxiter, margins,
    tol): the pointer array (x0, the six coefficient arrays and the output
    filled per call), the parameter arrays and, for the grid kernel, its
    scratch."""

    def __init__(self, shape, maxiter, margins, tol, dev):
        _, band, _ = band_layout(shape, cluster_size(dev))
        self.scratch = None if band else torch.empty(
            grid_scratch_floats(shape), dtype=torch.float32, device=dev)
        self.ptrs = (ctypes.c_longlong * 9)()
        self.ptrs[8] = 0 if band else self.scratch.data_ptr()
        self.ip = (ctypes.c_int * 8)(*shape, maxiter, *margins, int(band))
        self.fp = (ctypes.c_float * 1)(tol)


_LAUNCH = {}


def bicgstab_momentum(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                      margins=(1, 1, 1, 1)):
    """Whole-solve masked BiCGSTAB of ``A x = src`` on the nodes inside
    ``margins`` (lo_i, hi_i, lo_j, hi_j); other nodes keep ``x0``.  The
    launch state is reused across calls with the same shape and
    parameters on one device and stream."""
    global LAUNCHES
    if not x0.is_cuda:
        return bicgstab_momentum_plain(x0, c, tol=tol, maxiter=maxiter, margins=margins)
    shape = tuple(x0.shape)
    arrays = (x0, c.a_e, c.a_w, c.a_n, c.a_s, c.a_p, c.src)
    _cuda.require_all(arrays, shape, "bicgstab_momentum x0, coefficients")
    dev, stream = x0.device, _cuda.stream_of(x0)
    st = _cached(_LAUNCH, (dev, stream, shape, maxiter, tuple(margins), tol),
                 lambda: _Launch(shape, maxiter, margins, tol, dev))
    out = torch.empty_like(x0)
    st.ptrs[:8] = [a.data_ptr() for a in arrays] + [out.data_ptr()]
    _cuda.check(_cuda.library().nf_bicgstab(st.ptrs, st.ip, st.fp, stream),
                "bicgstab_momentum")
    LAUNCHES += 1
    return out
