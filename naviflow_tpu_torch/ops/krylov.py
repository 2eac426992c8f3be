"""K7: the whole masked BiCGSTAB of one momentum field, in one launch.

Replaces ``naviflow_tpu/ops/pallas_krylov.py:bicgstab_momentum_pallas``; the
CUDA kernels are ``csrc/krylov.cu`` (the source says what bounds them on
the H100), chosen by shape (:func:`band_layout`):

* where the band of every array fits a CTA's shared memory (the 63^2
  headline's fields and up to about 128^2): one thread-block cluster whose
  CTAs each own a band of rows, with three cluster reductions an
  iteration;
* larger fields: the solve of ``csrc/krylov.cuh`` over a cooperative grid
  of as many blocks as fit on the SMs, four an SM (the band scheme in
  global memory was slower there: 16 SMs walking the L2 lose to 132).

Both sum each dot in the same order in every CTA or block, so the stopping
test and the breakdown guards agree everywhere; the dots and the stopping
norm are compensated (``ops/compensated.py``), as the reference kernel's
are.

The plain version is ``solvers/momentum._bicgstab_masked`` with
``compensated_dots=True``.

The case axis (:func:`bicgstab_momentum_batched`): B fields of one shape in
one launch, each case bit-equal to its single launch, a frozen case given
x0 back: where the band fits, one launch of the band kernel
(``csrc/krylov.cu`` ``nf_bicgstab_batched``), one cluster a case; larger
fields, one cooperative launch of the grid kernel for every case
(``nf_bicgstab_grid_batched``) at the single launch's block count, each
block covering the same cells of every case, each case's sums in its own
partials, one grid barrier for every case.  Under
``torch.func.vmap`` (alone) :func:`bicgstab_momentum` is its batching
rule's entry.

Counters: ``LAUNCHES`` every single launch, ``GRID_LAUNCHES`` those of the
grid kernel among them; ``BATCH_LAUNCHES`` every batched launch,
``GRID_BATCH_LAUNCHES`` those of the grid kernel among them.
"""

from __future__ import annotations

import ctypes
import dataclasses

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
GRID_LAUNCHES = 0
BATCH_LAUNCHES = 0
GRID_BATCH_LAUNCHES = 0


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
    parameters on one device and stream.  Under ``torch.func.vmap`` alone
    every case goes into one :func:`bicgstab_momentum_batched` call."""
    global LAUNCHES, GRID_LAUNCHES
    if _cuda.under_vmap():
        return _BicgstabCases.apply(x0, *_coeff_arrays(c), (tol, maxiter, tuple(margins)))
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
    GRID_LAUNCHES += st.scratch is not None
    return out


def _coeff_arrays(c: StencilCoeffs):
    return [getattr(c, f.name) for f in dataclasses.fields(c)]


def _case_coeffs(c: StencilCoeffs, b: int) -> StencilCoeffs:
    return StencilCoeffs(*(a[b] for a in _coeff_arrays(c)))


def bicgstab_momentum_batched_plain(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                                    margins=(1, 1, 1, 1), active=None):
    """The batched kernel's plain version (the CPU path and its oracle):
    case by case through :func:`bicgstab_momentum_plain`; a frozen case
    (``active`` False) gets ``x0`` back."""
    flags = _cuda.case_flags(active, x0.shape[0])
    return torch.stack([
        bicgstab_momentum_plain(x0[b], _case_coeffs(c, b), tol=tol, maxiter=maxiter,
                                margins=margins) if on else x0[b]
        for b, on in enumerate(flags)])


class _BatchLaunch:
    """The batched launch state for one (device, stream, shape, maxiter,
    margins, tol, cases): the pointer array (``nf_bicgstab``'s nine slots,
    the active flags, then each slot's case stride; the inputs and outputs
    filled per call), the parameters with the case count, the flags of a
    batch with no frozen case and, for the grid kernel, every case's
    scratch (the single launch's, B of them)."""

    def __init__(self, shape, maxiter, margins, tol, cases, dev):
        self.band = band_layout(shape, cluster_size(dev))[1]
        self.ptrs = (ctypes.c_longlong * 20)()
        self.ip = (ctypes.c_int * 9)(*shape, maxiter, *margins, int(self.band), cases)
        self.fp = (ctypes.c_float * 1)(tol)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)
        self.scratch = None
        if not self.band:
            per_case = grid_scratch_floats(shape)
            self.scratch = torch.empty((cases, per_case), dtype=torch.float32, device=dev)
            self.ptrs[8], self.ptrs[18] = self.scratch.data_ptr(), 4 * per_case


_BATCH = {}


def bicgstab_momentum_batched(x0, c: StencilCoeffs, *, tol: float, maxiter: int,
                              margins=(1, 1, 1, 1), active=None):
    """:func:`bicgstab_momentum` of B cases (the leading axis of ``x0`` and
    of every coefficient array; each case's slice contiguous, a case stride
    of 0 shares one array) in one launch: one cluster a case where the band
    fits, else one cooperative grid for every case; ``active`` (B,) bool: a
    frozen case gets ``x0`` back and skips its work (None: every case
    active).  Returns (B, *shape)."""
    global BATCH_LAUNCHES, GRID_BATCH_LAUNCHES
    if not x0.is_cuda:
        return bicgstab_momentum_batched_plain(x0, c, tol=tol, maxiter=maxiter,
                                               margins=margins, active=active)
    cases, shape = x0.shape[0], tuple(x0.shape[1:])
    dev, stream = x0.device, _cuda.stream_of(x0)
    st = _cached(_BATCH, (dev, stream, shape, maxiter, tuple(margins), tol, cases),
                 lambda: _BatchLaunch(shape, maxiter, margins, tol, cases, dev))
    out = torch.empty((cases, *shape), dtype=torch.float32, device=dev)
    flags = st.ones if active is None else active
    ptrs, arrays = st.ptrs, (x0, *_coeff_arrays(c), out)
    ptrs[10:18] = _cuda.case_strides(arrays, cases, shape, torch.float32,
                                     "bicgstab_momentum_batched x0, coefficients, out")
    ptrs[:8] = [a.data_ptr() for a in arrays]
    ptrs[19] = _cuda.case_stride(flags, cases, (), torch.bool, "active")
    ptrs[9] = flags.data_ptr()
    lib = _cuda.library()
    if st.band:
        _cuda.check(lib.nf_bicgstab_batched(ptrs, st.ip, st.fp, stream),
                    "bicgstab_momentum_batched")
    else:
        _cuda.check(lib.nf_bicgstab_grid_batched(ptrs, st.ip, st.fp, stream),
                    "bicgstab_momentum_batched (grid)")
        GRID_BATCH_LAUNCHES += 1
    BATCH_LAUNCHES += 1
    return out


class _BicgstabCases(torch.autograd.Function):
    """K7's batching rule: under ``torch.func.vmap`` every case of the
    solve goes into one :func:`bicgstab_momentum_batched` call with the
    active flags of ``_cuda.case_mask``; an operand shared by every case
    gets case stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x0, a_e, a_w, a_n, a_s, a_p, src, opts):
        tol, maxiter, margins = opts
        return bicgstab_momentum(x0, StencilCoeffs(a_e, a_w, a_n, a_s, a_p, src), tol=tol,
                                 maxiter=maxiter, margins=margins)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        x0, *cs = (_cuda.case_first(a, d, cases) for a, d in zip(args[:7], in_dims[:7]))
        tol, maxiter, margins = args[7]
        out = bicgstab_momentum_batched(x0, StencilCoeffs(*cs), tol=tol, maxiter=maxiter,
                                        margins=margins, active=_cuda.active_cases(cases))
        return out, 0
