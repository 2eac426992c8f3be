"""K10: the plane-resident fine multigrid level (``plane_strip_down`` /
``plane_strip_up``).

Replaces ``naviflow_tpu/ops/pallas_plane.py:plane_strip_down`` (K10a) and
``:plane_strip_up`` (K10b); the CUDA kernels are ``csrc/plane.cu`` (its
header says what bounds them on the H100 and how its 2-D tiles deal with
the global row parity and the halos).

* :func:`plane_strip_down`: ``cfg.pre_smoothing`` red-black sweeps on the
  diagonal-normalised planes, the normalised-form residual ``c * (bh - p -
  sum(link_hat * nbr))`` and its row-pair restriction of ``rR + rB`` to the
  STANDARD coarse layout, plus ``ps.rc_zdiag`` (the b term the normalised
  form drops at zero-diagonal cells), in one launch;
* :func:`plane_strip_up`: the clamped bilinear prolongation of the coarse
  correction into both planes (fused into the kernel's load, as K2 fuses
  its prolongation; the JAX wrapper composes it outside), then
  ``cfg.post_smoothing`` sweeps, in one launch.

The ``_plain`` versions are the Pallas kernel bodies: the down pass's
residual is the kernels' normalised form (``ops/plane.plane_fine_down``
uses the raw form), so that the card's kernel-against-plain comparison is
tight.  On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises.

The case axis (:func:`plane_strip_down_batched`,
:func:`plane_strip_up_batched`): B levels of one shape in one launch, the
grid's z axis over the cases, each case bit-equal to its single launch.
Under ``torch.func.vmap`` (alone) :func:`plane_strip_down` and
:func:`plane_strip_up` are their batching rules' entries.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .plane import (PlaneStencil5, _row_parity, plane_fine_up, plane_neighbors,
                    plane_neighbors_black, plane_rb_sweep, plane_restrict_cc)

# The TPU kernel's halo rows and its window cap in cells: a VMEM budget
# (14 half-width arrays per strip window), kept only so that the port
# launches K10 exactly where the reference does; not an H100 limit.
H = 8
_CAP_CELLS = 160 * 1024

DOWN_LAUNCHES = 0  # K10a
UP_LAUNCHES = 0  # K10b
DOWN_BATCH_LAUNCHES = 0  # their batched entries'
UP_BATCH_LAUNCHES = 0


def _plane_rows(m: int, nc: int) -> int:
    """The reference's strip height for (m, nc) planes: T = 64 first, then
    the other multiples of 16 whose window fits the cap; 0 if none does."""
    for T in (64, 96, 128, 48, 32, 16):
        if T + 2 * H > m or m % T:
            continue
        if (T + 2 * H) * nc <= _CAP_CELLS:
            return T
    return 0


def supports_plane_strip(m: int, nc: int, cfg, dtype) -> bool:
    """Gate (the reference's rule): float32 Gauss-Seidel with omega 1 and at
    most 2 pre/post sweeps, cell-centred full-weighting transfers, and a
    strip window that fits."""
    if dtype != torch.float32:
        return False
    if (cfg.smoother != "gs" or cfg.omega != 1.0
            or cfg.pre_smoothing > 2 or cfg.post_smoothing > 2
            or getattr(cfg, "smoother_dtype", "float32") != "float32"):
        return False
    if cfg.restriction != "full_weighting" or cfg.prolongation != "linear":
        return False
    return _plane_rows(m, nc) > 0


def _norm_arrays(ps: PlaneStencil5):
    """The 10 diagonal-normalised planes in kernel order."""
    return [ps.bh[0], ps.bh[1], ps.eh[0], ps.wh[0], ps.nh[0], ps.sh[0],
            ps.eh[1], ps.wh[1], ps.nh[1], ps.sh[1]]


def _residual_planes(R, B, ps: PlaneStencil5):
    """The Pallas kernel's normalised-form residual ``c * (bh - p -
    sum(link_hat * nbr))``, per colour."""
    odd = _row_parity(*R.shape, R.device)
    e, w, n, s = plane_neighbors(B, odd)
    rR = ps.c[0] * (ps.bh[0] - R - (ps.eh[0] * e + ps.wh[0] * w + ps.nh[0] * n + ps.sh[0] * s))
    e, w, n, s = plane_neighbors_black(R, odd)
    rB = ps.c[1] * (ps.bh[1] - B - (ps.eh[1] * e + ps.wh[1] * w + ps.nh[1] * n + ps.sh[1] * s))
    return rR, rB


def plane_strip_down_plain(R, B, ps: PlaneStencil5, cfg):
    """The Pallas down kernel's body: its sweeps are ``plane_rb_sweep``'s,
    its residual the normalised form, plus ``ps.rc_zdiag``."""
    for _ in range(cfg.pre_smoothing):
        R, B = plane_rb_sweep(R, B, ps)
    return R, B, plane_restrict_cc(*_residual_planes(R, B, ps)) + ps.rc_zdiag


def plane_strip_up_plain(R, B, ps: PlaneStencil5, ec, cfg):
    """The Pallas up kernel's body with its outside prolongation: exactly
    ``plane_fine_up``."""
    return plane_fine_up(R, B, ps, ec, cfg.post_smoothing)


def _check(R, B, ps, cfg, sweeps):
    m, nc = R.shape
    if m % 2:
        raise ValueError(f"plane strip kernels need an even row count, got {m}")
    if cfg.smoother != "gs" or cfg.omega != 1.0 or sweeps > 2:
        raise ValueError("plane strip kernels implement omega-1 Gauss-Seidel, "
                         "at most 2 sweeps")
    _cuda.require(R, (m, nc), "R")
    _cuda.require(B, (m, nc), "B")
    for k, a in enumerate(_norm_arrays(ps)):
        _cuda.require(a, (m, nc), f"normalised plane [{k}]")
    return m, nc


def _launch(name, tensors, m, nc, sweeps, stream):
    ptrs = (ctypes.c_longlong * len(tensors))(*[t.data_ptr() for t in tensors])
    ip = (ctypes.c_int * 3)(m, nc, sweeps)
    fp = (ctypes.c_float * 1)(0.0)
    _cuda.check(getattr(_cuda.library(), name)(ptrs, ip, fp, stream), name)


def plane_strip_down(R, B, ps: PlaneStencil5, cfg):
    """Plane-form fine-level down pass as one kernel.  Returns ``(R, B,
    r_coarse)`` with ``r_coarse`` in STANDARD coarse layout."""
    global DOWN_LAUNCHES
    if _cuda.under_vmap():
        return _DownCases.apply(R, B, *_norm_arrays(ps), ps.c[0], ps.c[1], ps.rc_zdiag, cfg)
    if not R.is_cuda:
        return plane_strip_down_plain(R, B, ps, cfg)
    m, nc = _check(R, B, ps, cfg, cfg.pre_smoothing)
    for k, a in enumerate(ps.c):
        _cuda.require(a, (m, nc), f"c[{k}]")
    _cuda.require(ps.rc_zdiag, (m // 2, nc), "rc_zdiag")
    R2, B2 = torch.empty_like(R), torch.empty_like(B)
    rc = torch.empty((m // 2, nc), dtype=R.dtype, device=R.device)
    tensors = [R, B, *_norm_arrays(ps), ps.c[0], ps.c[1], ps.rc_zdiag, R2, B2, rc]
    _launch("nf_plane_strip_down", tensors, m, nc, cfg.pre_smoothing, _cuda.stream_of(R))
    DOWN_LAUNCHES += 1
    return R2, B2, rc


def plane_strip_up(R, B, ps: PlaneStencil5, ec, cfg):
    """Plane-form fine-level up pass as one kernel: prolongated coarse
    correction + post-smoothing."""
    global UP_LAUNCHES
    if _cuda.under_vmap():
        return _UpCases.apply(R, B, ec, *_norm_arrays(ps), cfg)
    if not R.is_cuda:
        return plane_strip_up_plain(R, B, ps, ec, cfg)
    m, nc = _check(R, B, ps, cfg, cfg.post_smoothing)
    _cuda.require(ec, (m // 2, nc), "ec")
    R2, B2 = torch.empty_like(R), torch.empty_like(B)
    tensors = [R, B, *_norm_arrays(ps), ec, R2, B2]
    _launch("nf_plane_strip_up", tensors, m, nc, cfg.post_smoothing, _cuda.stream_of(R))
    UP_LAUNCHES += 1
    return R2, B2


# ---------------------------------------------------------------------------
# The case axis: B levels of one shape in one launch (grid z over the
# cases), each case bit-equal to its single launch.


class PlaneArrays:
    """The planes K10 reads, as :class:`~naviflow_tpu_torch.ops.plane.PlaneStencil5`
    holds them: the (red, black) pairs ``bh``, ``eh``, ``wh``, ``nh``, ``sh``
    from the ten normalised planes in kernel order, and (the down pass) the
    raw diagonal pair ``c`` and ``rc_zdiag``; with or without a leading case
    axis."""

    def __init__(self, norm, c=(None, None), rc_zdiag=None):
        bh0, bh1, eh0, wh0, nh0, sh0, eh1, wh1, nh1, sh1 = norm
        self.bh, self.eh, self.wh = (bh0, bh1), (eh0, eh1), (wh0, wh1)
        self.nh, self.sh = (nh0, nh1), (sh0, sh1)
        self.c, self.rc_zdiag = tuple(c), rc_zdiag

    def case(self, k):
        """Case ``k``'s planes."""
        def pick(x):
            return None if x is None else x[k]

        return PlaneArrays([pick(a) for a in _norm_arrays(self)], [pick(a) for a in self.c],
                           pick(self.rc_zdiag))


def plane_strip_down_batched_plain(R, B, ps, cfg, active=None):
    """The batched K10a's plain version (the CPU path and its oracle): case by
    case through :func:`plane_strip_down_plain`; a frozen case (``active``
    False) gets its R and B back and a zero coarse residual."""
    outs = [plane_strip_down_plain(R[k], B[k], ps.case(k), cfg) if on
            else (R[k], B[k], R.new_zeros((R.shape[1] // 2, R.shape[2])))
            for k, on in enumerate(_cuda.case_flags(active, R.shape[0]))]
    return tuple(torch.stack(xs) for xs in zip(*outs))


def plane_strip_up_batched_plain(R, B, ps, ec, cfg, active=None):
    """The batched K10b's plain version: case by case through
    :func:`plane_strip_up_plain`; a frozen case gets its R and B back."""
    outs = [plane_strip_up_plain(R[k], B[k], ps.case(k), ec[k], cfg) if on else (R[k], B[k])
            for k, on in enumerate(_cuda.case_flags(active, R.shape[0]))]
    return tuple(torch.stack(xs) for xs in zip(*outs))


class _BatchLaunch:
    """A batched entry's host arrays for one (device, stream, cases, shape,
    sweeps): the pointer slots (the single entry's, the active flags, then
    each slot's case stride; the outputs' strides filled once), the
    parameters with the case count, the outputs' offsets in one case's
    part of the buffer and its length, and the flags of a batch with no
    frozen case."""

    def __init__(self, n_in, m, nc, sweeps, cases, down, dev):
        cells = m * nc
        self.offsets = [0, cells] + ([2 * cells] if down else [])
        self.total = 2 * cells + (cells // 2 if down else 0)
        self.n_in = n_in
        self.half = n_in + len(self.offsets) + 1
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        self.ptrs[self.half + n_in:2 * self.half - 1] = [4 * self.total] * len(self.offsets)
        self.ip = (ctypes.c_int * 4)(m, nc, sweeps, cases)
        self.fp = (ctypes.c_float * 1)(0.0)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_DOWN_BATCH = {}
_UP_BATCH = {}


def _batched(name, cache, groups, R, sweeps, active, down):
    """Launch ``name`` over the cases: ``groups`` the inputs (lists of
    arrays of one shape, in slot order); returns the outputs (R, B and,
    down, rc), views of one fresh buffer."""
    cases, m, nc = R.shape
    if m % 2:
        raise ValueError(f"plane strip kernels need an even row count, got {m}")
    f32 = torch.float32
    dev, stream = R.device, _cuda.stream_of(R)
    key = (dev, stream, cases, m, nc, sweeps)
    st = cache.get(key)
    if st is None:
        if len(cache) >= 32:
            cache.clear()
        st = cache[key] = _BatchLaunch(sum(len(a) for a, _ in groups), m, nc, sweeps, cases,
                                       down, dev)
    k = _cuda.case_slots(st, groups, active, cases, name)
    buf = torch.empty((cases, st.total), dtype=f32, device=dev)
    base = buf.data_ptr()
    st.ptrs[k:st.half - 1] = [base + 4 * off for off in st.offsets]
    _cuda.check(getattr(_cuda.library(), name)(st.ptrs, st.ip, st.fp, stream), name)
    shapes = [(m, nc), (m, nc), (m // 2, nc)]
    return tuple(buf.as_strided((cases, *shp), (st.total, nc, 1), off)
                 for off, shp in zip(st.offsets, shapes))


def _batch_check(cfg, sweeps):
    if cfg.smoother != "gs" or cfg.omega != 1.0 or sweeps > 2:
        raise ValueError("plane strip kernels implement omega-1 Gauss-Seidel, "
                         "at most 2 sweeps")


def plane_strip_down_batched(R, B, ps, cfg, active=None):
    """:func:`plane_strip_down` of B levels of one shape in one launch: ``R``,
    ``B`` and the planes of ``ps`` (:class:`PlaneArrays` or a
    ``PlaneStencil5``) carry a leading case axis (each case's slice
    contiguous; a case stride of 0 shares one array), ``active`` (B,) bool:
    a frozen case's blocks copy R and B and zero its coarse residual (None:
    every case active).  Returns ``(R, B, r_coarse)`` with the case axis
    first, views of one fresh buffer."""
    global DOWN_BATCH_LAUNCHES
    if not R.is_cuda:
        return plane_strip_down_batched_plain(R, B, ps, cfg, active)
    _batch_check(cfg, cfg.pre_smoothing)
    _, m, nc = R.shape
    out = _batched("nf_plane_strip_down_batched", _DOWN_BATCH,
                   [([R, B, *_norm_arrays(ps), ps.c[0], ps.c[1]], (m, nc)),
                    ([ps.rc_zdiag], (m // 2, nc))], R, cfg.pre_smoothing, active, True)
    DOWN_BATCH_LAUNCHES += 1
    return out


def plane_strip_up_batched(R, B, ps, ec, cfg, active=None):
    """:func:`plane_strip_up` of B levels of one shape in one launch (the case
    axis as :func:`plane_strip_down_batched`; ``ec`` (B, m / 2, nc)); a
    frozen case's blocks copy R and B.  Returns ``(R, B)`` with the case
    axis first, views of one fresh buffer."""
    global UP_BATCH_LAUNCHES
    if not R.is_cuda:
        return plane_strip_up_batched_plain(R, B, ps, ec, cfg, active)
    _batch_check(cfg, cfg.post_smoothing)
    _, m, nc = R.shape
    out = _batched("nf_plane_strip_up_batched", _UP_BATCH,
                   [([R, B, *_norm_arrays(ps)], (m, nc)), ([ec], (m // 2, nc))], R,
                   cfg.post_smoothing, active, False)
    UP_BATCH_LAUNCHES += 1
    return out


class _DownCases(torch.autograd.Function):
    """K10a's batching rule: under ``torch.func.vmap`` every case's level
    goes into one :func:`plane_strip_down_batched` call with the active
    flags of ``_cuda.case_mask``; an operand shared by every case gets case
    stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(R, B, *args):
        *arrays, cfg = args
        return plane_strip_down(R, B, PlaneArrays(arrays[:10], arrays[10:12], arrays[12]), cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, cfg = args
        R, B, *arrays = (_cuda.case_first(a, d, cases) for a, d in zip(arrays, in_dims))
        out = plane_strip_down_batched(R, B, PlaneArrays(arrays[:10], arrays[10:12],
                                                         arrays[12]), cfg,
                                       active=_cuda.active_cases(cases))
        return out, (0, 0, 0)


class _UpCases(torch.autograd.Function):
    """K10b's batching rule, as :class:`_DownCases` for
    :func:`plane_strip_up_batched`."""

    generate_vmap_rule = False

    @staticmethod
    def forward(R, B, ec, *args):
        *arrays, cfg = args
        return plane_strip_up(R, B, PlaneArrays(arrays), ec, cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, cfg = args
        R, B, ec, *arrays = (_cuda.case_first(a, d, cases) for a, d in zip(arrays, in_dims))
        out = plane_strip_up_batched(R, B, PlaneArrays(arrays), ec, cfg,
                                     active=_cuda.active_cases(cases))
        return out, (0, 0)
