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
    if not R.is_cuda:
        return plane_strip_up_plain(R, B, ps, ec, cfg)
    m, nc = _check(R, B, ps, cfg, cfg.post_smoothing)
    _cuda.require(ec, (m // 2, nc), "ec")
    R2, B2 = torch.empty_like(R), torch.empty_like(B)
    tensors = [R, B, *_norm_arrays(ps), ec, R2, B2]
    _launch("nf_plane_strip_up", tensors, m, nc, cfg.post_smoothing, _cuda.stream_of(R))
    UP_LAUNCHES += 1
    return R2, B2
