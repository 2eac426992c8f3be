"""Multigrid kernels over a whole level hierarchy, each one launch.

* K3 :func:`fused_vcycle` — one V-cycle (replaces
  ``naviflow_tpu/ops/pallas_mg.py:fused_vcycle``);
* K4 :func:`galerkin_levels` — every Galerkin coarse stencil of an odd
  (vertex) hierarchy (replaces ``pallas_mg.py:galerkin_levels_pallas``);
* K5 :func:`fused_mg_solve` — the whole multigrid solve: cycles,
  convergence checks, mean normalisation and residual (replaces
  ``pallas_mg.py:fused_mg_solve``).

The CUDA kernels are ``csrc/mg.cu`` over the device code of ``csrc/mg.cuh``
(cooperative launches with grid-wide barriers between passes; the header
says what bounds them on the H100).  Each wrapper runs its plain PyTorch
version on a CPU tensor and launches its kernel, or raises, on a CUDA one.

The gates are the reference's admission rules, with their TPU VMEM
budgets kept so that the port splits the work as the reference does; they
are not H100 limits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .compensated import fold_norm2
from .stencil9 import Stencil9, apply_five, galerkin_coarsen
from .transfer import prolong_linear, restrict_full_weighting

# The TPU kernels' whole-hierarchy VMEM budget (K3, K4, K5).
VMEM_BUDGET_BYTES = 8 * 2**20

_MAX_LEVELS = 16  # csrc/mg.cuh NF_MAX_LEVELS
# reduction scratch of the cooperative kernels (csrc/coop.cuh: 2 buffers x
# NF_RED_SLOTS x NF_MAX_BLOCKS floats)
RED_FLOATS = 2 * 8 * 1024

LAUNCHES = 0  # K3
RAP_LAUNCHES = 0  # K4
SOLVE_LAUNCHES = 0  # K5

_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def _padded_bytes(nx, ny):
    """f32 footprint of an (nx, ny) array under the TPU's (8, 128) tiling."""
    return (-(-nx // 8) * 8) * (-(-ny // 128) * 128) * 4


def supports_fused(levels, cfg) -> bool:
    """True when the (levels, cfg) combination is one the fused V-cycle and
    the fused solve take (the reference's rule)."""
    if (cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs"
            or cfg.restriction != "full_weighting"
            or cfg.prolongation != "linear"
            or getattr(cfg, "smoother_dtype", "float32") != "float32"):
        return False
    total = 0
    for st, (nx, ny), five, _ in levels:
        if nx != ny or st.c.dtype != torch.float32:
            return False
        total += ((5 if five else 9) + 3) * _padded_bytes(nx, ny)
    for (_, (nf, _), _, _), (_, (nc, _), _, _) in zip(levels, levels[1:]):
        if nf not in (2 * nc, 2 * nc + 1):
            return False
    return total <= VMEM_BUDGET_BYTES


def supports_fused_rap(nx, ny, cfg, dtype) -> bool:
    """K4 gate: odd square vertex grids, default transfers, f32, the whole
    hierarchy plus fine-shape temporaries within the TPU budget."""
    if dtype != torch.float32:
        return False
    if (cfg.restriction != "full_weighting" or cfg.prolongation != "linear"
            or cfg.coarsening != "galerkin"):
        return False
    if nx != ny or nx % 2 == 0:
        return False
    return 14 * _padded_bytes(nx, ny) <= VMEM_BUDGET_BYTES


def _check_hierarchy(levels):
    if len(levels) > _MAX_LEVELS:
        raise ValueError(f"the multigrid kernels take at most {_MAX_LEVELS} levels")
    for (_, (nf, mf), _, _), (_, (nc, mc), _, _) in zip(levels, levels[1:]):
        if (nf, mf) not in ((2 * nc, 2 * mc), (2 * nc + 1, 2 * mc + 1)):
            raise ValueError(f"no transfer pair for {(nf, mf)} -> {(nc, mc)}")


def _stencil_arrays(st, five):
    return [getattr(st, k) for k in (_NAMES[:5] if five else _NAMES)]


def pack_levels(levels, x0, b, keep):
    """Device pointers and integer parameters of a hierarchy, in the order
    of ``csrc/mg.cuh`` (per level: 9 stencil pointers, 0 for absent
    corners, then x and rhs; ni, nj, five).  Level 0's iterate is ``x0``
    (updated in place) and its right-hand side ``b``; coarser iterates and
    right-hand sides are scratch appended to ``keep``."""
    ptrs, ip = [], []
    for lvl, (st, (ni, nj), five, _) in enumerate(levels):
        arrays = _stencil_arrays(st, five)
        for k, a in enumerate(arrays):
            _cuda.require(a, (ni, nj), f"level {lvl} stencil[{k}]")
        if lvl == 0:
            x, rhs = x0, b
        else:
            x = torch.empty((ni, nj), dtype=torch.float32, device=x0.device)
            rhs = torch.empty_like(x)
            keep += [x, rhs]
        ptrs += [a.data_ptr() for a in arrays] + [0] * (9 - len(arrays))
        ptrs += [x.data_ptr(), rhs.data_ptr()]
        ip += [ni, nj, int(five)]
    return ptrs, ip


def fused_vcycle_plain(p, b, levels, cfg):
    from ..solvers.multigrid import _cycle

    return _cycle(p, b, levels, 0, cfg)


def fused_vcycle(p, b, levels, cfg):
    """One V-cycle at level 0 of ``levels`` (drop-in for
    ``multigrid._cycle(p, b, levels, 0, cfg)``), as one kernel launch."""
    global LAUNCHES
    if not p.is_cuda:
        return fused_vcycle_plain(p, b, levels, cfg)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_vcycle implements Gauss-Seidel V-cycles only")
    _check_hierarchy(levels)
    out = p.clone()  # level 0's iterate, updated in place by the kernel
    _cuda.require(b, out.shape, "b")
    keep = [out]  # every buffer must outlive the launch call
    ptrs, lv_ip = pack_levels(levels, out, b, keep)
    ip = [len(levels), cfg.pre_smoothing, cfg.post_smoothing, cfg.coarsest_sweeps] + lv_ip
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * 1)(cfg.omega)
    _cuda.check(_cuda.library().nf_fused_vcycle(c_ptrs, c_ip, c_fp, _cuda.stream_of(p)),
                "fused_vcycle")
    LAUNCHES += 1
    return out


def galerkin_levels_plain(fine_st: Stencil9, shapes, fine_five: bool):
    """The composed chain: ``galerkin_coarsen`` level by level with the
    vertex full-weighting / bilinear transfers."""
    del fine_five  # a 5-point fine stencil carries zero corners
    out, st = [], fine_st
    for (nxc, nyc) in shapes[1:]:
        st = galerkin_coarsen(st, restrict_full_weighting, prolong_linear, nxc, nyc)
        out.append(st)
    return out


def galerkin_levels(fine_st: Stencil9, shapes, fine_five: bool):
    """Every Galerkin coarse stencil of the vertex hierarchy ``shapes``
    (finest first) in one launch.  Returns one :class:`Stencil9` per coarse
    level; the kernel computes each coarse entry directly from the fine
    stencil and the transfer weights in f32 (no comb, no matrix product)."""
    global RAP_LAUNCHES
    if not fine_st.c.is_cuda:
        return galerkin_levels_plain(fine_st, shapes, fine_five)
    shapes = [tuple(s) for s in shapes]
    if len(shapes) < 2 or len(shapes) > _MAX_LEVELS:
        raise ValueError(f"galerkin_levels takes 2..{_MAX_LEVELS} shapes")
    for (nf, mf), (nc, mc) in zip(shapes, shapes[1:]):
        if (nf, mf) != (2 * nc + 1, 2 * mc + 1):
            raise ValueError(f"galerkin_levels: {(nf, mf)} -> {(nc, mc)} is not a vertex pair")
    arrays = _stencil_arrays(fine_st, fine_five)
    for k, a in enumerate(arrays):
        _cuda.require(a, shapes[0], f"fine stencil[{k}]")
    dev = fine_st.c.device
    outs = [[torch.empty(shp, dtype=torch.float32, device=dev) for _ in range(9)]
            for shp in shapes[1:]]
    ptrs = [a.data_ptr() for a in arrays] + [0] * (9 - len(arrays))
    ptrs += [t.data_ptr() for lvl in outs for t in lvl]
    ip = [len(shapes), int(fine_five)] + [n for shp in shapes for n in shp]
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * 1)(0.0)
    _cuda.check(_cuda.library().nf_galerkin_levels(c_ptrs, c_ip, c_fp,
                                                   _cuda.stream_of(fine_st.c)),
                "galerkin_levels")
    RAP_LAUNCHES += 1
    return [Stencil9(**dict(zip(_NAMES, lvl))) for lvl in outs]


def fused_mg_solve_plain(p0, b, levels, cfg, *, mean_normalize: bool = True):
    """The whole solve loop composed, with the reference kernel's
    compensated norms: ``check_every`` V-cycles per check, stop on
    ``cycles >= max_cycles`` or ``rel < tolerance``."""
    from ..solvers.multigrid import _cycle

    st0, _, five0, _ = levels[0]
    bnorm = torch.sqrt(fold_norm2(b))
    safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    p, cycles = p0, 0
    rel = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    while cycles < cfg.max_cycles and float(rel) >= cfg.tolerance:
        for _ in range(cfg.check_every):
            p = _cycle(p, b, levels, 0, cfg)
        rel = torch.sqrt(fold_norm2(b - apply_five(p, st0, five0))) / safe_b
        cycles += cfg.check_every
    if mean_normalize:
        p = p - torch.mean(p)
    cyc = torch.tensor(cycles, dtype=torch.int32, device=b.device)
    return p, b - apply_five(p, st0, five0), cyc, rel


def fused_mg_solve(p0, b, levels, cfg, *, mean_normalize: bool = True):
    """The whole ``multigrid_solve`` loop as one kernel launch.  Returns
    ``(p, r_field, cycles, rel)`` with the scalars as 0-d tensors (int32
    and float) on the device.  Gate with :func:`supports_fused`."""
    global SOLVE_LAUNCHES
    if not p0.is_cuda:
        return fused_mg_solve_plain(p0, b, levels, cfg, mean_normalize=mean_normalize)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_mg_solve implements Gauss-Seidel V-cycles only")
    _check_hierarchy(levels)
    p = p0.clone()
    _cuda.require(p, levels[0][1], "p0")
    _cuda.require(b, levels[0][1], "b")
    dev = p.device
    r = torch.empty_like(p)
    cycles = torch.empty((), dtype=torch.int32, device=dev)
    rel = torch.empty((), dtype=torch.float32, device=dev)
    red = torch.empty((RED_FLOATS,), dtype=torch.float32, device=dev)
    keep = [p, r, cycles, rel, red]
    ptrs, lv_ip = pack_levels(levels, p, b, keep)
    ptrs += [r.data_ptr(), cycles.data_ptr(), rel.data_ptr(), red.data_ptr()]
    ip = [len(levels), cfg.pre_smoothing, cfg.post_smoothing, cfg.coarsest_sweeps,
          cfg.max_cycles, cfg.check_every, int(mean_normalize)] + lv_ip
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * 2)(cfg.omega, cfg.tolerance)
    _cuda.check(_cuda.library().nf_fused_mg_solve(c_ptrs, c_ip, c_fp, _cuda.stream_of(p)),
                "fused_mg_solve")
    SOLVE_LAUNCHES += 1
    return p, r, cycles, rel
