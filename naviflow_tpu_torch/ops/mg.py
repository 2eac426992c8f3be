"""Multigrid kernels over a whole level hierarchy, each one launch.

* K3 :func:`fused_vcycle` — one V-cycle (replaces
  ``naviflow_tpu/ops/pallas_mg.py:fused_vcycle``);
* K4 :func:`galerkin_levels` — every Galerkin coarse stencil of an odd
  (vertex) hierarchy (replaces ``pallas_mg.py:galerkin_levels_pallas``);
* K5 :func:`fused_mg_solve` — the whole multigrid solve: cycles,
  convergence checks, mean normalisation and residual (replaces
  ``pallas_mg.py:fused_mg_solve``).

The CUDA kernels are ``csrc/mg.cu``, one thread-block cluster each: K3
and K5 over the device code of ``csrc/vcycle.cuh`` (the levels of <= 1,024
cells in one CTA's shared memory, the coarsest in one warp's registers;
K5's convergence checks are cluster reductions), K4 over
``csrc/cluster.cuh``'s RAP (K6's: every coarse level's entries spread over
the cluster, one cluster barrier a level); the sources say what bounds them
on the H100.  Each wrapper runs its plain PyTorch version on a CPU tensor
and launches its kernel, or raises, on a CUDA one, and keeps its host
arrays (K3's and K5's with their scratch) per hierarchy layout.

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


def fused_vcycle_plain(p, b, levels, cfg):
    from ..solvers.multigrid import _cycle

    return _cycle(p, b, levels, 0, cfg)


# K3's launch (csrc/vcycle.cuh): the integer parameters before the
# per-level (ni, nj, five) triples (NfVcIp), the cells a level may have to
# live in rank 0's shared memory (coop.cuh NF_SMALL_CELLS), the dynamic
# shared memory a cluster launch may ask for (cluster.cuh NF_CL_SMEM_MAX)
VC_IP = ("levels", "pre", "post", "coarsest", "first_shared")
SMALL_CELLS = 1024
SMEM_MAX = 96 * 1024
# K5's integer parameters after VC_IP's (NfMsIp); the floats of the
# cluster reductions' partials before its levels (cluster.cuh
# NF_CL_RED_FLOATS: two buffers of NF_RED_SLOTS floats for each of 16 CTAs)
MS_IP = ("max_cycles", "check_every", "mean_normalize")
CL_RED_FLOATS = 2 * 8 * 16


def vcycle_layout(shapes):
    """``(Ls, smem_bytes)`` of K3's launch for level ``shapes`` (finest
    first): ``Ls`` is the first level below level 0 from which every level
    has at most ``SMALL_CELLS`` cells (``len(shapes)`` if none), the levels
    that live in shared memory; the bytes are their storage (nine stencil
    arrays, x and rhs each) and the residual scratch of ``Ls``'s size
    (csrc/vcycle.cuh ``nf_vc_smem_floats``)."""
    cells = [a * b for a, b in shapes]
    first = len(cells)
    for lvl in range(len(cells) - 1, 0, -1):
        if cells[lvl] > SMALL_CELLS:
            break
        first = lvl
    if first == len(cells):
        return first, 0
    return first, 4 * (cells[first] + 11 * sum(cells[first:]))


def mg_solve_layout(shapes):
    """``(Ls, smem_bytes)`` of K5's launch: K3's levels after the
    reductions' partials."""
    first, nbytes = vcycle_layout(shapes)
    return first, 4 * CL_RED_FLOATS + nbytes


class _VcLaunch:
    """K3's or K5's launch state for one hierarchy layout: the pointer array
    (the stencils of the last hierarchy, the global coarse levels' scratch;
    ``tail`` per-call slots after the levels'), the parameter arrays (the
    ``ip_tail`` integers after NfVcIp's five, the floats ``fp``) and the
    scratch."""

    def __init__(self, levels, cfg, dev, tail, ip_tail=(), fp=None, solve=False):
        _check_hierarchy(levels)
        shapes = [tuple(shp) for _, shp, _, _ in levels]
        first, smem = (mg_solve_layout if solve else vcycle_layout)(shapes)
        if smem > SMEM_MAX:
            raise ValueError(f"{'fused_mg_solve' if solve else 'fused_vcycle'}: {smem} bytes "
                             f"of shared memory for the levels from {shapes[first]}, more "
                             f"than {SMEM_MAX}")
        L = self.L = len(levels)
        self.scratch = [torch.empty((2, *shapes[lvl]), dtype=torch.float32, device=dev)
                        for lvl in range(1, first)]
        self.ptrs = (ctypes.c_longlong * (11 * L + tail))()
        for lvl, xr in enumerate(self.scratch, start=1):
            self.ptrs[11 * lvl + 9] = xr[0].data_ptr()
            self.ptrs[11 * lvl + 10] = xr[1].data_ptr()
        ip = [L, cfg.pre_smoothing, cfg.post_smoothing, cfg.coarsest_sweeps, first, *ip_tail]
        ip += [n for shp, (_, _, five, _) in zip(shapes, levels) for n in (*shp, int(five))]
        self.ip = (ctypes.c_int * len(ip))(*ip)
        fp = (cfg.omega,) if fp is None else fp
        self.fp = (ctypes.c_float * len(fp))(*fp)
        self.stencils = None

    def set_stencils(self, levels):
        """Point the stencil slots at ``levels``' arrays (checked), unless
        they hold this hierarchy's already (the same frozen Stencil9s)."""
        sts = [st for st, _, _, _ in levels]
        if self.stencils is not None and all(a is b for a, b in zip(sts, self.stencils)):
            return
        slots = []
        for lvl, (st, shp, five, _) in enumerate(levels):
            arrays = _stencil_arrays(st, five)
            _cuda.require_all(arrays, shp, f"level {lvl} stencil")
            slots.append([a.data_ptr() for a in arrays] + [0] * (9 - len(arrays)))
        for lvl, row in enumerate(slots):
            self.ptrs[11 * lvl:11 * lvl + 9] = row
        self.stencils = sts


_VC = {}
_SOLVE = {}
_CACHE_MAX = 32


def _layout_key(levels, cfg):
    return (tuple(tuple(lv[1]) + (bool(lv[2]),) for lv in levels),
            cfg.pre_smoothing, cfg.post_smoothing, cfg.coarsest_sweeps, cfg.omega)


def _cached(cache, key, make):
    st = cache.get(key)
    if st is None:
        if len(cache) >= _CACHE_MAX:
            cache.clear()
        st = cache[key] = make()
    return st


def _vc_launch(p, b, levels, cfg, timers=None):
    """One K3 launch (the timed instantiation where ``timers`` is given):
    returns level 0's iterate after the cycle, a fresh tensor."""
    dev, stream = p.device, _cuda.stream_of(p)
    timed = timers is not None
    st = _cached(_VC, (dev, stream, timed) + _layout_key(levels, cfg),
                 lambda: _VcLaunch(levels, cfg, dev, 1 + int(timed)))
    st.set_stencils(levels)
    _cuda.require_all((p, b), levels[0][1], "fused_vcycle p, b")
    out = torch.empty_like(p)
    ptrs, L = st.ptrs, st.L
    ptrs[9], ptrs[10], ptrs[11 * L] = out.data_ptr(), b.data_ptr(), p.data_ptr()
    entry = "nf_fused_vcycle"
    if timed:
        ptrs[11 * L + 1] = timers.data_ptr()
        entry = "nf_fused_vcycle_phases"
    _cuda.check(getattr(_cuda.library(), entry)(ptrs, st.ip, st.fp, stream), entry)
    return out


def fused_vcycle(p, b, levels, cfg):
    """One V-cycle at level 0 of ``levels`` (drop-in for
    ``multigrid._cycle(p, b, levels, 0, cfg)``), as one kernel launch.  The
    launch state is reused across calls with the same level layout and
    configuration; the stencil pointers are refilled when the hierarchy
    changes."""
    global LAUNCHES
    if not p.is_cuda:
        return fused_vcycle_plain(p, b, levels, cfg)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_vcycle implements Gauss-Seidel V-cycles only")
    out = _vc_launch(p, b, levels, cfg)
    LAUNCHES += 1
    return out


def vcycle_cluster_size(device=None) -> int:
    """The thread-block cluster size K3 launches with on ``device`` (16
    where one such cluster fits on the card, else 8)."""
    with torch.cuda.device(device):
        size = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_vcycle_cluster_size(0, ctypes.byref(size)),
                    "vcycle_cluster_size")
    return size.value


# the phases of nf_fused_vcycle_phases (csrc/vcycle.cuh NfVcPhase), in order
VC_PHASE_NAMES = ("down", "small", "coarsest", "up")
N_VC_TIMERS = 2 * len(VC_PHASE_NAMES) + 1


def decode_vcycle_phases(buf):
    """The phase-timer buffer of ``nf_fused_vcycle_phases`` (per phase the
    summed ns, then per phase the count, then the last stamp) as
    ``{name: (ms, count)}``."""
    vals = [int(x) for x in buf]
    n = len(VC_PHASE_NAMES)
    if len(vals) != N_VC_TIMERS:
        raise ValueError(f"expected {N_VC_TIMERS} timer slots, got {len(vals)}")
    return {name: (vals[k] / 1e6, vals[n + k]) for k, name in enumerate(VC_PHASE_NAMES)}


def fused_vcycle_phases(p, b, levels, cfg):
    """:func:`fused_vcycle` through the instantiation with phase timers
    (``nf_fused_vcycle_phases``), a measurement aid: CUDA tensors only, not
    counted in ``LAUNCHES``.  Returns the cycle's output and
    :func:`decode_vcycle_phases` of its timers (after a synchronise)."""
    timers = torch.zeros(N_VC_TIMERS, dtype=torch.int64, device=p.device)
    out = _vc_launch(p, b, levels, cfg, timers)
    return out, decode_vcycle_phases(timers.cpu())


def galerkin_levels_plain(fine_st: Stencil9, shapes, fine_five: bool):
    """The composed chain: ``galerkin_coarsen`` level by level with the
    vertex full-weighting / bilinear transfers."""
    del fine_five  # a 5-point fine stencil carries zero corners
    out, st = [], fine_st
    for (nxc, nyc) in shapes[1:]:
        st = galerkin_coarsen(st, restrict_full_weighting, prolong_linear, nxc, nyc)
        out.append(st)
    return out


# K4's outputs: the nine arrays of every coarse level in one buffer, level
# by level, each array starting on a 256-byte boundary (RAP_ALIGN floats)
RAP_ALIGN = 64


def rap_layout(shapes):
    """K4's output buffer for the vertex hierarchy ``shapes`` (finest
    first): per coarse level ``(offset, pitch)`` in floats (its nine arrays
    at ``offset + k * pitch``, ``pitch`` its cell count rounded up to
    ``RAP_ALIGN``), and the buffer's length."""
    levels, n = [], 0
    for ni, nj in shapes[1:]:
        pitch = -(-ni * nj // RAP_ALIGN) * RAP_ALIGN
        levels.append((n, pitch))
        n += 9 * pitch
    return levels, n


class _Rap:
    """K4's host arrays for one (device, stream, shapes, fine_five): the
    pointer slots (the fine stencil's and the outputs', refilled per call),
    the parameters and the output layout."""

    def __init__(self, shapes, fine_five):
        if len(shapes) < 2 or len(shapes) > _MAX_LEVELS:
            raise ValueError(f"galerkin_levels takes 2..{_MAX_LEVELS} shapes")
        for (nf, mf), (nc, mc) in zip(shapes, shapes[1:]):
            if (nf, mf) != (2 * nc + 1, 2 * mc + 1):
                raise ValueError(f"galerkin_levels: {(nf, mf)} -> {(nc, mc)} is not a vertex "
                                 "pair")
        self.levels, self.floats = rap_layout(shapes)
        self.offsets = [4 * (off + k * pitch) for off, pitch in self.levels for k in range(9)]
        self.ptrs = (ctypes.c_longlong * (9 * len(shapes)))()
        ip = [len(shapes), int(fine_five)] + [n for shp in shapes for n in shp]
        self.ip = (ctypes.c_int * len(ip))(*ip)
        self.fp = (ctypes.c_float * 1)(0.0)


_RAP = {}


def galerkin_levels(fine_st: Stencil9, shapes, fine_five: bool):
    """Every Galerkin coarse stencil of the vertex hierarchy ``shapes``
    (finest first) in one launch.  Returns one :class:`Stencil9` per coarse
    level, views of one fresh buffer (:func:`rap_layout`); the kernel
    computes each coarse entry directly from the fine stencil and the
    transfer weights in f32 (no comb, no matrix product)."""
    global RAP_LAUNCHES
    if not fine_st.c.is_cuda:
        return galerkin_levels_plain(fine_st, shapes, fine_five)
    shapes = tuple(tuple(s) for s in shapes)
    dev = fine_st.c.device
    stream = _cuda.stream_of(fine_st.c)
    h = _cached(_RAP, (dev, stream, shapes, bool(fine_five)), lambda: _Rap(shapes, fine_five))
    arrays = _stencil_arrays(fine_st, fine_five)
    _cuda.require_all(arrays, shapes[0], "fine stencil")
    buf = torch.empty(h.floats, dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    h.ptrs[:] = ([a.data_ptr() for a in arrays] + [0] * (9 - len(arrays))
                 + [base + off for off in h.offsets])
    _cuda.check(_cuda.library().nf_galerkin_levels(h.ptrs, h.ip, h.fp, stream),
                "galerkin_levels")
    RAP_LAUNCHES += 1
    return [Stencil9(*buf.as_strided((9, ni, nj), (pitch, nj, 1), off).unbind(0))
            for (off, pitch), (ni, nj) in zip(h.levels, shapes[1:])]


def galerkin_cluster_size(device=None) -> int:
    """The thread-block cluster size K4 launches with on ``device`` (16
    where one such cluster fits on the card, else 8)."""
    with torch.cuda.device(device):
        size = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_galerkin_cluster_size(ctypes.byref(size)),
                    "galerkin_cluster_size")
    return size.value


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
    and float) on the device.  Gate with :func:`supports_fused`.  The
    launch state is reused across calls with the same level layout and
    configuration; the stencil pointers are refilled when the hierarchy
    changes."""
    global SOLVE_LAUNCHES
    if not p0.is_cuda:
        return fused_mg_solve_plain(p0, b, levels, cfg, mean_normalize=mean_normalize)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_mg_solve implements Gauss-Seidel V-cycles only")
    dev, stream = p0.device, _cuda.stream_of(p0)
    ip_tail = (cfg.max_cycles, cfg.check_every, int(mean_normalize))
    fp = (cfg.omega, cfg.tolerance)
    st = _cached(_SOLVE, (dev, stream, ip_tail, cfg.tolerance) + _layout_key(levels, cfg),
                 lambda: _VcLaunch(levels, cfg, dev, 4, ip_tail, fp, solve=True))
    st.set_stencils(levels)
    _cuda.require_all((p0, b), levels[0][1], "fused_mg_solve p0, b")
    p, r = torch.empty((2, *p0.shape), dtype=torch.float32, device=dev)  # one allocation
    scalars = torch.empty(2, dtype=torch.int32, device=dev)  # cycles, then rel's bits
    ptrs, L = st.ptrs, st.L
    ptrs[9], ptrs[10] = p.data_ptr(), b.data_ptr()
    ptrs[11 * L:11 * L + 4] = [p0.data_ptr(), r.data_ptr(), scalars.data_ptr(),
                               scalars.data_ptr() + 4]
    _cuda.check(_cuda.library().nf_fused_mg_solve(ptrs, st.ip, st.fp, stream),
                "fused_mg_solve")
    SOLVE_LAUNCHES += 1
    return p, r, scalars[0], scalars.view(torch.float32)[1]


def mg_solve_cluster_size(device=None) -> int:
    """The thread-block cluster size K5 launches with on ``device`` (16
    where one such cluster fits on the card, else 8)."""
    with torch.cuda.device(device):
        size = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_mg_solve_cluster_size(ctypes.byref(size)),
                    "mg_solve_cluster_size")
    return size.value
