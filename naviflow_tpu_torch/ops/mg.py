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

The case axis of K5, K4 and K3 (:func:`fused_mg_solve_batched`,
:func:`galerkin_levels_batched`, :func:`fused_vcycle_batched`;
``csrc/mg.cu``'s batched entries): B hierarchies of one layout in one
launch, one cluster a case, each case bit-equal to its single launch.
Under ``torch.func.vmap`` (alone) :func:`fused_mg_solve`,
:func:`galerkin_levels` and :func:`fused_vcycle` are their batching
rules' entries.

The gates are the reference's admission rules, with their TPU VMEM
budgets kept so that the port splits the work as the reference does; they
are not H100 limits.
"""

from __future__ import annotations

import ctypes
import math

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
RAP_BATCH_LAUNCHES = 0  # K4, batched
SOLVE_BATCH_LAUNCHES = 0  # K5, batched
VC_BATCH_LAUNCHES = 0  # K3, batched

_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def _padded_bytes(nx, ny):
    """f32 footprint of an (nx, ny) array under the TPU's (8, 128) tiling."""
    return (-(-nx // 8) * 8) * (-(-ny // 128) * 128) * 4


def supports_fused(levels, cfg) -> bool:
    """True when the (levels, cfg) combination is one the fused V-cycle and
    the fused solve take (the reference's rule)."""
    return all(st.c.dtype == torch.float32 for st, _, _, _ in levels) and supports_fused_layout(
        [(shp, five) for _, shp, five, _ in levels], cfg)


def supports_fused_layout(layout, cfg) -> bool:
    """:func:`supports_fused` for float32 levels of ``layout``, the
    ``((nx, ny), five_point)`` of each level, finest first."""
    if (cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs"
            or cfg.restriction != "full_weighting"
            or cfg.prolongation != "linear"
            or getattr(cfg, "smoother_dtype", "float32") != "float32"):
        return False
    total = 0
    for (nx, ny), five in layout:
        if nx != ny:
            return False
        total += ((5 if five else 9) + 3) * _padded_bytes(nx, ny)
    for ((nf, _), _), ((nc, _), _) in zip(layout, layout[1:]):
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
    if _cuda.under_vmap():
        meta = (tuple((tuple(shp), bool(five), lam) for _, shp, five, lam in levels), cfg)
        return _VcycleCases.apply(p, b, *(a for st, _, _, _ in levels for a in _arrays9(st)),
                                  meta)
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
    if _cuda.under_vmap():
        shapes = tuple(tuple(shp) for shp in shapes)
        flat = _RapCases.apply(*_arrays9(fine_st), (shapes, bool(fine_five)))
        return [Stencil9(*flat[9 * k:9 * k + 9]) for k in range(len(shapes) - 1)]
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
    if _cuda.under_vmap():
        meta = (tuple((tuple(shp), bool(five), lam) for _, shp, five, lam in levels), cfg,
                bool(mean_normalize))
        return _MgSolveCases.apply(p0, b, *(a for st, _, _, _ in levels for a in _arrays9(st)),
                                   meta)
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


# ---------------------------------------------------------------------------
# The case axis of K5, K4 and K3.


def _arrays9(st: Stencil9):
    return [getattr(st, k) for k in _NAMES]


def _case_levels(levels, b):
    """Case ``b``'s slice of a hierarchy whose stencils carry a case axis."""
    return [(Stencil9(*(a[b] for a in _arrays9(st))), shp, five, lam)
            for st, shp, five, lam in levels]


def fused_mg_solve_batched_plain(p0, b, levels, cfg, *, mean_normalize: bool = True,
                                 active=None):
    """The batched K5's plain version (the CPU path and its oracle): case by
    case through :func:`fused_mg_solve_plain`; a frozen case (``active``
    False) gets ``p0``, a zero residual, 0 cycles and rel 0."""
    outs = []
    for k, on in enumerate(_cuda.case_flags(active, p0.shape[0])):
        if on:
            outs.append(fused_mg_solve_plain(p0[k], b[k], _case_levels(levels, k), cfg,
                                             mean_normalize=mean_normalize))
        else:
            zero = torch.zeros((), dtype=b.dtype, device=b.device)
            outs.append((p0[k], torch.zeros_like(b[k]), zero.to(torch.int32), zero))
    p, r, cycles, rel = zip(*outs)
    return torch.stack(p), torch.stack(r), torch.stack(cycles), torch.stack(rel)


class _VcBatchLaunch:
    """The batched K5's launch state for one (device, stream, cases,
    layout): the pointer array (the single entry's 11 L + 4 slots, the
    active flags, then each slot's case stride; the global coarse levels'
    scratch, ``cases`` copies, filled once), the parameters with the case
    count, and the flags of a batch with no frozen case."""

    def __init__(self, levels, cfg, dev, cases, ip_tail, fp):
        single = _VcLaunch(levels, cfg, dev, 4, ip_tail, fp, solve=True)
        L = self.L = single.L
        self.half = 11 * L + 5
        self.scratch = [torch.empty((cases, 2, *xr.shape[1:]), dtype=torch.float32,
                                    device=dev) for xr in single.scratch]
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        for lvl, xr in enumerate(self.scratch, start=1):
            stride = 4 * xr[0].numel()
            for k in (0, 1):
                self.ptrs[11 * lvl + 9 + k] = xr[:, k].data_ptr()
                self.ptrs[self.half + 11 * lvl + 9 + k] = stride
        self.ip = (ctypes.c_int * (len(single.ip) + 1))(*single.ip, cases)
        self.fp = single.fp
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_SOLVE_BATCH = {}


def fused_mg_solve_batched(p0, b, levels, cfg, *, mean_normalize: bool = True, active=None):
    """:func:`fused_mg_solve` of B cases in one launch, one cluster a case:
    ``p0``, ``b`` and every stencil array of ``levels`` carry a leading
    case axis (each case's slice contiguous; a case stride of 0 shares one
    array, a shared setup hierarchy), ``active`` (B,) bool: a frozen case
    gets ``p0``, a zero residual, 0 cycles and rel 0, and its cluster
    leaves at once (None: every case active).  Returns ``(p, r, cycles,
    rel)``, each with the case axis first."""
    global SOLVE_BATCH_LAUNCHES
    if not p0.is_cuda:
        return fused_mg_solve_batched_plain(p0, b, levels, cfg, mean_normalize=mean_normalize,
                                            active=active)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_mg_solve implements Gauss-Seidel V-cycles only")
    cases = p0.shape[0]
    dev, stream = p0.device, _cuda.stream_of(p0)
    ip_tail = (cfg.max_cycles, cfg.check_every, int(mean_normalize))
    fp = (cfg.omega, cfg.tolerance)
    case_levels = [(st, shp, five, lam) for st, shp, five, lam in levels]
    st = _cached(_SOLVE_BATCH, (dev, stream, cases, ip_tail, cfg.tolerance)
                 + _layout_key(levels, cfg),
                 lambda: _VcBatchLaunch(case_levels, cfg, dev, cases, ip_tail, fp))
    ptrs, L, half = st.ptrs, st.L, st.half
    f32 = torch.float32
    _fill_levels(ptrs, half, levels, cases)
    shape = tuple(levels[0][1])
    pr = torch.empty((2, cases, *shape), dtype=f32, device=dev)  # p, r: one allocation
    scalars = torch.empty((cases, 2), dtype=torch.int32, device=dev)  # cycles, rel's bits
    flags = st.ones if active is None else active
    n = 4 * math.prod(shape)
    ptrs[9], ptrs[half + 9] = pr[0].data_ptr(), n
    ptrs[10], ptrs[half + 10] = b.data_ptr(), _cuda.case_stride(b, cases, shape, f32, "b")
    ptrs[11 * L], ptrs[half + 11 * L] = p0.data_ptr(), _cuda.case_stride(p0, cases, shape,
                                                                         f32, "p0")
    ptrs[11 * L + 1], ptrs[half + 11 * L + 1] = pr[1].data_ptr(), n
    base = scalars.data_ptr()
    ptrs[11 * L + 2], ptrs[half + 11 * L + 2] = base, 8
    ptrs[11 * L + 3], ptrs[half + 11 * L + 3] = base + 4, 8
    ptrs[half - 1] = flags.data_ptr()
    ptrs[2 * half - 1] = _cuda.case_stride(flags, cases, (), torch.bool, "active")
    _cuda.check(_cuda.library().nf_fused_mg_solve_batched(ptrs, st.ip, st.fp, stream),
                "fused_mg_solve_batched")
    SOLVE_BATCH_LAUNCHES += 1
    return pr[0], pr[1], scalars[:, 0], scalars.view(f32)[:, 1]


def galerkin_levels_batched_plain(fine_st: Stencil9, shapes, fine_five: bool, active=None):
    """The batched K4's plain version (the CPU path and its oracle): case by
    case through :func:`galerkin_levels_plain`; a frozen case (``active``
    False) gets zero stencils."""
    cases = fine_st.c.shape[0]
    per_case = []
    for k, on in enumerate(_cuda.case_flags(active, cases)):
        if on:
            case_st = Stencil9(*(a[k] for a in _arrays9(fine_st)))
            per_case.append(galerkin_levels_plain(case_st, shapes, fine_five))
        else:
            per_case.append([Stencil9(*[torch.zeros(shp, dtype=fine_st.c.dtype,
                                                    device=fine_st.c.device)] * 9)
                             for shp in shapes[1:]])
    return [Stencil9(*(torch.stack([_arrays9(case[lvl])[k] for case in per_case])
                       for k in range(9))) for lvl in range(len(shapes) - 1)]


class _RapBatch:
    """The batched K4's host arrays for one (device, stream, shapes,
    fine_five, cases): the pointer slots (the single entry's 9 L, the
    active flags, then each slot's case stride; the outputs' strides filled
    once), the parameters with the case count, the output layout, and the
    flags of a batch with no frozen case."""

    def __init__(self, shapes, fine_five, cases, dev):
        single = _Rap(shapes, fine_five)
        self.levels, self.floats, self.offsets = single.levels, single.floats, single.offsets
        self.half = 9 * len(shapes) + 1
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        for k in range(9, self.half - 1):
            self.ptrs[self.half + k] = 4 * self.floats
        self.ip = (ctypes.c_int * (len(single.ip) + 1))(*single.ip, cases)
        self.fp = single.fp
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_RAP_BATCH = {}


def galerkin_levels_batched(fine_st: Stencil9, shapes, fine_five: bool, active=None):
    """:func:`galerkin_levels` of B fine stencils (a leading case axis on
    each array; each case's slice contiguous) in one launch, one cluster a
    case; ``active`` (B,) bool: a frozen case gets zero stencils and its
    cluster leaves at once (None: every case active).  Returns one
    :class:`Stencil9` per coarse level with the case axis first, views of
    one fresh buffer of B :func:`rap_layout` buffers."""
    global RAP_BATCH_LAUNCHES
    if not fine_st.c.is_cuda:
        return galerkin_levels_batched_plain(fine_st, shapes, fine_five, active)
    shapes = tuple(tuple(shp) for shp in shapes)
    cases, dev = fine_st.c.shape[0], fine_st.c.device
    stream = _cuda.stream_of(fine_st.c)
    h = _cached(_RAP_BATCH, (dev, stream, shapes, bool(fine_five), cases),
                lambda: _RapBatch(shapes, fine_five, cases, dev))
    ptrs, half = h.ptrs, h.half
    arrays = _stencil_arrays(fine_st, fine_five)
    ptrs[half:half + len(arrays)] = _cuda.case_strides(arrays, cases, shapes[0], torch.float32,
                                                       "fine stencil")
    ptrs[:len(arrays)] = [a.data_ptr() for a in arrays]
    buf = torch.empty((cases, h.floats), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    ptrs[9:half - 1] = [base + off for off in h.offsets]
    flags = h.ones if active is None else active
    ptrs[half - 1] = flags.data_ptr()
    ptrs[2 * half - 1] = _cuda.case_stride(flags, cases, (), torch.bool, "active")
    _cuda.check(_cuda.library().nf_galerkin_levels_batched(ptrs, h.ip, h.fp, stream),
                "galerkin_levels_batched")
    RAP_BATCH_LAUNCHES += 1
    return [Stencil9(*buf.as_strided((9, cases, ni, nj), (pitch, h.floats, nj, 1),
                                     off).unbind(0))
            for (off, pitch), (ni, nj) in zip(h.levels, shapes[1:])]


def fused_vcycle_batched_plain(p, b, levels, cfg, active=None):
    """The batched K3's plain version (the CPU path and its oracle): case by
    case through :func:`fused_vcycle_plain`; a frozen case (``active``
    False) gets ``p`` back."""
    return torch.stack([fused_vcycle_plain(p[k], b[k], _case_levels(levels, k), cfg) if on
                        else p[k] for k, on in enumerate(_cuda.case_flags(active, p.shape[0]))])


class _VcBatch:
    """The batched K3's launch state for one (device, stream, cases,
    layout): the pointer array (the single entry's 11 L + 1 slots, the
    active flags, then each slot's case stride; the global coarse levels'
    scratch, ``cases`` copies, filled once), the parameters with the case
    count, and the flags of a batch with no frozen case."""

    def __init__(self, levels, cfg, dev, cases):
        single = _VcLaunch(levels, cfg, dev, 1)
        L = self.L = single.L
        self.half = 11 * L + 2
        self.scratch = [torch.empty((cases, 2, *xr.shape[1:]), dtype=torch.float32,
                                    device=dev) for xr in single.scratch]
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        for lvl, xr in enumerate(self.scratch, start=1):
            stride = 4 * xr[0].numel()
            for k in (0, 1):
                self.ptrs[11 * lvl + 9 + k] = xr[:, k].data_ptr()
                self.ptrs[self.half + 11 * lvl + 9 + k] = stride
        self.ip = (ctypes.c_int * (len(single.ip) + 1))(*single.ip, cases)
        self.fp = single.fp
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_VC_BATCH = {}


def _fill_levels(ptrs, half, levels, cases):
    """The stencil slots of every level and their case strides (one test a
    tensor, ``_cuda.case_strides``)."""
    for lvl, (stc, shp, five, _) in enumerate(levels):
        arrays = _stencil_arrays(stc, five)
        ptrs[half + 11 * lvl:half + 11 * lvl + len(arrays)] = _cuda.case_strides(
            arrays, cases, shp, torch.float32, f"level {lvl} stencil")
        ptrs[11 * lvl:11 * lvl + len(arrays)] = [a.data_ptr() for a in arrays]


def fused_vcycle_batched(p, b, levels, cfg, active=None):
    """:func:`fused_vcycle` of B cases in one launch, one cluster a case:
    ``p``, ``b`` and every stencil array of ``levels`` carry a leading case
    axis (each case's slice contiguous; a case stride of 0 shares one array),
    ``active`` (B,) bool: a frozen case gets ``p`` back and its cluster
    leaves at once (None: every case active).  Returns level 0's iterates
    (B, *shape), a fresh tensor."""
    global VC_BATCH_LAUNCHES
    if not p.is_cuda:
        return fused_vcycle_batched_plain(p, b, levels, cfg, active)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_vcycle implements Gauss-Seidel V-cycles only")
    cases = p.shape[0]
    dev, stream = p.device, _cuda.stream_of(p)
    st = _cached(_VC_BATCH, (dev, stream, cases) + _layout_key(levels, cfg),
                 lambda: _VcBatch(levels, cfg, dev, cases))
    ptrs, L, half = st.ptrs, st.L, st.half
    _fill_levels(ptrs, half, levels, cases)
    shape = tuple(levels[0][1])
    f32 = torch.float32
    out = torch.empty((cases, *shape), dtype=f32, device=dev)
    flags = st.ones if active is None else active
    ptrs[9], ptrs[half + 9] = out.data_ptr(), 4 * math.prod(shape)
    ptrs[10], ptrs[half + 10] = b.data_ptr(), _cuda.case_stride(b, cases, shape, f32, "b")
    ptrs[11 * L], ptrs[half + 11 * L] = p.data_ptr(), _cuda.case_stride(p, cases, shape, f32,
                                                                         "p")
    ptrs[half - 1] = flags.data_ptr()
    ptrs[2 * half - 1] = _cuda.case_stride(flags, cases, (), torch.bool, "active")
    _cuda.check(_cuda.library().nf_fused_vcycle_batched(ptrs, st.ip, st.fp, stream),
                "fused_vcycle_batched")
    VC_BATCH_LAUNCHES += 1
    return out


class _VcycleCases(torch.autograd.Function):
    """K3's batching rule: under ``torch.func.vmap`` every case's V-cycle
    goes into one :func:`fused_vcycle_batched` call with the active flags of
    ``_cuda.case_mask``; an operand shared by every case (a hierarchy built
    before the batch) gets case stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(p, b, *args):
        *arrays, (metas, cfg) = args
        return fused_vcycle(p, b, _levels_of(arrays, metas), cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (metas, cfg) = args
        p, b, *arrays = (_cuda.case_first(a, d, cases)
                         for a, d in zip(arrays, in_dims[:len(arrays)]))
        return fused_vcycle_batched(p, b, _levels_of(arrays, metas), cfg,
                                    active=_cuda.active_cases(cases)), 0


class _MgSolveCases(torch.autograd.Function):
    """K5's batching rule: under ``torch.func.vmap`` every case's solve goes
    into one :func:`fused_mg_solve_batched` call with the active flags of
    ``_cuda.case_mask``; an operand shared by every case (a setup
    hierarchy) gets case stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(p0, b, *args):
        *arrays, (metas, cfg, mean_normalize) = args
        return fused_mg_solve(p0, b, _levels_of(arrays, metas), cfg,
                              mean_normalize=mean_normalize)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (metas, cfg, mean_normalize) = args
        p0, b, *arrays = (_cuda.case_first(a, d, cases)
                          for a, d in zip(arrays, in_dims[:len(arrays)]))
        out = fused_mg_solve_batched(p0, b, _levels_of(arrays, metas), cfg,
                                     mean_normalize=mean_normalize,
                                     active=_cuda.active_cases(cases))
        return out, (0, 0, 0, 0)


def _levels_of(arrays, metas):
    return [(Stencil9(*arrays[9 * k:9 * k + 9]), shp, five, lam)
            for k, (shp, five, lam) in enumerate(metas)]


class _RapCases(torch.autograd.Function):
    """K4's batching rule: under ``torch.func.vmap`` every case's hierarchy
    comes from one :func:`galerkin_levels_batched` call with the active
    flags of ``_cuda.case_mask``; the outputs are the coarse levels' nine
    arrays each, flat."""

    generate_vmap_rule = False

    @staticmethod
    def forward(*args):
        *arrays, (shapes, fine_five) = args
        out = galerkin_levels(Stencil9(*arrays), shapes, fine_five)
        return tuple(a for st in out for a in _arrays9(st))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (shapes, fine_five) = args
        arrays = [_cuda.case_first(a, d, cases) for a, d in zip(arrays, in_dims[:9])]
        out = galerkin_levels_batched(Stencil9(*arrays), shapes, fine_five,
                                      active=_cuda.active_cases(cases))
        flat = tuple(a for st in out for a in _arrays9(st))
        return flat, (0,) * len(flat)
