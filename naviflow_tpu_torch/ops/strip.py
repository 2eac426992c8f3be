"""K2: temporally blocked fine multigrid levels (``strip_down``/``strip_up``).

Replaces ``naviflow_tpu/ops/pallas_strip.py:strip_down`` / ``strip_up``;
the CUDA kernels are ``csrc/strip.cu`` (its header says what bounds them on
the H100 and how the 2-D halo tiles deal with that: each kernel stages its
tile's arrays in shared memory by 16-byte ``cp.async`` and runs each colour
pass on that colour's cells only; strip_up stages a box of the coarse
correction with them and adds its prolongation to p in shared memory).

* :func:`strip_down`: ``cfg.pre_smoothing`` Gauss-Seidel sweeps, the
  residual, and its full cell-centred restriction, in one launch.
* :func:`strip_up`: prolongated coarse correction + ``cfg.post_smoothing``
  sweeps, in one launch.

Five-point levels (the finest) use red-black colours, 9-point Galerkin
levels four colours.  On a CPU tensor each wrapper runs its plain version
(``_smooth`` -> ``b - apply`` -> ``restrict_cc``, and ``p + prolong_cc(ec)``
-> ``_smooth``); on a CUDA tensor it launches its kernel or raises.  Each
keeps its host arrays per (device, stream, shape, points, sweeps, omega).

The case axis (:func:`strip_down_batched`, :func:`strip_up_batched`): B
levels of one shape in one launch, the grid's z axis over the cases, each
case bit-equal to its single launch.  Under ``torch.func.vmap`` (alone)
:func:`strip_down` and :func:`strip_up` are their batching rules' entries.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .stencil9 import Stencil9, apply_five
from .transfer_cc import prolong_cc, restrict_cc

# The TPU kernels' halo rows and window caps (VMEM budgets).  They decide,
# as in the reference, which levels the peeled cycle runs as strips; they
# are not H100 limits.
H = 16
_CAP_FIVE = 656 * 1024
_CAP_NINE = 384 * 1024

STRIP_DOWN_LAUNCHES = 0
STRIP_UP_LAUNCHES = 0
STRIP_DOWN_BATCH_LAUNCHES = 0
STRIP_UP_BATCH_LAUNCHES = 0

# csrc/strip.cu's tiles (both kernels): TILE rows of owned cells by
# DOWN_TILE_J columns
TILE = 32
DOWN_TILE_J = 64


def down_threads(five: bool) -> int:
    """Both kernels' threads a block on a 5- or 9-point level."""
    return 512 if five else 1024


# the C entries' pointer slots (csrc/strip.cu nf_strip_down / nf_strip_up),
# the stencil's corners on 9-point levels only
_ST5 = ("c", "e", "w", "n", "s")
_ST9 = _ST5 + ("ne", "nw", "se", "sw")


def down_slots(five: bool):
    return ("p", "b", *(_ST5 if five else _ST9), "p_out", "rc")


def up_slots(five: bool):
    return ("p", "b", *(_ST5 if five else _ST9), "ec", "p_out")


def _region(h):
    m = -(-h // 4) * 4
    return TILE + 2 * h, DOWN_TILE_J + 2 * m, h, m


def down_region(five: bool, sweeps: int):
    """strip_down's staged region: (rows, columns, halo H, column margin M):
    TILE + 2 H rows and DOWN_TILE_J + 2 M columns, M = H rounded up to a
    multiple of 4 (the rows' 16-byte chunks), H = colours x sweeps + 1."""
    return _region((2 if five else 4) * sweeps + 1)


def down_smem_bytes(five: bool, sweeps: int) -> int:
    """strip_down's dynamic shared memory: p, b and the stencil arrays."""
    rows, cols, _, _ = down_region(five, sweeps)
    return 4 * ((5 if five else 9) + 2) * rows * cols


def up_region(five: bool, sweeps: int):
    """strip_up's staged region, as :func:`down_region` with H = colours x
    sweeps (no residual ring)."""
    return _region((2 if five else 4) * sweeps)


def up_box(five: bool, sweeps: int):
    """strip_up's box of the coarse correction: (rows, columns, first row,
    first column), the first row and column relative to the tile's first
    coarse cell (ti0 / 2, tj0 / 2); the columns start on a multiple of 4
    (16-byte chunks) and cover the clamp's neighbours."""
    h = up_region(five, sweeps)[2]
    lead = -(-(h // 2 + 1) // 4) * 4  # columns before the tile's first coarse column
    end = -(-(DOWN_TILE_J // 2 + h // 2 + 1) // 4) * 4
    return TILE // 2 + h + 2, end + lead, -(h // 2) - 1, -lead


def up_smem_bytes(five: bool, sweeps: int) -> int:
    """strip_up's dynamic shared memory: p (with b and the stencil arrays
    where a pass reads them) and the box."""
    rows, cols, _, _ = up_region(five, sweeps)
    box_rows, box_cols, _, _ = up_box(five, sweeps)
    arrays = (5 if five else 9) + 2 if sweeps else 1
    return 4 * (arrays * rows * cols + box_rows * box_cols)


class _Launch:
    """A kernel's host arrays for one (device, stream, shape, five, sweeps,
    omega): the pointer slots (refilled per call) and the parameters."""

    def __init__(self, slots, nx, ny, five, sweeps, omega):
        self.ptrs = (ctypes.c_longlong * len(slots))()
        self.ip = (ctypes.c_int * 4)(nx, ny, int(five), sweeps)
        self.fp = (ctypes.c_float * 1)(omega)


_DOWN = {}
_UP = {}


def _launch_state(cache, slots, p, nx, ny, five, sweeps, omega):
    key = (p.device, _cuda.stream_of(p), nx, ny, five, sweeps, omega)
    h = cache.get(key)
    if h is None:
        if len(cache) >= 32:
            cache.clear()
        h = cache[key] = _Launch(slots, nx, ny, five, sweeps, omega)
    return key[1], h


def _strip_rows(nx: int, ny: int, five: bool = True) -> int:
    cap = _CAP_FIVE if five else _CAP_NINE
    for T in (256, 128, 64, 32, 16):
        if T + 2 * H > nx or nx % T:
            continue
        if (T + 2 * H) * ny <= cap:
            return T
    return 0


def supports_strip(nx: int, ny: int, five_point: bool, cfg, dtype) -> bool:
    """Gate: big even square level, GS smoothing with <= 2 pre/post sweeps,
    cell-centred transfers, f32 (the reference's rule)."""
    if dtype != torch.float32:
        return False
    if nx != ny or nx % 2:
        return False
    if (cfg.smoother != "gs" or cfg.pre_smoothing > 2
            or cfg.post_smoothing > 2
            or getattr(cfg, "smoother_dtype", "float32") != "float32"):
        return False
    if cfg.restriction != "full_weighting" or cfg.prolongation != "linear":
        return False
    return _strip_rows(nx, ny, five_point) > 0


def _st_arrays(st: Stencil9, five: bool):
    if five:
        return [st.c, st.e, st.w, st.n, st.s]
    return [st.c, st.e, st.w, st.n, st.s, st.ne, st.nw, st.se, st.sw]


def strip_down_plain(p, b, st: Stencil9, cfg, five: bool = True):
    from ..solvers.multigrid import _smooth

    x = _smooth(p, b, st, cfg, cfg.pre_smoothing, five)
    return x, restrict_cc(b - apply_five(x, st, five))


def strip_up_plain(p, b, st: Stencil9, ec, cfg, five: bool = True):
    from ..solvers.multigrid import _smooth

    return _smooth(p + prolong_cc(ec), b, st, cfg, cfg.post_smoothing, five)


def _check(p, b, st, cfg, five):
    nx, ny = p.shape
    if nx % 2 or ny % 2:
        raise ValueError(f"strip kernels need an even level, got {(nx, ny)}")
    if cfg.smoother != "gs" or getattr(cfg, "smoother_dtype", "float32") != "float32":
        raise ValueError("strip kernels implement float32 Gauss-Seidel smoothing only")
    _cuda.require(p, (nx, ny), "p")
    _cuda.require(b, (nx, ny), "b")
    arrays = _st_arrays(st, five)
    for k, a in enumerate(arrays):
        _cuda.require(a, (nx, ny), f"stencil[{k}]")
    return nx, ny, arrays


def strip_down(p, b, st: Stencil9, cfg, five: bool = True):
    """Pre-smooth + residual + cell-centred restriction of a level.
    Returns ``(p_smoothed, r_coarse)``."""
    global STRIP_DOWN_LAUNCHES
    if _cuda.under_vmap():
        return _DownCases.apply(p, b, *_st_arrays(st, five), (cfg, bool(five)))
    if not p.is_cuda:
        return strip_down_plain(p, b, st, cfg, five)
    nx, ny, arrays = _check(p, b, st, cfg, five)
    stream, h = _launch_state(_DOWN, down_slots(five), p, nx, ny, five, cfg.pre_smoothing,
                              cfg.omega)
    # both outputs from one fresh buffer (a kept pair would be overwritten
    # under a caller still holding the last call's result)
    buf = torch.empty(nx * ny + (nx // 2) * (ny // 2), dtype=p.dtype, device=p.device)
    base = buf.data_ptr()
    h.ptrs[:] = [p.data_ptr(), b.data_ptr(), *[a.data_ptr() for a in arrays], base,
                 base + 4 * nx * ny]
    _cuda.check(_cuda.library().nf_strip_down(h.ptrs, h.ip, h.fp, stream), "strip_down")
    STRIP_DOWN_LAUNCHES += 1
    return (buf.as_strided((nx, ny), (ny, 1), 0),
            buf.as_strided((nx // 2, ny // 2), (ny // 2, 1), nx * ny))


def strip_up(p, b, st: Stencil9, ec, cfg, five: bool = True):
    """Prolongated coarse correction + post-smoothing of a level."""
    global STRIP_UP_LAUNCHES
    if _cuda.under_vmap():
        return _UpCases.apply(p, b, ec, *_st_arrays(st, five), (cfg, bool(five)))
    if not p.is_cuda:
        return strip_up_plain(p, b, st, ec, cfg, five)
    nx, ny, arrays = _check(p, b, st, cfg, five)
    _cuda.require(ec, (nx // 2, ny // 2), "ec")
    stream, h = _launch_state(_UP, up_slots(five), p, nx, ny, five, cfg.post_smoothing,
                              cfg.omega)
    out = torch.empty_like(p)
    h.ptrs[:] = [p.data_ptr(), b.data_ptr(), *[a.data_ptr() for a in arrays], ec.data_ptr(),
                 out.data_ptr()]
    _cuda.check(_cuda.library().nf_strip_up(h.ptrs, h.ip, h.fp, stream), "strip_up")
    STRIP_UP_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The case axis: B levels of one shape in one launch (grid z over the
# cases), each case bit-equal to its single launch.


def _stencil_of(arrays, five):
    """The level's Stencil9 from its 5 or 9 arrays (a 5-point level's
    corners, which no pass reads, None)."""
    return Stencil9(*arrays, *([None] * (9 - len(arrays))))


def _case_st(st, k):
    return Stencil9(*(None if a is None else a[k] for a in (getattr(st, f) for f in _ST9)))


def strip_down_batched_plain(p, b, st: Stencil9, cfg, five: bool = True, active=None):
    """The batched K2a's plain version (the CPU path and its oracle): case
    by case through :func:`strip_down_plain`; a frozen case (``active``
    False) gets ``p`` and a zero coarse residual."""
    outs = [strip_down_plain(p[k], b[k], _case_st(st, k), cfg, five) if on
            else (p[k], p.new_zeros((p.shape[1] // 2, p.shape[2] // 2)))
            for k, on in enumerate(_cuda.case_flags(active, p.shape[0]))]
    return torch.stack([x for x, _ in outs]), torch.stack([rc for _, rc in outs])


def strip_up_batched_plain(p, b, st: Stencil9, ec, cfg, five: bool = True, active=None):
    """The batched K2b's plain version: case by case through
    :func:`strip_up_plain`; a frozen case gets ``p``."""
    flags = _cuda.case_flags(active, p.shape[0])
    return torch.stack([strip_up_plain(p[k], b[k], _case_st(st, k), ec[k], cfg, five)
                        if on else p[k] for k, on in enumerate(flags)])


class _BatchLaunch:
    """A batched kernel's host arrays for one (device, stream, cases, shape,
    five, sweeps, omega): the pointer slots (the single entry's, the active
    flags, then each slot's case stride; refilled per call), the parameters
    with the case count, and the flags of a batch with no frozen case."""

    def __init__(self, slots, nx, ny, five, sweeps, omega, cases, dev):
        self.half = len(slots) + 1
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        self.ip = (ctypes.c_int * 5)(nx, ny, int(five), sweeps, cases)
        self.fp = (ctypes.c_float * 1)(omega)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_DOWN_BATCH = {}
_UP_BATCH = {}


def _batch_state(cache, slots, p, five, sweeps, omega):
    cases, nx, ny = p.shape
    key = (p.device, _cuda.stream_of(p), cases, nx, ny, five, sweeps, omega)
    h = cache.get(key)
    if h is None:
        if len(cache) >= 32:
            cache.clear()
        h = cache[key] = _BatchLaunch(slots, nx, ny, five, sweeps, omega, cases, p.device)
    return key[1], h


def _batch_check(p, cfg):
    cases, nx, ny = p.shape
    if nx % 2 or ny % 2:
        raise ValueError(f"strip kernels need an even level, got {(nx, ny)}")
    if cfg.smoother != "gs" or getattr(cfg, "smoother_dtype", "float32") != "float32":
        raise ValueError("strip kernels implement float32 Gauss-Seidel smoothing only")
    return cases, nx, ny


def strip_down_batched(p, b, st: Stencil9, cfg, five: bool = True, active=None):
    """:func:`strip_down` of B levels of one shape in one launch: ``p``,
    ``b`` and the stencil arrays carry a leading case axis (each case's
    slice contiguous; a case stride of 0 shares one array), ``active`` (B,)
    bool: a frozen case's blocks copy ``p`` and zero its coarse residual
    (None: every case active).  Returns ``(p_smoothed, r_coarse)`` with the
    case axis first, views of one fresh buffer."""
    global STRIP_DOWN_BATCH_LAUNCHES
    if not p.is_cuda:
        return strip_down_batched_plain(p, b, st, cfg, five, active)
    cases, nx, ny = _batch_check(p, cfg)
    stream, h = _batch_state(_DOWN_BATCH, down_slots(five), p, five, cfg.pre_smoothing,
                             cfg.omega)
    n = _cuda.case_slots(h, [([p, b, *_st_arrays(st, five)], (nx, ny))], active, cases,
                         "strip input")
    cells, coarse = nx * ny, (nx // 2) * (ny // 2)
    buf = torch.empty((cases, cells + coarse), dtype=p.dtype, device=p.device)
    base = buf.data_ptr()
    h.ptrs[n:n + 2] = [base, base + 4 * cells]
    h.ptrs[h.half + n:h.half + n + 2] = [4 * (cells + coarse)] * 2
    _cuda.check(_cuda.library().nf_strip_down_batched(h.ptrs, h.ip, h.fp, stream),
                "strip_down_batched")
    STRIP_DOWN_BATCH_LAUNCHES += 1
    return (buf.as_strided((cases, nx, ny), (cells + coarse, ny, 1), 0),
            buf.as_strided((cases, nx // 2, ny // 2), (cells + coarse, ny // 2, 1), cells))


def strip_up_batched(p, b, st: Stencil9, ec, cfg, five: bool = True, active=None):
    """:func:`strip_up` of B levels of one shape in one launch (the case
    axis as :func:`strip_down_batched`; ``ec`` (B, nx / 2, ny / 2)); a
    frozen case's blocks copy ``p``.  Returns the smoothed levels (B, nx,
    ny), a fresh tensor."""
    global STRIP_UP_BATCH_LAUNCHES
    if not p.is_cuda:
        return strip_up_batched_plain(p, b, st, ec, cfg, five, active)
    cases, nx, ny = _batch_check(p, cfg)
    stream, h = _batch_state(_UP_BATCH, up_slots(five), p, five, cfg.post_smoothing,
                             cfg.omega)
    n = _cuda.case_slots(h, [([p, b, *_st_arrays(st, five)], (nx, ny)),
                             ([ec], (nx // 2, ny // 2))], active, cases, "strip input")
    out = torch.empty_like(p)
    h.ptrs[n], h.ptrs[h.half + n] = out.data_ptr(), 4 * nx * ny
    _cuda.check(_cuda.library().nf_strip_up_batched(h.ptrs, h.ip, h.fp, stream),
                "strip_up_batched")
    STRIP_UP_BATCH_LAUNCHES += 1
    return out


class _DownCases(torch.autograd.Function):
    """K2a's batching rule: under ``torch.func.vmap`` every case's level goes
    into one :func:`strip_down_batched` call with the active flags of
    ``_cuda.case_mask``; an operand shared by every case gets case stride
    0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(p, b, *args):
        *arrays, (cfg, five) = args
        return strip_down(p, b, _stencil_of(arrays, five), cfg, five)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (cfg, five) = args
        p, b, *arrays = (_cuda.case_first(a, d, cases)
                         for a, d in zip(arrays, in_dims[:len(arrays)]))
        out = strip_down_batched(p, b, _stencil_of(arrays, five), cfg, five,
                                 active=_cuda.active_cases(cases))
        return out, (0, 0)


class _UpCases(torch.autograd.Function):
    """K2b's batching rule, as :class:`_DownCases` for :func:`strip_up_batched`."""

    generate_vmap_rule = False

    @staticmethod
    def forward(p, b, ec, *args):
        *arrays, (cfg, five) = args
        return strip_up(p, b, _stencil_of(arrays, five), ec, cfg, five)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (cfg, five) = args
        p, b, ec, *arrays = (_cuda.case_first(a, d, cases)
                             for a, d in zip(arrays, in_dims[:len(arrays)]))
        return strip_up_batched(p, b, _stencil_of(arrays, five), ec, cfg, five,
                                active=_cuda.active_cases(cases)), 0
