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
