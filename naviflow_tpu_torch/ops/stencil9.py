"""9-point stencils and exact Galerkin coarsening (port of
``naviflow_tpu/ops/stencil9.py``).

Coarse operators are the exact ``A_c = R A P``: all nine coarse stencil
arrays are recovered from NINE applications of the composite map R∘A∘P to
3-strided "comb" grids (columns K1, K2 of RAP with ``|K1-K2|_inf >= 3``
have disjoint supports).  Stencils are stored SIGNED:
``apply9(x) = sum_k s_k * shift_k(x)`` including the center.

The rebuild runs composed every ``coarse_rebuild_every`` outer steps; it is
cancellation-sensitive, so it stays in full f32 (no matmul at all here, and
the callers set ``allow_tf32 = False`` besides).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .poisson import PoissonCoeffs
from .stencil import index_grids, pad2, shift_e, shift_n, shift_s, shift_w


def shift_ne(x):
    return pad2(x[1:, 1:], 0, 1, 0, 1)


def shift_nw(x):
    return pad2(x[:-1, 1:], 1, 0, 0, 1)


def shift_se(x):
    return pad2(x[1:, :-1], 0, 1, 1, 0)


def shift_sw(x):
    return pad2(x[:-1, :-1], 1, 0, 1, 0)


@dataclasses.dataclass(frozen=True)
class Stencil9:
    """Signed 9-point stencil: (A x)[i,j] = c*x + e*x_E + w*x_W + n*x_N +
    s*x_S + ne*x_NE + nw*x_NW + se*x_SE + sw*x_SW."""

    c: torch.Tensor
    e: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    s: torch.Tensor
    ne: torch.Tensor
    nw: torch.Tensor
    se: torch.Tensor
    sw: torch.Tensor

    @property
    def shape(self):
        return tuple(self.c.shape)


def from_poisson(pc: PoissonCoeffs) -> Stencil9:
    """Embed the 5-point pressure operator as a signed 9-point stencil."""
    z = torch.zeros_like(pc.diag)
    return Stencil9(c=pc.diag, e=-pc.a_e, w=-pc.a_w, n=-pc.a_n, s=-pc.a_s,
                    ne=z, nw=z, se=z, sw=z)


def _windows(x):
    """The 3 x 3 shifted copies of ``x`` (zero outside), one zero-padded
    copy's windows in one tensor: entry 3 (1 + di) + (1 + dj) is
    x[i + di, j + dj]."""
    m, n = x.shape
    return F.pad(x, (1, 1, 1, 1)).unfold(0, m, 1).unfold(1, n, 1).reshape(9, m, n).unbind(0)


def _apply9_from(cx, x, st: Stencil9):
    """:func:`apply9` with its first term ``st.c * x`` given as ``cx``."""
    x_sw, x_w, x_nw, x_s, _, x_n, x_se, x_e, x_ne = _windows(x)
    return (
        cx
        + st.e * x_e
        + st.w * x_w
        + st.n * x_n
        + st.s * x_s
        + st.ne * x_ne
        + st.nw * x_nw
        + st.se * x_se
        + st.sw * x_sw
    )


def apply9(x, st: Stencil9):
    """The 9-point apply, the eight shifted neighbours from one zero-padded
    copy of ``x`` (the values of ``shift_e`` ... ``shift_sw``)."""
    return _apply9_from(st.c * x, x, st)


def apply5(x, st: Stencil9):
    """Apply a Stencil9 whose corner entries are known-zero (the 5-point
    finest level); summation order matches :func:`apply9`'s first terms."""
    return (
        st.c * x
        + st.e * shift_e(x)
        + st.w * shift_w(x)
        + st.n * shift_n(x)
        + st.s * shift_s(x)
    )


def apply_five(x, st: Stencil9, five_point: bool):
    return apply5(x, st) if five_point else apply9(x, st)


def _comb(shape, a, b, dtype, device):
    ii, jj = index_grids(shape, device)
    return ((ii % 3 == a) & (jj % 3 == b)).to(dtype)


_OFFSET_NAMES = {
    (0, 0): "c",
    (1, 0): "e",
    (-1, 0): "w",
    (0, 1): "n",
    (0, -1): "s",
    (1, 1): "ne",
    (-1, 1): "nw",
    (1, -1): "se",
    (-1, -1): "sw",
}


def comb_select(images, ii, jj, di: int, dj: int):
    """Read the comb image value for neighbor offset (di, dj) at each cell:
    ``images[(ii+di)%3, (jj+dj)%3, cell]`` as nine masked selects.

    ``images``: (3, 3, m, n); ``ii``, ``jj``: (m, n) global index grids.
    """
    mi = [(ii % 3) == r for r in range(3)]
    mj = [(jj % 3) == r for r in range(3)]
    val = torch.zeros(images.shape[2:], dtype=images.dtype, device=images.device)
    for a in range(3):
        for b in range(3):
            m = mi[(a - di) % 3] & mj[(b - dj) % 3]
            val = torch.where(m, images[a, b], val)
    return val


def galerkin_coarsen(st: Stencil9, restrict_fn, prolong_fn, nxc: int, nyc: int) -> Stencil9:
    """Exact A_c = R A P via nine comb applications."""
    dtype, device = st.c.dtype, st.c.device
    ii, jj = index_grids((nxc, nyc), device)
    images = torch.stack(
        [restrict_fn(apply9(prolong_fn(_comb((nxc, nyc), a, b, dtype, device)), st))
         for a in range(3) for b in range(3)]
    ).reshape(3, 3, nxc, nyc)

    entries = {}
    for (di, dj), name in _OFFSET_NAMES.items():
        val = comb_select(images, ii, jj, di, dj)
        inside = (
            (ii + di >= 0) & (ii + di <= nxc - 1) & (jj + dj >= 0) & (jj + dj <= nyc - 1)
        )
        entries[name] = torch.where(inside, val, torch.zeros_like(val))
    return Stencil9(**entries)


def stencil9_diagonal(st: Stencil9, floor: float = 1e-15):
    return torch.where(torch.abs(st.c) < floor, torch.ones_like(st.c), st.c)


@functools.lru_cache(maxsize=64)
def _four_colours(shape, device):
    """The masks of the colours ``(i%2, j%2)`` = (0,0), (0,1), (1,0), (1,1)."""
    ii, jj = index_grids(shape, device)
    return tuple((ii % 2 == a) & (jj % 2 == bpar) for a in range(2) for bpar in range(2))


@functools.lru_cache(maxsize=64)
def red_black(shape, device):
    """The masks of red ((i + j) even) and black cells."""
    ii, jj = index_grids(shape, device)
    red = (ii + jj) % 2 == 0
    return red, torch.logical_not(red)


# apply9's terms in its order of summation (c, e, w, n, s, ne, nw, se, sw) as
# indices of the 3 x 3 windows of ``_windows`` (3 (1 + di) + (1 + dj));
# apply5's are the first five
_SUM_ORDER = (4, 7, 1, 5, 3, 8, 2, 6, 0)


@functools.lru_cache(maxsize=16)
def _sum_order(k: int, device):
    return torch.tensor(_SUM_ORDER[:k], device=device)


def _window_stencil(st: Stencil9):
    """The stencil's nine arrays stacked in the order of the windows,
    (3, 3, m, n): entry (1 + di, 1 + dj) multiplies x[i + di, j + dj]; a
    five-point level's missing corners are zeros."""
    arrays = [st.sw, st.w, st.nw, st.s, st.c, st.n, st.se, st.e, st.ne]
    z = torch.zeros_like(st.c)
    return torch.stack([z if a is None else a for a in arrays]).unflatten(0, (3, 3))


def _off_diagonal(p, sw, k: int):
    """``apply9(p, st) - st.c * p`` (``k`` = 9), or ``apply5``'s (``k`` =
    5), bit for bit, for the stencil ``sw`` of :func:`_window_stencil`: the
    products of all nine windows in one operator, the first ``k`` of them
    in the order of summation, and that sum as one CPU float64 ``cumsum``
    (its loop adds them one after another in double, as the chain of
    additions does) or as the chain of additions."""
    m, n = p.shape
    x = torch.constant_pad_nd(p, (1, 1, 1, 1)).unfold(0, m, 1).unfold(1, n, 1)
    terms = (sw * x).flatten(0, 1).index_select(0, _sum_order(k, p.device))
    if p.dtype == torch.float64 and p.device.type == "cpu":
        total = terms.cumsum(0)[-1]
    else:
        total = functools.reduce(torch.add, terms.unbind(0))
    return total - terms[0]


def colour_sweeper(b, st: Stencil9, colours, k: int, omega: float = 1.0):
    """Gauss-Seidel over ``colours`` (boolean masks, in order; no two
    neighbours of a cell of the stencil's ``k`` points share its colour) as
    a function of the iterate: the stencil's arrays stacked and its
    diagonal inverted once, each colour's update then ~15 operators."""
    sw = _window_stencil(st)
    inv_c = 1.0 / stencil9_diagonal(st)

    def sweep(p):
        for color_mask in colours:
            p_new = (b - _off_diagonal(p, sw, k)) * inv_c
            # omega = 1: the product by 1.0 is exact, so it is left out
            step = p_new - p if omega == 1.0 else omega * (p_new - p)
            p = torch.where(color_mask, p + step, p)
        return p

    return sweep


def gs4_sweeper(b, st: Stencil9, omega: float = 1.0, shape=None):
    """:func:`gs4_sweep` as a function of the iterate (of ``shape``, the
    stencil's by default)."""
    shape = tuple(st.c.shape) if shape is None else tuple(shape)
    return colour_sweeper(b, st, _four_colours(shape, st.c.device), 9, omega)


def gs4_sweep(p, b, st: Stencil9, omega: float = 1.0):
    """One four-color Gauss-Seidel sweep (valid for any 9-point stencil);
    colours ``(i%2, j%2)`` in the order (0,0), (0,1), (1,0), (1,1)."""
    return gs4_sweeper(b, st, omega, p.shape)(p)


def jacobi9_sweep(p, b, st: Stencil9, omega: float = 0.8):
    """One damped-Jacobi sweep: p + omega D^-1 (b - A p)."""
    r = b - apply9(p, st)
    return p + omega * r / stencil9_diagonal(st)
