"""Colour-plane (checkerboard) layout for red-black smoothing (port of
``naviflow_tpu/ops/plane.py``).

The field is split into its red ((i+j) even) and black planes of shape
(nx, ny/2), so each half-sweep touches exactly the cells it updates: no
colour mask, half the arithmetic and half the streamed bytes of a masked
whole-grid half-sweep.

Layout (the parity of j within a row alternates with the row, so the
planes are rectangular)::

    R[i, jc] = p[i, 2*jc + (i % 2)]        (red:   i + j even)
    B[i, jc] = p[i, 2*jc + 1 - (i % 2)]    (black: i + j odd)

Neighbour map::

    red (i, jc):   e -> B[i+1, jc]   w -> B[i-1, jc]
                   n -> B[i, jc + (i%2)]      s -> B[i, jc + (i%2) - 1]
    black (i, jc): e -> R[i+1, jc]   w -> R[i-1, jc]
                   n -> R[i, jc + 1 - (i%2)]  s -> R[i, jc - (i%2)]

Plain PyTorch, in the state's dtype.  Out-of-range rolls wrap, and the
wrapped contributions are annihilated by the zero boundary links of the
stencil planes, as in the JAX module.  Cell-centred restriction and
prolongation act on the planes directly (row-pair sums and a column mix
picked by row parity), so the fine level stays in plane layout for a whole
solve.
"""

from __future__ import annotations

import torch

from .stencil import index_grids
from .stencil9 import Stencil9, stencil9_diagonal
from .transfer_cc import _prolong_ax0


def _row_parity(m, n, device=None):
    """True on ODD rows of an (m, n) plane."""
    return index_grids((m, n), device)[0] % 2 == 1


def split_planes(x):
    """(m, n) -> (red, black) planes of shape (m, n // 2)."""
    m, n = x.shape
    xr = x.reshape(m, n // 2, 2)
    odd = _row_parity(m, n // 2, x.device)
    red = torch.where(odd, xr[:, :, 1], xr[:, :, 0])
    black = torch.where(odd, xr[:, :, 0], xr[:, :, 1])
    return red, black


def merge_planes(red, black):
    """Inverse of :func:`split_planes`."""
    m, nc = red.shape
    odd = _row_parity(m, nc, red.device)
    lane0 = torch.where(odd, black, red)
    lane1 = torch.where(odd, red, black)
    return torch.stack([lane0, lane1], dim=2).reshape(m, 2 * nc)


def plane_neighbors(other, odd):
    """The four 5-point neighbours of the red cells, read from the black
    plane.  Returns (e, w, n, s) planes."""
    e = torch.roll(other, -1, 0)
    w = torch.roll(other, 1, 0)
    n = torch.where(odd, torch.roll(other, -1, 1), other)
    s = torch.where(odd, other, torch.roll(other, 1, 1))
    return e, w, n, s


def plane_neighbors_black(other, odd):
    """Neighbours of the BLACK cells read from the red plane (mirrored
    column offsets)."""
    e = torch.roll(other, -1, 0)
    w = torch.roll(other, 1, 0)
    n = torch.where(odd, other, torch.roll(other, -1, 1))
    s = torch.where(odd, torch.roll(other, 1, 1), other)
    return e, w, n, s


class PlaneStencil5:
    """5-point stencil + rhs in plane layout, split once per solve.  Holds
    the diagonal-normalised form for sweeps (``p_new = bh - sum(link_hat *
    neighbour)``) and the raw planes for residuals; each attribute is a
    (red, black) pair."""

    def __init__(self, st: Stencil9, b):
        invc = 1.0 / stencil9_diagonal(st)  # the smoothers' |c| < 1e-15 guard
        self.c = split_planes(st.c)
        self.e = split_planes(st.e)
        self.w = split_planes(st.w)
        self.n = split_planes(st.n)
        self.s = split_planes(st.s)
        self.b = split_planes(b)
        self.bh = split_planes(b * invc)
        self.eh = split_planes(st.e * invc)
        self.wh = split_planes(st.w * invc)
        self.nh = split_planes(st.n * invc)
        self.sh = split_planes(st.s * invc)
        # cells with a ZERO diagonal (the consistent variant's corner cells,
        # with no face links) lose their b term in the normalised-form
        # residual r = c * (bh - p - sum(Lh * nbr)) of the plane strip
        # kernels (ops/plane_strip.py); its restriction is added back once
        zero = torch.zeros_like(self.b[0])
        zR = torch.abs(self.c[0]) < 1e-15
        zB = torch.abs(self.c[1]) < 1e-15
        self.rc_zdiag = plane_restrict_cc(torch.where(zR, self.b[0], zero),
                                          torch.where(zB, self.b[1], zero))


def plane_rb_sweep(R, B, ps: PlaneStencil5):
    """One red-black Gauss-Seidel sweep in plane space (the diagonal-
    normalised re-association of the standard red-black sweep, omega 1)."""
    m, nc = R.shape
    odd = _row_parity(m, nc, R.device)
    e, w, n, s = plane_neighbors(B, odd)
    R = ps.bh[0] - (ps.eh[0] * e + ps.wh[0] * w + ps.nh[0] * n + ps.sh[0] * s)
    e, w, n, s = plane_neighbors_black(R, odd)
    B = ps.bh[1] - (ps.eh[1] * e + ps.wh[1] * w + ps.nh[1] * n + ps.sh[1] * s)
    return R, B


def plane_residual(R, B, ps: PlaneStencil5):
    """r = b - A p in plane space (raw planes)."""
    m, nc = R.shape
    odd = _row_parity(m, nc, R.device)
    e, w, n, s = plane_neighbors(B, odd)
    rR = ps.b[0] - (ps.c[0] * R + ps.e[0] * e + ps.w[0] * w + ps.n[0] * n + ps.s[0] * s)
    e, w, n, s = plane_neighbors_black(R, odd)
    rB = ps.b[1] - (ps.c[1] * B + ps.e[1] * e + ps.w[1] * w + ps.n[1] * n + ps.s[1] * s)
    return rR, rB


def plane_restrict_cc(rR, rB):
    """Cell-centred 2x2-mean restriction from planes to the STANDARD coarse
    layout: coarse[I, J] = mean of fine rows 2I, 2I+1 at column J of both
    planes."""
    s = rR + rB
    return 0.5 * (s[0::2] + s[1::2]) * 0.5


def plane_prolong_cc(ec):
    """Clamped bilinear cell-centred prolongation from the STANDARD coarse
    layout into correction planes (rows prolonged first; the column mix is
    picked by row parity: a fine cell's column parity within its row equals
    the row parity for red and its complement for black)."""
    t = _prolong_ax0(ec)  # (2*nxc, nyc): rows prolonged, columns coarse
    up = torch.cat([t[:, :1], t[:, :-1]], 1)  # ec[:, J-1] clamped
    dn = torch.cat([t[:, 1:], t[:, -1:]], 1)  # ec[:, J+1] clamped
    even_col = 0.75 * t + 0.25 * up  # fine column 2J
    odd_col = 0.75 * t + 0.25 * dn  # fine column 2J+1
    m, nc = t.shape
    odd = _row_parity(m, nc, t.device)
    return torch.where(odd, odd_col, even_col), torch.where(odd, even_col, odd_col)


# The plane-resident fine level of a V-cycle: b and the stencil are split
# once per solve and the planes merged once; every half-sweep in between
# touches half-size arrays.


def plane_fine_down(R, B, ps: PlaneStencil5, n_pre: int):
    """Pre-smooth + residual + cell-centred restriction with a plane-resident
    fine level.  Returns (R, B, r_coarse), r_coarse in STANDARD layout."""
    for _ in range(n_pre):
        R, B = plane_rb_sweep(R, B, ps)
    rR, rB = plane_residual(R, B, ps)
    return R, B, plane_restrict_cc(rR, rB)


def plane_fine_up(R, B, ps: PlaneStencil5, ec, n_post: int):
    """Prolongated coarse correction + post-smoothing, plane-resident."""
    efR, efB = plane_prolong_cc(ec)
    R, B = R + efR, B + efB
    for _ in range(n_post):
        R, B = plane_rb_sweep(R, B, ps)
    return R, B


def plane_residual_norm(R, B, ps: PlaneStencil5):
    """||b - A p|| without merging the planes."""
    rR, rB = plane_residual(R, B, ps)
    return torch.sqrt(torch.sum(rR * rR) + torch.sum(rB * rB))
