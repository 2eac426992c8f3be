"""Vertex-centred multigrid transfers (port of ``naviflow_tpu/ops/transfer.py``).

Grid convention: levels are ``2**k - 1`` cells per axis; coarse cell (I, J)
coincides with fine cell (2I+1, 2J+1), so ``nc = (nf - 1) // 2``.

* injection restriction ``fine[1::2, 1::2]``;
* full-weighting restriction: the tensor product of per-axis
  (1/4, 1/2, 1/4) stencils (the h^2-scaled weights);
* bilinear prolongation: injection at (2I+1, 2J+1), midpoint averages
  between, boundary slabs copied from the first interior line;
* cubic prolongation: the same layout with Catmull-Rom midpoints (only a
  correction prolongation for ``coarsening='rediscretize'``);
* harmonic-mean d-coefficient restriction with the 0.25 Poisson rescale
  and boundary injection (the rediscretized coarse levels).

Each 2-D transfer is the 1-D operator along axis 0, then along axis 1, in
the JAX package's order, so both round alike.
"""

from __future__ import annotations

import torch


def coarse_size(nf: int) -> int:
    return (nf - 1) // 2


def restrict_inject(fine):
    """Injection at odd indices."""
    return fine[1::2, 1::2]


def _fw_ax0(y):
    """(nf, n) -> (nc, n) full-weighting rows: 1/4 y[2I] + 1/2 y[2I+1] +
    1/4 y[2I+2]."""
    return 0.25 * y[0:-2:2] + 0.5 * y[1::2] + 0.25 * y[2::2]


def restrict_full_weighting(fine):
    """h^2-scaled full weighting: per-axis (1/4, 1/2, 1/4) along axis 0,
    then along axis 1."""
    return _fw_ax0(_fw_ax0(fine).T).T


def _interleave_ax0(c, mid):
    """(nc, n) rows and their nc - 1 midpoints -> (2nc+1, n): fine row
    2I+1 = c[I], row 2I+2 = mid[I], rows 0 / nf-1 = copies of the adjacent
    interior row."""
    nc = c.shape[0]
    out = c.new_empty((2 * nc + 1,) + tuple(c.shape[1:]))
    out[1::2] = c
    out[2:-1:2] = mid
    out[0] = c[0]
    out[-1] = c[-1]
    return out


def _linear_ax0(c):
    """(nc, n) -> (2nc+1, n) vertex bilinear rows."""
    return _interleave_ax0(c, 0.5 * (c[:-1] + c[1:]))


def prolong_linear(coarse, mx: int = None, my: int = None):
    """Bilinear prolongation to the (2nc+1, 2mc+1) fine grid."""
    del mx, my  # implied by the coarse shape
    return _linear_ax0(_linear_ax0(coarse).T).T


def _cubic_midpoints(c):
    """Midpoints between consecutive rows: 4-point cubic (Catmull-Rom at
    t = 1/2) weights (-1, 9, 9, -1)/16 in the interior, the linear average
    in the first and last interval."""
    lin = 0.5 * (c[:-1] + c[1:])
    if c.shape[0] >= 4:
        cub = (-c[:-3] + 9.0 * c[1:-2] + 9.0 * c[2:-1] - c[3:]) / 16.0
        return torch.cat([lin[:1], cub, lin[-1:]], 0)
    return lin


def prolong_cubic(coarse, mx: int = None, my: int = None):
    """Cubic prolongation to the (2nc+1, 2mc+1) fine grid: a local
    tensor-product cubic (Catmull-Rom midpoints), boundary slabs copied as
    :func:`prolong_linear` does.  Only valid with
    ``coarsening='rediscretize'``: its 4-wide support breaks the comb
    recovery of the Galerkin RAP."""
    del mx, my  # implied by the coarse shape

    def ax0(c):
        return _interleave_ax0(c, _cubic_midpoints(c))

    return ax0(ax0(coarse).T).T


def _harmonic_pair(d1, d2):
    """Harmonic mean where both are positive, else the arithmetic mean."""
    both = (d1 > 0) & (d2 > 0)
    one = torch.ones_like(d1)
    harm = 2.0 / (1.0 / torch.where(both, d1, one) + 1.0 / torch.where(both, d2, one))
    return torch.where(both, harm, 0.5 * (d1 + d2))


def restrict_d_coefficients(d_u, d_v):
    """Harmonic-mean restriction of the momentum d-fields with the 0.25
    Poisson rescale.  d_u_coarse[I, J] pairs fine faces (2I, 2J) and
    (2I+1, 2J); boundary faces are injected.  Output shapes:
    ((nxc+1, nyc), (nxc, nyc+1))."""
    nxf = d_u.shape[0] - 1
    nyf = d_v.shape[1] - 1
    nxc, nyc = coarse_size(nxf), coarse_size(nyf)

    du_c = d_u.new_zeros((nxc + 1, nyc))
    du_c[1:nxc, :] = _harmonic_pair(d_u[2:nxf - 1:2, 0:nyf - 1:2], d_u[3:nxf:2, 0:nyf - 1:2])
    du_c[0, :] = d_u[0, 0:nyf - 1:2]
    du_c[nxc, :] = d_u[nxf, 0:nyf - 1:2]

    dv_c = d_v.new_zeros((nxc, nyc + 1))
    dv_c[:, 1:nyc] = _harmonic_pair(d_v[0:nxf - 1:2, 2:nyf - 1:2], d_v[0:nxf - 1:2, 3:nyf:2])
    dv_c[:, 0] = d_v[0:nxf - 1:2, 0]
    dv_c[:, nyc] = d_v[0:nxf - 1:2, nyf]

    return 0.25 * du_c, 0.25 * dv_c
