"""Vertex-centred multigrid transfers (port of ``naviflow_tpu/ops/transfer.py``,
the subset the odd-grid Galerkin path uses).

Grid convention: levels are ``2**k - 1`` cells per axis; coarse cell (I, J)
coincides with fine cell (2I+1, 2J+1), so ``nc = (nf - 1) // 2``.

* injection restriction ``fine[1::2, 1::2]``;
* full-weighting restriction: the tensor product of per-axis
  (1/4, 1/2, 1/4) stencils (the h^2-scaled weights);
* bilinear prolongation: injection at (2I+1, 2J+1), midpoint averages
  between, boundary slabs copied from the first interior line.

Each 2-D transfer is the 1-D operator along axis 0, then along axis 1, in
the JAX package's order, so both round alike.  ``prolong_cubic`` and
``restrict_d_coefficients`` are not ported yet (ROADMAP §1 item 10).
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


def _linear_ax0(c):
    """(nc, n) -> (2nc+1, n) vertex bilinear rows: fine row 2I+1 = c[I],
    row 2I+2 = midpoint, rows 0 / nf-1 = copies of the adjacent interior row."""
    nc = c.shape[0]
    out = torch.empty((2 * nc + 1,) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
    out[1::2] = c
    out[2:-1:2] = 0.5 * (c[:-1] + c[1:])
    out[0] = c[0]
    out[-1] = c[-1]
    return out


def prolong_linear(coarse, mx: int = None, my: int = None):
    """Bilinear prolongation to the (2nc+1, 2mc+1) fine grid."""
    del mx, my  # implied by the coarse shape
    return _linear_ax0(_linear_ax0(coarse).T).T
