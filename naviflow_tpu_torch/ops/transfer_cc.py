"""Cell-centered multigrid transfers for even grid sizes (port of
``naviflow_tpu/ops/transfer_cc.py``).

``nc = nf / 2``, coarse cell (I, J) covers the 2x2 fine block.

* :func:`restrict_cc` — 2x2 block average;
* :func:`prolong_cc` — bilinear cell-centered interpolation (per-axis weights
  3/4 nearest / 1/4 next, clamped at boundaries).

Both are separable: an axis-0 half then an axis-1 half, in that order (the
rounding order of the JAX package).  Written with plain strided slicing —
the JAX package's transpose sandwich is a TPU layout device.
"""

from __future__ import annotations

import torch


def _restrict_ax0(y):
    """(2m, n) -> (m, n): average adjacent row pairs."""
    return 0.5 * (y[0::2] + y[1::2])


def _restrict_ax1(y):
    return 0.5 * (y[:, 0::2] + y[:, 1::2])


def restrict_cc(fine):
    """(2m, 2n) -> (m, n): mean over each 2x2 block."""
    return _restrict_ax1(_restrict_ax0(fine))


def _prolong_ax0(c):
    """(m, n) -> (2m, n) bilinear along axis 0 with clamped edges."""
    up = torch.cat([c[:1], c[:-1]], 0)  # c[I-1] clamped
    dn = torch.cat([c[1:], c[-1:]], 0)  # c[I+1] clamped
    # new_empty: under torch.func.vmap (the batched step) the buffer takes
    # c's case axis
    out = c.new_empty((2 * c.shape[0], c.shape[1]))
    out[0::2] = 0.75 * c + 0.25 * up  # fine row 2I
    out[1::2] = 0.75 * c + 0.25 * dn  # fine row 2I+1
    return out


def _prolong_ax1(c):
    return _prolong_ax0(c.T).T


def prolong_cc(coarse):
    """(m, n) -> (2m, 2n) bilinear cell-centered interpolation."""
    return _prolong_ax1(_prolong_ax0(coarse)).contiguous()
