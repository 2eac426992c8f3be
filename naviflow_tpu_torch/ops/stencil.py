"""Shift helpers and the generic 5-point stencil apply (port of
``naviflow_tpu/ops/stencil.py``).

Index convention: axis 0 is i (x / east-west), axis 1 is j (y /
north-south).  ``shift_e(x)[i, j] == x[i+1, j]`` (zero beyond the boundary).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F


def pad2(x, i_lo=0, i_hi=0, j_lo=0, j_hi=0, value=0.0):
    """Zero (or ``value``) padding of a 2-D tensor, given per-axis margins
    in the JAX ``((i_lo, i_hi), (j_lo, j_hi))`` order."""
    return F.pad(x, (j_lo, j_hi, i_lo, i_hi), value=value)


def shift_e(x):
    """x[i+1, j], zero-padded at the east edge."""
    return pad2(x[1:, :], 0, 1)


def shift_w(x):
    """x[i-1, j], zero-padded at the west edge."""
    return pad2(x[:-1, :], 1, 0)


def shift_n(x):
    """x[i, j+1], zero-padded at the north edge."""
    return pad2(x[:, 1:], 0, 0, 0, 1)


def shift_s(x):
    """x[i, j-1], zero-padded at the south edge."""
    return pad2(x[:, :-1], 0, 0, 1, 0)


@dataclasses.dataclass(frozen=True)
class StencilCoeffs:
    """5-point stencil coefficients + source, all full-grid tensors.

    Row form: ``a_p * x_P - a_e * x_E - a_w * x_W - a_n * x_N - a_s * x_S = src``.
    """

    a_e: torch.Tensor
    a_w: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    a_p: torch.Tensor
    src: torch.Tensor

    def replace(self, **kw) -> "StencilCoeffs":
        return dataclasses.replace(self, **kw)


def apply_stencil(x, c: StencilCoeffs):
    """A @ x for the 5-point operator (full grid)."""
    return (
        c.a_p * x
        - c.a_e * shift_e(x)
        - c.a_w * shift_w(x)
        - c.a_n * shift_n(x)
        - c.a_s * shift_s(x)
    )


def neighbor_sum(x, c: StencilCoeffs):
    """Sum of off-diagonal contributions a_e*x_E + a_w*x_W + a_n*x_N + a_s*x_S."""
    return (
        c.a_e * shift_e(x)
        + c.a_w * shift_w(x)
        + c.a_n * shift_n(x)
        + c.a_s * shift_s(x)
    )


def _index(rows, cols):
    def one(k):
        if k is None:
            return slice(None)
        if isinstance(k, int):
            return k
        return slice(k[0], k[1])

    return one(rows), one(cols)


@functools.lru_cache(maxsize=256)
def _slab_mask(shape, rows, cols, device):
    """The boolean mask of the slab ``[rows, cols]`` of an array of
    ``shape`` (built once per shape, slab and device)."""
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    mask[_index(rows, cols)] = True
    return mask


def _on_slab(x, val, rows, cols):
    """``val`` as it lands on the slab ``[rows, cols]`` of ``x``, broadcast
    to ``x``'s shape (a view: the values off the slab are never read).  A
    1-D ``val`` written into one row runs along axis 1, into one column
    down axis 0, as in the JAX form."""
    if not torch.is_tensor(val) or val.dim() == 0:
        return val
    if isinstance(rows, int) and cols is None:
        return val.reshape(1, -1).expand(x.shape)
    if isinstance(cols, int) and rows is None:
        return val.reshape(-1, 1).expand(x.shape)
    raise ValueError(f"a {val.dim()}-D value for the slab [{rows}, {cols}]")


def where_set(x, val, *, rows=None, cols=None):
    """``x.at[rows, cols].set(val)``: a copy of ``x`` with the slab set,
    out of place (one ``where``, so ``torch.func`` transforms and traces
    see no write into a tensor).

    ``rows``/``cols``: an int index, a ``(lo, hi)`` half-open range, or
    ``None`` (whole axis); ``val`` a scalar, or a 1-D tensor along one
    row or column.
    """
    mask = _slab_mask(tuple(x.shape), rows, cols, x.device)
    return torch.where(mask, _on_slab(x, val, rows, cols), x)


def where_add(x, delta, *, rows=None, cols=None):
    """``x.at[rows, cols].add(delta)``: a copy of ``x`` with the slab added
    to, out of place (as :func:`where_set`)."""
    mask = _slab_mask(tuple(x.shape), rows, cols, x.device)
    return torch.where(mask, x + _on_slab(x, delta, rows, cols), x)


def index_grids(shape, device=None):
    """Global (i, j) index tensors of ``shape`` (int64)."""
    ii = torch.arange(shape[0], device=device).view(-1, 1).expand(shape)
    jj = torch.arange(shape[1], device=device).view(1, -1).expand(shape)
    return ii, jj


def interior_mask(shape, lo_i=1, hi_i=1, lo_j=1, hi_j=1, dtype=torch.bool,
                  device=None):
    """Mask that is True strictly inside the given margins."""
    ni, nj = shape
    ii, jj = index_grids(shape, device)
    m = (ii >= lo_i) & (ii <= ni - 1 - hi_i) & (jj >= lo_j) & (jj <= nj - 1 - hi_j)
    return m.to(dtype) if dtype is not torch.bool else m
