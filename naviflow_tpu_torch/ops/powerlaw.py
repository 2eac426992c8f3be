"""Power-law discretization of the staggered momentum equations (port of
``naviflow_tpu/ops/powerlaw.py``).

* face mass fluxes from staggered interpolation;
* ``a_face = D * A(|F/D|) + max(∓F, 0)`` with ``A(P) = max(0, 1-0.1P)^5``;
* ``a_p = sum(a_nb) + (Fe-Fw) + (Fn-Fs)`` with the boundary-row flux
  specializations (no flow through walls);
* pressure-gradient source ``(p_W - p_P)*dy`` / ``(p_S - p_P)*dx``;
* Practice-B boundary folding on all four sides: the known boundary velocity
  times its coefficient moves into the source and the link is cut.

The CUDA kernel of ``ops/asmcheby.py`` evaluates the same formulas per face
from global indices; the two are held together by ``chip_smoke.py``.

``mu`` is a number, or, in the vmapped batch step
(``algorithms/batch.py``), one case's viscous conductances from
:func:`case_conductances`: a tensor ``(De, Dn, 1 / De, 1 / Dn)`` in the
state's dtype, with which each case's coefficients round as its single
solve's do (:func:`conductances`, :func:`power_law_A`).
"""

from __future__ import annotations

import torch

from .stencil import StencilCoeffs, pad2, where_add, where_set


def case_conductances(mus, dx, dy, dtype, device=None):
    """Each case's ``(De, Dn, 1 / De, 1 / Dn)`` (B, 4) for the viscosities
    ``mus``: ``De = mu dy / dx``, ``Dn = mu dx / dy`` and their reciprocals
    in double on the host, rounded to ``dtype``, as the single solve's
    Python numbers are where they meet a tensor of that dtype (the
    reciprocal is the factor PyTorch's CUDA division by a Python number
    multiplies by: a case is bit-equal to its single solve on the H100 with
    it, and not with the reciprocal of the rounded D)."""
    pairs = [(mu * dy / dx, mu * dx / dy) for mu in mus]
    rows = [[de, dn, 1.0 / de, 1.0 / dn] for de, dn in pairs]
    return torch.tensor(rows, dtype=torch.float64).to(dtype).to(device)


def conductances(mu, dx, dy):
    """``(De, Dn, 1 / De, 1 / Dn)``: for a number ``mu``, ``mu dy / dx`` and
    ``mu dx / dy`` as Python numbers and no reciprocals; for one case's
    :func:`case_conductances` row, its four entries."""
    if torch.is_tensor(mu):
        return mu[0], mu[1], mu[2], mu[3]
    return mu * dy / dx, mu * dx / dy, None, None


def power_law_A(F, D, inv_D=None):
    """A(|P|) = max(0, 1 - 0.1|F/D|)^5, zero where |D| <= 1e-10.  With a
    per-case tensor ``D`` (and its reciprocal ``inv_D``) it rounds as the
    single solve's division by a Python number does: on a CUDA tensor
    PyTorch multiplies by the reciprocal, on the CPU it divides."""
    q = F * inv_D if inv_D is not None and F.is_cuda else F / D
    base = torch.clamp(1.0 - 0.1 * torch.abs(q), min=0.0)
    b2 = base * base
    b5 = b2 * b2 * base
    if torch.is_tensor(D):
        return torch.where(torch.abs(D) > 1e-10, b5, torch.zeros_like(b5))
    if abs(D) > 1e-10:
        return b5
    return torch.zeros_like(base)


def _relu(x):
    return torch.clamp(x, min=0.0)


def u_momentum_coefficients(u, v, p, *, dx, dy, rho, mu) -> StencilCoeffs:
    """Unrelaxed u-momentum coefficients on the full (nx+1, ny) grid.

    Rows i=0 and i=nx (boundary u nodes) are all-zero: they are never solved.
    """
    nxp1, ny = u.shape
    nx = nxp1 - 1
    De, Dn, iDe, iDn = conductances(mu, dx, dy)

    # Solved rows i = 1 .. nx-1 (local row r corresponds to i = r+1).
    uc = u[1:nx, :]
    Fe = 0.5 * rho * dy * (u[2: nx + 1, :] + uc)
    Fw = 0.5 * rho * dy * (u[0: nx - 1, :] + uc)
    Fn = 0.5 * rho * dx * (v[1:nx, 1:] + v[0: nx - 1, 1:])
    Fs = 0.5 * rho * dx * (v[1:nx, :-1] + v[0: nx - 1, :-1])
    Fn = where_set(Fn, 0.0, cols=ny - 1)
    Fs = where_set(Fs, 0.0, cols=0)

    a_e = De * power_law_A(Fe, De, iDe) + _relu(-Fe)
    a_w = De * power_law_A(Fw, De, iDe) + _relu(Fw)
    a_n = Dn * power_law_A(Fn, Dn, iDn) + _relu(-Fn)
    a_s = Dn * power_law_A(Fs, Dn, iDn) + _relu(Fs)
    a_n = where_set(a_n, 0.0, cols=ny - 1)
    a_s = where_set(a_s, 0.0, cols=0)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (p[0: nx - 1, :] - p[1:nx, :]) * dy

    # Practice B (local row 0 is i=1; local row nx-2 is i=nx-1).
    src = where_add(src, a_w[0, :] * u[0, :], rows=0)
    a_w = where_set(a_w, 0.0, rows=0)
    src = where_add(src, a_e[nx - 2, :] * u[nx, :], rows=nx - 2)
    a_e = where_set(a_e, 0.0, rows=nx - 2)
    src = where_add(src, a_s[:, 1] * u[1:nx, 0], cols=1)
    a_s = where_set(a_s, 0.0, cols=1)
    src = where_add(src, a_n[:, ny - 2] * u[1:nx, ny - 1], cols=ny - 2)
    a_n = where_set(a_n, 0.0, cols=ny - 2)

    def pad(x):
        return pad2(x, 1, 1)

    return StencilCoeffs(a_e=pad(a_e), a_w=pad(a_w), a_n=pad(a_n),
                         a_s=pad(a_s), a_p=pad(a_p), src=pad(src))


def v_momentum_coefficients(u, v, p, *, dx, dy, rho, mu) -> StencilCoeffs:
    """Unrelaxed v-momentum coefficients on the full (nx, ny+1) grid.

    Columns j=0 and j=ny (boundary v nodes) are all-zero; the left/right
    columns i=0 and i=nx-1 carry the wall-flux specializations (they feed
    d_v even though v there is fixed by BCs).
    """
    nx, nyp1 = v.shape
    ny = nyp1 - 1
    De, Dn, iDe, iDn = conductances(mu, dx, dy)

    # Solved columns j = 1 .. ny-1 (local column c corresponds to j = c+1).
    Fe = 0.5 * rho * dy * (u[1: nx + 1, 1:ny] + u[1: nx + 1, 0: ny - 1])
    Fw = 0.5 * rho * dy * (u[0:nx, 1:ny] + u[0:nx, 0: ny - 1])
    Fe = where_set(Fe, 0.0, rows=nx - 1)
    Fw = where_set(Fw, 0.0, rows=0)
    Fn = 0.5 * rho * dx * (v[:, 1:ny] + v[:, 2: ny + 1])
    Fs = 0.5 * rho * dx * (v[:, 0: ny - 1] + v[:, 1:ny])

    a_e = De * power_law_A(Fe, De, iDe) + _relu(-Fe)
    a_w = De * power_law_A(Fw, De, iDe) + _relu(Fw)
    a_n = Dn * power_law_A(Fn, Dn, iDn) + _relu(-Fn)
    a_s = Dn * power_law_A(Fs, Dn, iDn) + _relu(Fs)
    a_e = where_set(a_e, 0.0, rows=nx - 1)
    a_w = where_set(a_w, 0.0, rows=0)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (p[:, 0: ny - 1] - p[:, 1:ny]) * dx

    # Practice B (local column 0 is j=1; local column ny-2 is j=ny-1).
    src = where_add(src, a_s[:, 0] * v[:, 0], cols=0)
    a_s = where_set(a_s, 0.0, cols=0)
    src = where_add(src, a_n[:, ny - 2] * v[:, ny], cols=ny - 2)
    a_n = where_set(a_n, 0.0, cols=ny - 2)
    src = where_add(src, a_w[1, :] * v[0, 1:ny], rows=1)
    a_w = where_set(a_w, 0.0, rows=1)
    src = where_add(src, a_e[nx - 2, :] * v[nx - 1, 1:ny], rows=nx - 2)
    a_e = where_set(a_e, 0.0, rows=nx - 2)

    def pad(x):
        return pad2(x, 0, 0, 1, 1)

    return StencilCoeffs(a_e=pad(a_e), a_w=pad(a_w), a_n=pad(a_n),
                         a_s=pad(a_s), a_p=pad(a_p), src=pad(src))


def relax_coefficients(coeffs: StencilCoeffs, field, alpha: float) -> StencilCoeffs:
    """Patankar implicit under-relaxation: ``a_p/alpha``,
    ``src += (1-alpha) * (a_p/alpha) * field_old`` (1e-12 floor on a_p)."""
    a_p = coeffs.a_p
    a_p_floor = torch.where(torch.abs(a_p) > 1e-12, a_p,
                            torch.full_like(a_p, 1e-12))
    a_p_rel = a_p_floor / alpha
    src_rel = coeffs.src + (1.0 - alpha) * a_p_rel * field
    return coeffs.replace(a_p=a_p_rel, src=src_rel)


def d_coefficient(a_p_relaxed, spacing, *, is_u: bool):
    """d = spacing / a_p_relaxed, masked to zero on the unsolved boundary
    rows/columns (the momentum -> pressure dataflow contract)."""
    d = torch.where(torch.abs(a_p_relaxed) > 1e-12, spacing / a_p_relaxed,
                    torch.zeros_like(a_p_relaxed))
    if is_u:
        d = where_set(where_set(d, 0.0, rows=0), 0.0, rows=d.shape[0] - 1)
    else:
        d = where_set(where_set(d, 0.0, cols=0), 0.0, cols=d.shape[1] - 1)
    return d
