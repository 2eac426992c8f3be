"""Higher-order momentum discretizations: QUICK and second-order (linear)
upwind as fully implicit 9-point (second-neighbour) stencils (port of
``naviflow_tpu/ops/highorder.py``).

Every face always carries its diffusion and a consistent convection
closure, and ``a_p`` is assembled so that the operator annihilates
constants up to the continuity imbalance (the power-law identity).

Face interpolation weights (phi_face = w_uu*phi_UU + w_u*phi_U + w_d*phi_D,
U = upwind cell, D = downwind cell):
    QUICK : (-1/8, 6/8, 3/8)
    LUDS  : (-1/2, 3/2, 0)
    upwind: (0, 1, 0)            (the wall-adjacent fallback)

Practice-B is generalized: after assembly every coefficient whose neighbour
is an unsolved (boundary) node is folded into the source with the
neighbour's current (BC) value and the link is cut.  No CUDA kernel takes a
9-point system: every kernel gate refuses these schemes, as the JAX
package's do.

``mu`` is a number, or, in the vmapped batch step
(``algorithms/batch.py``), one case's ``powerlaw.case_conductances`` row:
the diffusion conductances come from ``powerlaw.conductances`` either way,
so that a case rounds as its single solve does.
"""

from __future__ import annotations

import dataclasses

import torch

from .powerlaw import conductances
from .stencil import index_grids, pad2


def shift(x, di: int, dj: int):
    """x[i+di, j+dj] with zero padding."""
    if di > 0:
        x = pad2(x[di:, :], 0, di)
    elif di < 0:
        x = pad2(x[:di, :], -di, 0)
    if dj > 0:
        x = pad2(x[:, dj:], 0, 0, 0, dj)
    elif dj < 0:
        x = pad2(x[:, :dj], 0, 0, -dj, 0)
    return x


_OFFSETS = {
    "a_e": (1, 0), "a_w": (-1, 0), "a_n": (0, 1), "a_s": (0, -1),
    "a_ee": (2, 0), "a_ww": (-2, 0), "a_nn": (0, 2), "a_ss": (0, -2),
}


@dataclasses.dataclass(frozen=True)
class MomentumCoeffs9:
    """9-point momentum stencil: a_p*x - sum(a_nb * x_nb) = src."""

    a_e: torch.Tensor
    a_w: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    a_ee: torch.Tensor
    a_ww: torch.Tensor
    a_nn: torch.Tensor
    a_ss: torch.Tensor
    a_p: torch.Tensor
    src: torch.Tensor

    def replace(self, **kw) -> "MomentumCoeffs9":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "MomentumCoeffs9":
        """Every array through ``fn`` (a crop, a dtype cast)."""
        return MomentumCoeffs9(**{f.name: fn(getattr(self, f.name))
                                  for f in dataclasses.fields(self)})


def apply_momentum9(x, c: MomentumCoeffs9):
    out = c.a_p * x
    for name, (di, dj) in _OFFSETS.items():
        out = out - getattr(c, name) * shift(x, di, dj)
    return out


def neighbor_sum9(x, c: MomentumCoeffs9):
    out = torch.zeros_like(x)
    for name, (di, dj) in _OFFSETS.items():
        out = out + getattr(c, name) * shift(x, di, dj)
    return out


SCHEME_WEIGHTS = {
    "quick": (-1.0 / 8.0, 6.0 / 8.0, 3.0 / 8.0),
    "luds": (-0.5, 1.5, 0.0),
    "upwind": (0.0, 1.0, 0.0),
}


def _face_contributions(F, D, hi_res_ok, weights):
    """Coefficient contributions of one face of cell P along one axis:
    ``(a_p, a_n1, a_n2f, a_n2b)`` -- the centre, the first neighbour across
    the face, the second neighbour across it and the second neighbour
    behind P.  ``hi_res_ok`` masks where the high-resolution stencil fits;
    elsewhere the face falls back to first-order upwind.  Diffusion ``D``
    is always applied."""
    w_uu, w_u, w_d = weights
    Fp = torch.clamp(F, min=0.0)
    Fm = torch.clamp(-F, min=0.0)
    zero = torch.zeros_like(F)

    # high-resolution branch: a_nb = -(LHS coefficient of phi_nb)
    hp = w_u * Fp - w_d * Fm
    hn1 = -w_d * Fp + w_u * Fm
    hn2b = -w_uu * Fp
    hn2f = w_uu * Fm

    # upwind fallback: F>0: Fp*phi_P ; F<0: -Fm*phi_N1 => a_n1 += Fm
    lp = Fp
    ln1 = Fm

    p = torch.where(hi_res_ok, hp, lp)
    a_n1 = torch.where(hi_res_ok, hn1, ln1) + D
    a_n2b = torch.where(hi_res_ok, hn2b, zero)
    a_n2f = torch.where(hi_res_ok, hn2f, zero)
    a_p = p + D
    return a_p, a_n1, a_n2f, a_n2b


def _assemble(F_faces, D_pair, masks, weights, src, solved, field_vals):
    """Shared 9-point assembly from the four face fluxes."""
    (Fe, Fw, Fn, Fs) = F_faces
    (De, Dn) = D_pair
    (ok_e, ok_w, ok_n, ok_s) = masks

    a = {k: torch.zeros_like(Fe) for k in _OFFSETS}
    a_p = torch.zeros_like(Fe)

    # east face: d=E; F>0 upwind P (uu=W); F<0 upwind E (uu=EE)
    p_c, a_E, a_EE, a_W = _face_contributions(Fe, De, ok_e, weights)
    a_p = a_p + p_c
    a["a_e"] = a["a_e"] + a_E
    a["a_ee"] = a["a_ee"] + a_EE
    a["a_w"] = a["a_w"] + a_W
    # west face: the flux enters with -Fw; d=W
    p_c, a_Wc, a_WW, a_E2 = _face_contributions(-Fw, De, ok_w, weights)
    a_p = a_p + p_c
    a["a_w"] = a["a_w"] + a_Wc
    a["a_ww"] = a["a_ww"] + a_WW
    a["a_e"] = a["a_e"] + a_E2
    # north face
    p_c, a_N, a_NN, a_S = _face_contributions(Fn, Dn, ok_n, weights)
    a_p = a_p + p_c
    a["a_n"] = a["a_n"] + a_N
    a["a_nn"] = a["a_nn"] + a_NN
    a["a_s"] = a["a_s"] + a_S
    # south face
    p_c, a_Sc, a_SS, a_N2 = _face_contributions(-Fs, Dn, ok_s, weights)
    a_p = a_p + p_c
    a["a_s"] = a["a_s"] + a_Sc
    a["a_ss"] = a["a_ss"] + a_SS
    a["a_n"] = a["a_n"] + a_N2

    # conservative diagonal: a_p = sum(a_nb) + net outflow (summed in the
    # JAX package's order: Python's sum from 0 over the dict's values)
    a_p = sum(a.values()) + (Fe - Fw) + (Fn - Fs)

    # generalized Practice-B: cut links to unsolved nodes, fold BC values
    solved_f = solved.to(Fe.dtype)
    for name, (di, dj) in _OFFSETS.items():
        nb_solved = shift(solved_f, di, dj) > 0.5
        nb_val = shift(field_vals, di, dj)
        src = torch.where(~nb_solved, src + a[name] * nb_val, src)
        a[name] = torch.where(~nb_solved, torch.zeros_like(a[name]), a[name])

    zero = torch.zeros_like(Fe)

    def z(x):
        return torch.where(solved, x, zero)

    return MomentumCoeffs9(
        a_e=z(a["a_e"]), a_w=z(a["a_w"]), a_n=z(a["a_n"]), a_s=z(a["a_s"]),
        a_ee=z(a["a_ee"]), a_ww=z(a["a_ww"]), a_nn=z(a["a_nn"]), a_ss=z(a["a_ss"]),
        a_p=z(a_p), src=z(src),
    )


def u_momentum_coefficients9(u, v, p, *, dx, dy, rho, mu, scheme="quick") -> MomentumCoeffs9:
    """9-point u-momentum assembly on the full (nx+1, ny) grid."""
    nxp1, ny = u.shape
    nx = nxp1 - 1
    weights = SCHEME_WEIGHTS[scheme]
    De, Dn, _, _ = conductances(mu, dx, dy)

    ii, jj = index_grids(u.shape, u.device)
    solved = (ii >= 1) & (ii <= nx - 1) & (jj >= 1) & (jj <= ny - 2)

    Fe = 0.5 * rho * dy * (shift(u, 1, 0) + u)
    Fw = 0.5 * rho * dy * (shift(u, -1, 0) + u)
    # Fn[i,j] = 0.5*rho*dx*(v[i,j+1] + v[i-1,j+1]); Fs uses column j
    vN = pad2(v[:, 1:], 0, 1) + pad2(v[:, 1:], 1, 0)
    vS = pad2(v[:, :-1], 0, 1) + pad2(v[:, :-1], 1, 0)
    zero = torch.zeros_like(Fe)
    # no flow through the top / bottom walls
    Fn = torch.where(jj == ny - 1, zero, 0.5 * rho * dx * vN)
    Fs = torch.where(jj == 0, zero, 0.5 * rho * dx * vS)

    # high-resolution masks: both stencil nodes of the face exist in-grid
    ok_e = ii <= nx - 2
    ok_w = ii >= 2
    ok_n = jj <= ny - 3
    ok_s = jj >= 2

    pw = pad2(p, 1, 1)  # rows = cells -1..nx
    src = (pw[:-1, :] - pw[1:, :]) * dy  # (p[i-1] - p[i]) at face i

    return _assemble((Fe, Fw, Fn, Fs), (De, Dn), (ok_e, ok_w, ok_n, ok_s),
                     weights, src, solved, u)


def v_momentum_coefficients9(u, v, p, *, dx, dy, rho, mu, scheme="quick") -> MomentumCoeffs9:
    """9-point v-momentum assembly on the full (nx, ny+1) grid."""
    nx, nyp1 = v.shape
    ny = nyp1 - 1
    weights = SCHEME_WEIGHTS[scheme]
    De, Dn, _, _ = conductances(mu, dx, dy)

    ii, jj = index_grids(v.shape, v.device)
    solved = (ii >= 1) & (ii <= nx - 2) & (jj >= 1) & (jj <= ny - 1)

    # Fe[i,j] = 0.5*rho*dy*(u[i+1,j] + u[i+1,j-1]); Fw uses face i
    uE = pad2(u[1:, :], 0, 0, 0, 1) + pad2(u[1:, :], 0, 0, 1, 0)
    uW = pad2(u[:-1, :], 0, 0, 0, 1) + pad2(u[:-1, :], 0, 0, 1, 0)
    zero = torch.zeros_like(v)
    # no flow through the left / right walls
    Fe = torch.where(ii == nx - 1, zero, 0.5 * rho * dy * uE)
    Fw = torch.where(ii == 0, zero, 0.5 * rho * dy * uW)
    Fn = 0.5 * rho * dx * (v + shift(v, 0, 1))
    Fs = 0.5 * rho * dx * (shift(v, 0, -1) + v)

    ok_e = ii <= nx - 3
    ok_w = ii >= 2
    ok_n = jj <= ny - 2
    ok_s = jj >= 2

    pw = pad2(p, 0, 0, 1, 1)  # cols = cells -1..ny
    src = (pw[:, :-1] - pw[:, 1:]) * dx  # (p[j-1] - p[j]) at face j

    return _assemble((Fe, Fw, Fn, Fs), (De, Dn), (ok_e, ok_w, ok_n, ok_s),
                     weights, src, solved, v)


def relax_coefficients9(c: MomentumCoeffs9, field, alpha: float) -> MomentumCoeffs9:
    a_p_floor = torch.where(torch.abs(c.a_p) > 1e-12, c.a_p, torch.full_like(c.a_p, 1e-12))
    a_p_rel = a_p_floor / alpha
    src_rel = c.src + (1.0 - alpha) * a_p_rel * field
    return c.replace(a_p=a_p_rel, src=src_rel)
