"""Window-form operator assembly for domain decomposition (port of
``naviflow_tpu/ops/windowed.py``).

The assemblies in ``ops/powerlaw.py`` / ``ops/poisson.py`` special-case the
physical boundaries with fixed-index updates, which only works when the
array spans the whole domain.  These window variants compute the same
coefficients for an arbitrary sub-block of the global grid, given
halo-extended local arrays and the block's global offset: every boundary
special case becomes a mask over global indices, so the same code runs on
one device (offset 0, full window) and on each rank's block
(``parallel/``).

Block layout (a rank owns cells gi0..gi0+nxl-1 x gj0..gj0+nyl-1; staggered
faces on block edges are duplicated between neighbours):

* local u: (nxl+1, nyl) faces gi0..gi0+nxl;
* local v: (nxl, nyl+1) faces gj0..gj0+nyl;
* local p: (nxl, nyl).

Halo-extended inputs carry ONE ring from the neighbours:

* ``u_ext``: (nxl+3, nyl+2) -- faces gi0-1 .. gi0+nxl+1, cells gj0-1 .. gj0+nyl;
* ``v_ext``: (nxl+2, nyl+3) -- cells gi0-1 .. gi0+nxl, faces gj0-1 .. gj0+nyl+1;
* ``p_ext``: (nxl+2, nyl+2).

Returned coefficient blocks cover exactly the local faces / cells, equal
bit for bit to the port's global assemblies (``tests/test_torch_windowed.py``).
``gi0`` and ``gj0`` are Python ints.
"""

from __future__ import annotations

import torch

from .highorder import SCHEME_WEIGHTS, MomentumCoeffs9, _assemble, shift
from .poisson import PoissonCoeffs
from .powerlaw import _relu, power_law_A
from .stencil import StencilCoeffs, pad2


def global_indices(shape, gi0, gj0, device):
    """Global (i, j) int32 index grids of a block of ``shape`` at (gi0, gj0)."""
    gi = gi0 + torch.arange(shape[0], dtype=torch.int32, device=device).view(-1, 1)
    gj = gj0 + torch.arange(shape[1], dtype=torch.int32, device=device).view(1, -1)
    return gi.expand(shape), gj.expand(shape)


def u_coefficients_window(
    u_ext, v_ext, p_ext, *, gi0, gj0, nx, ny, dx, dy, rho, mu
) -> StencilCoeffs:
    """u-momentum coefficients for local faces I = gi0 .. gi0+nxl (both
    block edges), cells J = gj0 .. gj0+nyl-1.  Output (nxl+1, nyl).
    Matches ``powerlaw.u_momentum_coefficients`` exactly."""
    De = mu * dy / dx
    Dn = mu * dx / dy

    uc = u_ext[1:-1, 1:-1]
    uE = u_ext[2:, 1:-1]
    uW = u_ext[:-2, 1:-1]
    uN = u_ext[1:-1, 2:]
    uS = u_ext[1:-1, :-2]
    # v at cells (I-1, I) x faces (J, J+1): face I pairs rows I-gi0 (cell
    # I-1) and I-gi0+1 (cell I) of v_ext
    vW_J = v_ext[:-1, 1:-2]
    vP_J = v_ext[1:, 1:-2]
    vW_J1 = v_ext[:-1, 2:-1]
    vP_J1 = v_ext[1:, 2:-1]
    pW = p_ext[:-1, 1:-1]
    pP = p_ext[1:, 1:-1]

    GI, GJ = global_indices(uc.shape, gi0, gj0, uc.device)
    zero = torch.zeros_like(uc)

    Fe = 0.5 * rho * dy * (uE + uc)
    Fw = 0.5 * rho * dy * (uW + uc)
    Fn = 0.5 * rho * dx * (vP_J1 + vW_J1)
    Fs = 0.5 * rho * dx * (vP_J + vW_J)
    Fn = torch.where(GJ == ny - 1, zero, Fn)  # no flow through the top wall
    Fs = torch.where(GJ == 0, zero, Fs)  # no flow through the bottom wall

    a_e = De * power_law_A(Fe, De) + _relu(-Fe)
    a_w = De * power_law_A(Fw, De) + _relu(Fw)
    a_n = Dn * power_law_A(Fn, Dn) + _relu(-Fn)
    a_s = Dn * power_law_A(Fs, Dn) + _relu(Fs)
    a_n = torch.where(GJ == ny - 1, zero, a_n)
    a_s = torch.where(GJ == 0, zero, a_s)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (pW - pP) * dy

    # Practice-B folds (global-index masks)
    src = torch.where(GI == 1, src + a_w * uW, src)
    a_w = torch.where(GI == 1, zero, a_w)
    src = torch.where(GI == nx - 1, src + a_e * uE, src)
    a_e = torch.where(GI == nx - 1, zero, a_e)
    src = torch.where(GJ == 1, src + a_s * uS, src)
    a_s = torch.where(GJ == 1, zero, a_s)
    src = torch.where(GJ == ny - 2, src + a_n * uN, src)
    a_n = torch.where(GJ == ny - 2, zero, a_n)

    # boundary faces I=0 and I=nx are never solved
    unsolved = (GI == 0) | (GI == nx)

    def z(x):
        return torch.where(unsolved, zero, x)

    return StencilCoeffs(a_e=z(a_e), a_w=z(a_w), a_n=z(a_n), a_s=z(a_s),
                         a_p=z(a_p), src=z(src))


def v_coefficients_window(
    u_ext, v_ext, p_ext, *, gi0, gj0, nx, ny, dx, dy, rho, mu
) -> StencilCoeffs:
    """v-momentum coefficients for local cells I = gi0 .. gi0+nxl-1, faces
    J = gj0 .. gj0+nyl (both block edges).  Output (nxl, nyl+1).
    Matches ``powerlaw.v_momentum_coefficients`` exactly."""
    De = mu * dy / dx
    Dn = mu * dx / dy

    vc = v_ext[1:-1, 1:-1]
    vE = v_ext[2:, 1:-1]
    vW = v_ext[:-2, 1:-1]
    vN = v_ext[1:-1, 2:]
    vS = v_ext[1:-1, :-2]
    # u at faces (I, I+1) x cells (J-1, J); u_ext rows are faces gi0-1..
    uI_J = u_ext[1:-2, 1:]
    uI1_J = u_ext[2:-1, 1:]
    uI_Jm = u_ext[1:-2, :-1]
    uI1_Jm = u_ext[2:-1, :-1]
    pS = p_ext[1:-1, :-1]
    pP = p_ext[1:-1, 1:]

    GI, GJ = global_indices(vc.shape, gi0, gj0, vc.device)
    zero = torch.zeros_like(vc)

    Fe = 0.5 * rho * dy * (uI1_J + uI1_Jm)
    Fw = 0.5 * rho * dy * (uI_J + uI_Jm)
    Fn = 0.5 * rho * dx * (vc + vN)
    Fs = 0.5 * rho * dx * (vS + vc)
    Fe = torch.where(GI == nx - 1, zero, Fe)  # no flow through the right wall
    Fw = torch.where(GI == 0, zero, Fw)  # no flow through the left wall

    a_e = De * power_law_A(Fe, De) + _relu(-Fe)
    a_w = De * power_law_A(Fw, De) + _relu(Fw)
    a_n = Dn * power_law_A(Fn, Dn) + _relu(-Fn)
    a_s = Dn * power_law_A(Fs, Dn) + _relu(Fs)
    a_e = torch.where(GI == nx - 1, zero, a_e)
    a_w = torch.where(GI == 0, zero, a_w)

    a_p = a_e + a_w + a_n + a_s + (Fe - Fw) + (Fn - Fs)
    src = (pS - pP) * dx

    src = torch.where(GJ == 1, src + a_s * vS, src)
    a_s = torch.where(GJ == 1, zero, a_s)
    src = torch.where(GJ == ny - 1, src + a_n * vN, src)
    a_n = torch.where(GJ == ny - 1, zero, a_n)
    src = torch.where(GI == 1, src + a_w * vW, src)
    a_w = torch.where(GI == 1, zero, a_w)
    src = torch.where(GI == nx - 2, src + a_e * vE, src)
    a_e = torch.where(GI == nx - 2, zero, a_e)

    unsolved = (GJ == 0) | (GJ == ny)

    def z(x):
        return torch.where(unsolved, zero, x)

    return StencilCoeffs(a_e=z(a_e), a_w=z(a_w), a_n=z(a_n), a_s=z(a_s),
                         a_p=z(a_p), src=z(src))


def _crop2(c: MomentumCoeffs9) -> MomentumCoeffs9:
    return c.map(lambda a: a[2:-2, 2:-2])


def u_coefficients9_window(
    u_ext2, v_ext2, p_ext2, *, gi0, gj0, nx, ny, dx, dy, rho, mu,
    scheme="quick",
) -> MomentumCoeffs9:
    """Windowed 9-point (QUICK / LUDS) u-momentum assembly.

    Two-ring halo-extended inputs (``parallel/decompose.extend_*2``):

    * ``u_ext2`` (nxl+5, nyl+4): faces gi0-2..gi0+nxl+2 x cells gj0-2..gj0+nyl+1
    * ``v_ext2`` (nxl+4, nyl+5): cells gi0-2..gi0+nxl+1 x faces gj0-2..gj0+nyl+2
    * ``p_ext2`` (nxl+4, nyl+4): cells, two rings

    The assembly runs on the extended window (every boundary special case a
    global-index mask, as ``highorder.u_momentum_coefficients9``) and the
    result is cropped to the local (nxl+1, nyl) faces: every +-2 shift the
    cropped region needs stays inside the extension.
    """
    weights = SCHEME_WEIGHTS[scheme]
    De = mu * dy / dx
    Dn = mu * dx / dy

    GI, GJ = global_indices(u_ext2.shape, gi0 - 2, gj0 - 2, u_ext2.device)
    solved = (GI >= 1) & (GI <= nx - 1) & (GJ >= 1) & (GJ <= ny - 2)

    Fe = 0.5 * rho * dy * (shift(u_ext2, 1, 0) + u_ext2)
    Fw = 0.5 * rho * dy * (shift(u_ext2, -1, 0) + u_ext2)
    # vN[r,c] = v[i, j+1] + v[i-1, j+1] at face i = gi0-2+r, cell j = gj0-2+c
    va = v_ext2[:, 1:]
    vN = pad2(va, 0, 1) + pad2(va, 1, 0)
    vb = v_ext2[:, :-1]
    vS = pad2(vb, 0, 1) + pad2(vb, 1, 0)
    Fn = 0.5 * rho * dx * vN
    Fs = 0.5 * rho * dx * vS
    zero = torch.zeros_like(Fe)
    Fn = torch.where(GJ == ny - 1, zero, Fn)
    Fs = torch.where(GJ == 0, zero, Fs)

    ok_e = GI <= nx - 2
    ok_w = GI >= 2
    ok_n = GJ <= ny - 3
    ok_s = GJ >= 2

    p_i = pad2(p_ext2, 0, 1)    # row r = p[i]
    p_im1 = pad2(p_ext2, 1, 0)  # row r = p[i-1]
    src = (p_im1 - p_i) * dy

    c = _assemble((Fe, Fw, Fn, Fs), (De, Dn), (ok_e, ok_w, ok_n, ok_s),
                  weights, src, solved, u_ext2)
    return _crop2(c)


def v_coefficients9_window(
    u_ext2, v_ext2, p_ext2, *, gi0, gj0, nx, ny, dx, dy, rho, mu,
    scheme="quick",
) -> MomentumCoeffs9:
    """Windowed 9-point v-momentum assembly (the mirror of the u variant);
    output (nxl, nyl+1)."""
    weights = SCHEME_WEIGHTS[scheme]
    De = mu * dy / dx
    Dn = mu * dx / dy

    GI, GJ = global_indices(v_ext2.shape, gi0 - 2, gj0 - 2, v_ext2.device)
    solved = (GI >= 1) & (GI <= nx - 2) & (GJ >= 1) & (GJ <= ny - 1)

    # uE[r,c] = u[i+1, j] + u[i+1, j-1] at cell i = gi0-2+r, face j = gj0-2+c
    ua = u_ext2[1:, :]
    uE = pad2(ua, 0, 0, 0, 1) + pad2(ua, 0, 0, 1, 0)
    ub = u_ext2[:-1, :]
    uW = pad2(ub, 0, 0, 0, 1) + pad2(ub, 0, 0, 1, 0)
    Fe = 0.5 * rho * dy * uE
    Fw = 0.5 * rho * dy * uW
    Fn = 0.5 * rho * dx * (v_ext2 + shift(v_ext2, 0, 1))
    Fs = 0.5 * rho * dx * (shift(v_ext2, 0, -1) + v_ext2)
    zero = torch.zeros_like(Fe)
    Fe = torch.where(GI == nx - 1, zero, Fe)
    Fw = torch.where(GI == 0, zero, Fw)

    ok_e = GI <= nx - 3
    ok_w = GI >= 2
    ok_n = GJ <= ny - 2
    ok_s = GJ >= 2

    p_j = pad2(p_ext2, 0, 0, 0, 1)
    p_jm1 = pad2(p_ext2, 0, 0, 1, 0)
    src = (p_jm1 - p_j) * dx

    c = _assemble((Fe, Fw, Fn, Fs), (De, Dn), (ok_e, ok_w, ok_n, ok_s),
                  weights, src, solved, v_ext2)
    return _crop2(c)


def poisson_coefficients_window(
    d_u_loc, d_v_loc, *, gi0, gj0, nx, ny, dx, dy, rho, variant="consistent"
) -> PoissonCoeffs:
    """Pressure-correction coefficients for local cells, from local d-fields.

    ``d_u_loc``: (nxl+1, nyl) faces including both block edges;
    ``d_v_loc``: (nxl, nyl+1).  Matches ``poisson.poisson_coefficients``.
    """
    nxl = d_v_loc.shape[0]
    nyl = d_u_loc.shape[1]
    dev = d_u_loc.device
    GI, GJ = global_indices((nxl, nyl), gi0, gj0, dev)
    zero = torch.zeros((nxl, nyl), dtype=d_u_loc.dtype, device=dev)

    d_u = d_u_loc
    d_v = d_v_loc
    if variant == "consistent":
        _, ju = global_indices(d_u.shape, gi0, gj0, dev)
        d_u = torch.where((ju == 0) | (ju == ny - 1), torch.zeros_like(d_u), d_u)
        iv, _ = global_indices(d_v.shape, gi0, gj0, dev)
        d_v = torch.where((iv == 0) | (iv == nx - 1), torch.zeros_like(d_v), d_v)

    a_e = torch.where(GI == nx - 1, zero, rho * d_u[1:, :] * dy)
    a_w = torch.where(GI == 0, zero, rho * d_u[:-1, :] * dy)
    a_n = torch.where(GJ == ny - 1, zero, rho * d_v[:, 1:] * dx)
    a_s = torch.where(GJ == 0, zero, rho * d_v[:, :-1] * dx)

    diag = torch.zeros_like(zero)
    if variant == "reference":
        diag = diag + torch.where(GI == 0, a_e, zero)
        diag = diag + torch.where(GI == nx - 1, a_w, zero)
        diag = diag + torch.where(GJ == 0, a_n, zero)
        diag = diag + torch.where(GJ == ny - 1, a_s, zero)
        a_e = torch.where(GI == 0, zero, a_e)
        a_w = torch.where(GI == nx - 1, zero, a_w)
        a_n = torch.where(GJ == 0, zero, a_n)
        a_s = torch.where(GJ == ny - 1, zero, a_s)
    elif variant not in ("symmetric", "consistent"):
        raise ValueError(f"Unknown poisson operator variant: {variant}")

    diag = diag + a_e + a_w + a_n + a_s
    return PoissonCoeffs(a_e=a_e, a_w=a_w, a_n=a_n, a_s=a_s, diag=diag)
