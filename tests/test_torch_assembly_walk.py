"""K8's strip walk (``csrc/assembly.cu``) modelled in float32 numpy on the
CPU: the tiles of warp strips (two columns a lane), the v strips leaning
onto whole lines where ny % 64 == 0, the terms lane 0 lacks computed before each walk, the west
terms carried down the rows (from the lane to the left where the strip
leans), the south terms shuffled from the lane neighbour, and the fold's
operator from the d written.  Each form's every output is written once and
is bit-equal to the one-thread-a-face formulas (every face's coefficients
from global indices, d and the pressure operator from the four faces' full
coefficients: the kernel this design replaced); the model also agrees with
the port's plain version and with the JAX package's Pallas kernel in
interpret mode at their tolerances.  The strip width and the tile's row
cap are parsed from the source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_assembly import fused_assembly_pair as j_assembly

from naviflow_tpu_torch.ops import assembly

torch.set_num_threads(2)

SRC = (Path(assembly.__file__).resolve().parent.parent / "csrc" / "assembly.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", SRC).group(1))
TI_MAX = int(re.search(r"constexpr int TI_MAX = (\d+);", SRC).group(1))
TJ = 2 * THREADS  # a tile's columns: one strip of 64 a warp
VARIANTS = [None, 0, 1, 2]
NAMES = {None: None, 0: "consistent", 1: "symmetric", 2: "reference"}

f32 = np.float32
Z = f32(0.0)


class Prm:
    def __init__(self, u, v, p, dx, dy, rho, mu, alpha):
        self.u, self.v, self.p = u, v, p
        self.nx, self.ny = p.shape
        self.cFu, self.cFv = f32(0.5 * rho * dy), f32(0.5 * rho * dx)
        self.De, self.Dn = f32(mu * dy / dx), f32(mu * dx / dy)
        self.dx, self.dy, self.alpha = f32(dx), f32(dy), f32(alpha)
        self.oma, self.rho = f32(1.0 - alpha), f32(rho)

    def U(self, i, j):
        return self.u[i, j]

    def V(self, i, j):
        return self.v[i, j]

    def Pr(self, i, j):
        return self.p[i, j]


def pla(F, D):
    if not (abs(D) > f32(1e-10)):
        return Z
    base = max(f32(1.0) - f32(0.1) * abs(F / D), Z)
    b2 = base * base
    return b2 * b2 * base


def u_coef(P, i, j):
    nx, ny = P.nx, P.ny
    if i <= 0 or i >= nx:
        return (Z,) * 6
    uc = P.U(i, j)
    Fe = P.cFu * (P.U(i + 1, j) + uc)
    Fw = P.cFu * (P.U(i - 1, j) + uc)
    Fn = Z if j == ny - 1 else P.cFv * (P.V(i, j + 1) + P.V(i - 1, j + 1))
    Fs = Z if j == 0 else P.cFv * (P.V(i, j) + P.V(i - 1, j))
    ae = P.De * pla(Fe, P.De) + max(-Fe, Z)
    aw = P.De * pla(Fw, P.De) + max(Fw, Z)
    an = Z if j == ny - 1 else P.Dn * pla(Fn, P.Dn) + max(-Fn, Z)
    as_ = Z if j == 0 else P.Dn * pla(Fs, P.Dn) + max(Fs, Z)
    ap = ae + aw + an + as_ + (Fe - Fw) + (Fn - Fs)
    src = (P.Pr(i - 1, j) - P.Pr(i, j)) * P.dy
    if i == 1:
        src = src + aw * P.U(0, j); aw = Z
    if i == nx - 1:
        src = src + ae * P.U(nx, j); ae = Z
    if j == 1:
        src = src + as_ * P.U(i, 0); as_ = Z
    if j == ny - 2:
        src = src + an * P.U(i, ny - 1); an = Z
    return ae, aw, an, as_, ap, src


def v_coef(P, i, j):
    nx, ny = P.nx, P.ny
    if j <= 0 or j >= ny:
        return (Z,) * 6
    Fe = Z if i == nx - 1 else P.cFu * (P.U(i + 1, j) + P.U(i + 1, j - 1))
    Fw = Z if i == 0 else P.cFu * (P.U(i, j) + P.U(i, j - 1))
    Fn = P.cFv * (P.V(i, j) + P.V(i, j + 1))
    Fs = P.cFv * (P.V(i, j - 1) + P.V(i, j))
    ae = Z if i == nx - 1 else P.De * pla(Fe, P.De) + max(-Fe, Z)
    aw = Z if i == 0 else P.De * pla(Fw, P.De) + max(Fw, Z)
    an = P.Dn * pla(Fn, P.Dn) + max(-Fn, Z)
    as_ = P.Dn * pla(Fs, P.Dn) + max(Fs, Z)
    ap = ae + aw + an + as_ + (Fe - Fw) + (Fn - Fs)
    src = (P.Pr(i, j - 1) - P.Pr(i, j)) * P.dx
    if j == 1:
        src = src + as_ * P.V(i, 0); as_ = Z
    if j == ny - 1:
        src = src + an * P.V(i, ny); an = Z
    if i == 1:
        src = src + aw * P.V(0, j); aw = Z
    if i == nx - 2:
        src = src + ae * P.V(nx - 1, j); ae = Z
    return ae, aw, an, as_, ap, src


def flux_east(P, is_u, i, j):
    if (i < P.nx) if is_u else (i < P.nx - 1 and 1 <= j <= P.ny - 1):
        if is_u:
            F = P.cFu * (P.U(i + 1, j) + P.U(i, j))
        else:
            F = P.cFu * (P.U(i + 1, j) + P.U(i + 1, j - 1))
        return F, P.De * pla(F, P.De)
    return Z, Z


def flux_north(P, is_u, i, j):
    if (1 <= i <= P.nx - 1 and j < P.ny - 1) if is_u else (j <= P.ny - 1):
        if is_u:
            F = P.cFv * (P.V(i, j + 1) + P.V(i - 1, j + 1))
        else:
            F = P.cFv * (P.V(i, j) + P.V(i, j + 1))
        return F, P.Dn * pla(F, P.Dn)
    return Z, Z


def face_flux(P, is_u, i, j):
    return flux_east(P, is_u, i, j) + flux_north(P, is_u, i, j)


def u_coef_flux(P, i, j, o, Fw, DAw, Fs, DAs):
    nx, ny = P.nx, P.ny
    if i <= 0 or i >= nx:
        return (Z,) * 6
    Fe, DAe, Fn, DAn = o
    Fn = Z if j == ny - 1 else Fn
    if j == 0:
        Fs = Z
    ae = DAe + max(-Fe, Z)
    aw = DAw + max(Fw, Z)
    an = Z if j == ny - 1 else DAn + max(-Fn, Z)
    as_ = Z if j == 0 else DAs + max(Fs, Z)
    ap = ae + aw + an + as_ + (Fe - Fw) + (Fn - Fs)
    src = (P.Pr(i - 1, j) - P.Pr(i, j)) * P.dy
    if i == 1:
        src = src + aw * P.U(0, j); aw = Z
    if i == nx - 1:
        src = src + ae * P.U(nx, j); ae = Z
    if j == 1:
        src = src + as_ * P.U(i, 0); as_ = Z
    if j == ny - 2:
        src = src + an * P.U(i, ny - 1); an = Z
    return ae, aw, an, as_, ap, src


def v_coef_flux(P, i, j, o, Fw, DAw, Fs, DAs):
    nx, ny = P.nx, P.ny
    if j <= 0 or j >= ny:
        return (Z,) * 6
    Fe, DAe, Fn, DAn = o
    Fe = Z if i == nx - 1 else Fe
    if i == 0:
        Fw = Z
    ae = Z if i == nx - 1 else DAe + max(-Fe, Z)
    aw = Z if i == 0 else DAw + max(Fw, Z)
    an = DAn + max(-Fn, Z)
    as_ = DAs + max(Fs, Z)
    ap = ae + aw + an + as_ + (Fe - Fw) + (Fn - Fs)
    src = (P.Pr(i, j - 1) - P.Pr(i, j)) * P.dx
    if j == 1:
        src = src + as_ * P.V(i, 0); as_ = Z
    if j == ny - 1:
        src = src + an * P.V(i, ny); an = Z
    if i == 1:
        src = src + aw * P.V(0, j); aw = Z
    if i == nx - 2:
        src = src + ae * P.V(nx - 1, j); ae = Z
    return ae, aw, an, as_, ap, src


def relax_ap(P, ap):
    return (ap if abs(ap) > f32(1e-12) else f32(1e-12)) / P.alpha


def pressure_from_d(P, variant, i, j, du_w, du_e, dv_s, dv_n):
    nx, ny = P.nx, P.ny
    cons = variant == 0
    j_out = cons and (j < 1 or j > ny - 2)
    i_out = cons and (i < 1 or i > nx - 2)
    ae = P.rho * (Z if j_out else du_e) * P.dy if i < nx - 1 else Z
    aw = P.rho * (Z if j_out else du_w) * P.dy if i > 0 else Z
    an = P.rho * (Z if i_out else dv_n) * P.dx if j < ny - 1 else Z
    as_ = P.rho * (Z if i_out else dv_s) * P.dx if j > 0 else Z
    dg = Z
    if variant == 2:
        if i == 0: dg = dg + ae
        if i == nx - 1: dg = dg + aw
        if j == 0: dg = dg + an
        if j == ny - 1: dg = dg + as_
        if i == 0: ae = Z
        if i == nx - 1: aw = Z
        if j == 0: an = Z
        if j == ny - 1: as_ = Z
    return ae, aw, an, as_, dg + ae + aw + an + as_


# ---------------------------------------------------------------------------
# the one-thread-a-face formulas: each face's coefficients from global
# indices, d and the operator from the four faces' full coefficients

def d_face(P, is_u, i, j, consistent):
    if is_u:
        if i < 1 or i > P.nx - 1: return Z
        if consistent and (j < 1 or j > P.ny - 2): return Z
        ap = relax_ap(P, u_coef(P, i, j)[4])
        return P.dy / ap if abs(ap) > f32(1e-12) else Z
    if j < 1 or j > P.ny - 1: return Z
    if consistent and (i < 1 or i > P.nx - 2): return Z
    ap = relax_ap(P, v_coef(P, i, j)[4])
    return P.dx / ap if abs(ap) > f32(1e-12) else Z


def per_face(P, variant):
    nx, ny = P.nx, P.ny
    out = {}
    gm = [Z, Z]
    for is_u, (NI, NJ), name in ((True, (nx + 1, ny), "u"), (False, (nx, ny + 1), "v")):
        arrs = np.zeros((9, NI, NJ), np.float32)
        for i in range(NI):
            for j in range(NJ):
                c = u_coef(P, i, j) if is_u else v_coef(P, i, j)
                apr = relax_ap(P, c[4])
                x = P.U(i, j) if is_u else P.V(i, j)
                arrs[:6, i, j] = c
                arrs[6, i, j] = apr
                arrs[7, i, j] = c[5] + P.oma * apr * x
                row = (1 <= i <= nx - 1) if is_u else (1 <= j <= ny - 1)
                ok = row and abs(apr) > f32(1e-12)
                arrs[8, i, j] = (P.dy if is_u else P.dx) / apr if ok else Z
                if 1 <= i <= NI - 2 and 1 <= j <= NJ - 2:
                    safe = f32(1) if apr == 0 else apr
                    r = (abs(c[0]) + abs(c[1]) + abs(c[2]) + abs(c[3])) / safe
                    gm[0 if is_u else 1] = max(gm[0 if is_u else 1], r)
        out[name] = arrs
    if variant is not None:
        pc = np.zeros((5, nx, ny), np.float32)
        cons = variant == 0
        for i in range(nx):
            for j in range(ny):
                ae = P.rho * d_face(P, True, i + 1, j, cons) * P.dy if i < nx - 1 else Z
                aw = P.rho * d_face(P, True, i, j, cons) * P.dy if i > 0 else Z
                an = P.rho * d_face(P, False, i, j + 1, cons) * P.dx if j < ny - 1 else Z
                as_ = P.rho * d_face(P, False, i, j, cons) * P.dx if j > 0 else Z
                dg = Z
                if variant == 2:
                    if i == 0: dg = dg + ae
                    if i == nx - 1: dg = dg + aw
                    if j == 0: dg = dg + an
                    if j == ny - 1: dg = dg + as_
                    if i == 0: ae = Z
                    if i == nx - 1: aw = Z
                    if j == 0: an = Z
                    if j == ny - 1: as_ = Z
                pc[:, i, j] = (ae, aw, an, as_, dg + ae + aw + an + as_)
        out["pc"] = pc
    out["gmax"] = np.array(gm, np.float32)
    return out


# ---------------------------------------------------------------------------
# csrc/assembly.cu's walk: tiles of warp strips, the halos before the walk,
# the carries and shuffles of the row loop

def walk(P, variant, ti, tj):
    """csrc/assembly.cu's two launches: the strips' coefficients and d,
    then the operator from the d they wrote."""
    nx, ny = P.nx, P.ny
    fold = variant is not None
    out = {"u": np.full((9, nx + 1, ny), np.nan, np.float32),
           "v": np.full((9, nx, ny + 1), np.nan, np.float32),
           "pc": np.full((5, nx, ny), np.nan, np.float32)}
    writes = {k: np.zeros(a.shape[1:], int) for k, a in out.items()}
    gm = [Z, Z]
    def assemble(is_u, i, j, o, west, south):
        c = u_coef_flux(P, i, j, o, west[0], west[1], south[0], south[1]) if is_u else \
            v_coef_flux(P, i, j, o, west[0], west[1], south[0], south[1])
        apr = relax_ap(P, c[4])
        name = "u" if is_u else "v"
        x = P.U(i, j) if is_u else P.V(i, j)
        row = (1 <= i <= nx - 1) if is_u else (1 <= j <= ny - 1)
        d = (P.dy if is_u else P.dx) / apr if (row and abs(apr) > f32(1e-12)) else Z
        assert writes[name][i, j] == 0, (name, i, j)
        writes[name][i, j] += 1
        out[name][:9, i, j] = list(c) + [apr, c[5] + P.oma * apr * x, d]
        NI, NJ = (nx + 1, ny) if is_u else (nx, ny + 1)
        if 1 <= i <= NI - 2 and 1 <= j <= NJ - 2:
            safe = f32(1) if apr == 0 else apr
            r = (abs(c[0]) + abs(c[1]) + abs(c[2]) + abs(c[3])) / safe
            gm[0 if is_u else 1] = max(gm[0 if is_u else 1], r)

    def south_of(o, halo, k):  # lane l - 1's north terms, lane 0's from lane k's halo
        return [(o[l - 1][2], o[l - 1][3]) if l > 0 else halo[k] for l in L]

    L = range(32)
    sw = 2 * 32  # a strip's columns: two a lane
    lean_on = ny % sw == 0

    def lean_of(i):
        return i & (sw - 1) if lean_on else 0

    def pair(is_u, i, cols, o, west, south):
        for e in (0, 1):
            if cols[e] is not None:
                assemble(is_u, i, cols[e], o[e], west[e], south[e])

    strips = ny // sw + 1
    tiles_j = -(-strips // (tj // sw))
    tiles = tiles_j * -(-nx // ti)
    zero4 = (Z,) * 4
    for tile in range(tiles):
        row = tile // tiles_j
        for warp in range(tj // sw):
            i0, j0 = row * ti, (tile - row * tiles_j) * tj + sw * warp
            rows = min(ti, nx - i0)
            steps = rows + (i0 + rows == nx)
            hu, hv, hw = [(Z, Z)] * 32, [(Z, Z)] * 32, [(Z, Z)] * 32
            for k in L:
                if k < steps:
                    i, c = i0 + k, j0 - lean_of(i0 + k)
                    if j0 > 0:
                        hu[k] = flux_north(P, True, i, j0 - 1)
                    if k < rows:
                        if c > 0:
                            hv[k] = flux_north(P, False, i, c - 1)
                        if i > 0 and c >= 0:
                            hw[k] = flux_east(P, False, i - 1, c)
            wu = [[(Z, Z), (Z, Z)] for _ in L]
            wv = [[(Z, Z), (Z, Z)] for _ in L]
            lean_prev = 0
            for k in range(steps):
                i = i0 + k
                cols = [[j0 + 2 * l + e if j0 + 2 * l + e < ny else None for e in (0, 1)]
                        for l in L]
                o = [[face_flux(P, True, i, c) if c is not None else zero4 for c in cl]
                     for cl in cols]
                if k == 0 and i > 0:
                    wu = [[flux_east(P, True, i - 1, c) if c is not None else wu[l][e]
                           for e, c in enumerate(cols[l])] for l in L]
                south = [[(o[l - 1][1][2], o[l - 1][1][3]) if l > 0 else hu[k],
                          (o[l][0][2], o[l][0][3])] for l in L]
                for l in L:
                    pair(True, i, cols[l], o[l], wu[l], south[l])
                wu = [[(x[0], x[1]) for x in ol] for ol in o]
                if k < rows:
                    lean = lean_of(i)
                    cols = [[c if 0 <= c <= ny else None
                             for c in (j0 - lean + 2 * l, j0 - lean + 2 * l + 1)] for l in L]
                    o = [[face_flux(P, False, i, c) if c is not None else zero4 for c in cl]
                         for cl in cols]
                    if k > 0 and lean == lean_prev + 1:
                        west = [[wv[l - 1][1] if l > 0 else hw[k], wv[l][0]] for l in L]
                    elif k == 0 or lean != lean_prev:
                        west = [[flux_east(P, False, i - 1, c) if c is not None and i > 0
                                 else (Z, Z) for c in cl] for cl in cols]
                    else:
                        west = wv
                    south = [[(o[l - 1][1][2], o[l - 1][1][3]) if l > 0 else hv[k],
                              (o[l][0][2], o[l][0][3])] for l in L]
                    for l in L:
                        pair(False, i, cols[l], o[l], west[l], south[l])
                    wv = [[(x[0], x[1]) for x in ol] for ol in o]
                    lean_prev = lean
    if fold:  # the second launch: the operator from the d written above
        for i in range(nx):
            for j in range(ny):
                out["pc"][:, i, j] = pressure_from_d(P, variant, i, j, out["u"][8, i, j],
                                                     out["u"][8, i + 1, j], out["v"][8, i, j],
                                                     out["v"][8, i, j + 1])
                writes["pc"][i, j] += 1
    out["gmax"] = np.array(gm, np.float32)
    if not fold:
        out["u"], out["v"] = out["u"][:8], out["v"][:8]
        del out["pc"], writes["pc"]
    return out, writes


def _fields(nx, ny, seed):
    """A noisy BC-applied cavity state (the JAX package's BCs), float32."""
    mesh, bc = nf.StructuredMesh(nx=nx, ny=ny), nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
    u, v = apply_velocity_bcs(u, v, bc)
    p = rng.normal(size=(nx, ny)).astype(np.float32)
    kw = dict(dx=1.0 / (nx - 1), dy=1.0 / (ny - 1), rho=1.0, mu=0.01, alpha=0.7)
    return np.array(u), np.array(v), p, kw


def _model(nx, ny, seed, variant, ti, tj):
    u, v, p, kw = _fields(nx, ny, seed)
    P = Prm(u, v, p, **kw)
    return P, walk(P, variant, ti, tj), (u, v, p, kw)


# (nx, ny, ti, tile columns): partial last strips (ny % 64 != 0, odd and
# even), leaning v strips (ny % 64 == 0) whose lean starts over inside a
# tile (i = 64), partial last tiles (nx % ti != 0), one strip, the row cap
CASES = [(40, 33, 7, 128), (37, 64, 5, 128), (33, 31, TI_MAX, 64), (20, 96, 4, TJ),
         (12, 64, 12, 64), (50, 70, 8, 128), (80, 64, 24, 64), (70, 128, TI_MAX, 128)]


@pytest.mark.parametrize("variant", VARIANTS, ids=[str(NAMES[v]) for v in VARIANTS])
@pytest.mark.parametrize("case", CASES, ids=["x".join(map(str, c)) for c in CASES])
def test_walk_writes_each_output_once_bit_equal_to_per_face(case, variant):
    nx, ny, ti, tj = case
    P, (out, writes), _ = _model(nx, ny, 3 + nx, variant, ti, tj)
    for name, w in writes.items():
        assert (w == 1).all(), (name, np.argwhere(w != 1)[:5])
    want = per_face(P, variant)
    for name, a in want.items():
        b = out[name]
        if name in ("u", "v") and variant is None:
            a = a[:8]
        assert a.shape == b.shape, name
        bad = np.argwhere(a.view(np.int32) != b.view(np.int32))
        assert bad.size == 0, (name, bad[:5])


@pytest.mark.parametrize("variant", VARIANTS, ids=[str(NAMES[v]) for v in VARIANTS])
def test_walk_matches_plain_version(variant):
    """The model against ``fused_assembly_pair_plain`` at 48 x 40 (the
    port's CPU path): coefficients rtol / atol 1e-5, maxima rtol 1e-6, d and
    the operator rtol 1e-6 / atol 1e-9 (chip_smoke's check_assembly)."""
    _, (out, _), (u, v, p, kw) = _model(48, 40, 17, variant, 6, 64)
    got = assembly._flat(assembly.fused_assembly_pair_plain(
        *(torch.as_tensor(x) for x in (u, v, p)), with_bounds=True,
        poisson_variant=NAMES[variant], **kw), True, NAMES[variant])
    _check(got, out, variant)


def test_walk_matches_pallas_kernel():
    """The model with the maxima and the consistent fold against the JAX
    package's Pallas kernel in interpret mode at 64^2, at the same
    tolerances."""
    _, (out, _), (u, v, p, kw) = _model(64, 64, 29, 0, 9, 64)
    want = j_assembly(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), interpret=True,
                      with_bounds=True, poisson_variant="consistent", **kw)
    cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, d_u, d_v, pc = want
    fields = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")
    flat = [getattr(cu_un, f) for f in fields] + [cu_rel.a_p, cu_rel.src]
    flat += [getattr(cv_un, f) for f in fields] + [cv_rel.a_p, cv_rel.src]
    flat += [rho_u, rho_v, d_u, d_v, pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag]
    _check([torch.as_tensor(np.asarray(x)) for x in flat], out, 0)


def _check(got, out, variant):
    model = list(out["u"][:8]) + list(out["v"][:8]) + list(out["gmax"])
    if variant is not None:
        model += [out["u"][8], out["v"][8]] + list(out["pc"])
    assert len(got) == len(model)
    for k, (g, m) in enumerate(zip(got, model)):
        g = g.numpy()
        if k < 16:
            np.testing.assert_allclose(m, g, rtol=1e-5, atol=1e-5, err_msg=str(k))
        elif k < 18:
            np.testing.assert_allclose(m, g, rtol=1e-6, err_msg=str(k))
        else:
            np.testing.assert_allclose(m, g, rtol=1e-6, atol=1e-9, err_msg=str(k))


def test_tile_row_cap_fits_the_halo_lanes():
    """The terms lane 0 lacks are one row a lane (lane 0 reads row k's from
    lane k, k <= ti with u row nx), so a tile has at most 31 rows; the
    model's cases reach it."""
    assert TI_MAX == 31 and THREADS % 32 == 0
    assert "constexpr int CPL = 2;" in SRC and "constexpr int SW = 32 * CPL;" in SRC
    assert "constexpr int TJ = SW * WARPS;" in SRC and "constexpr int WARPS = THREADS / 32;" in SRC
    assert "const int j_warp = SW * (threadIdx.x >> 5);" in SRC
    assert "j0 = (tile - row * P.tiles_j) * TJ + j_warp;" in SRC
    assert "P.tiles_j = (P.ny / SW + 1 + WARPS - 1) / WARPS;" in SRC
    assert any(c[2] == TI_MAX for c in CASES)
    assert "const int rows = min(P.ti, nx - i0);" in SRC
    assert "const int steps = rows + (i0 + rows == nx);" in SRC
    assert "return P.lean ? i & (SW - 1) : 0;" in SRC
    assert "P.lean = P.ny % SW == 0;" in SRC
