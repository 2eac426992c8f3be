"""The port's window-form assembly (``ops/windowed.py``) and window velocity
BCs on the CPU (f64): each window form against the JAX package's on the
same seeded numpy inputs, and against the port's own global assembly, on
the full window and on sub-blocks at offsets (8, 0), (0, 8), (8, 8) of
square and non-square grids (rtol 1e-13, atol 1e-15, the JAX package's own
tolerance for its window forms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.core import bc as jbc
from naviflow_tpu.ops import poisson as jpo
from naviflow_tpu.ops import windowed as jw

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.core.bc import apply_velocity_bcs, apply_velocity_bcs_window
from naviflow_tpu_torch.ops import highorder as tho
from naviflow_tpu_torch.ops import poisson as tpo
from naviflow_tpu_torch.ops import powerlaw as tpl
from naviflow_tpu_torch.ops import windowed as tw

C5 = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")
C9 = ("a_e", "a_w", "a_n", "a_s", "a_ee", "a_ww", "a_nn", "a_ss", "a_p", "src")
TOL = dict(rtol=1e-13, atol=1e-15)
# (nx, ny, nxl, nyl, gi0, gj0): full windows, then sub-blocks
WINDOWS = [(16, 16, 16, 16, 0, 0), (16, 12, 16, 12, 0, 0),
           (16, 16, 8, 8, 8, 0), (16, 16, 8, 8, 0, 8), (16, 16, 8, 8, 8, 8),
           (16, 12, 8, 6, 8, 6)]
NINE = [("quick",) + w for w in WINDOWS] + [("luds",) + w for w in (WINDOWS[1], WINDOWS[4])]


def _fields(nx, ny, seed=11, lid=1.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(nx + 1, ny))
    v = rng.normal(size=(nx, ny + 1))
    u[0, :] = u[nx, :] = 0.0
    u[:, 0] = 0.0
    u[:, ny - 1] = lid
    v[0, :] = v[nx - 1, :] = 0.0
    v[:, 0] = v[:, ny] = 0.0
    p = rng.normal(size=(nx, ny))
    return u, v, p


def _T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _exts(u, v, p, nxl, nyl, gi0, gj0, ring):
    """The ``ring``-ring halo-extended blocks of (u, v, p), zeros outside
    the domain (what ``parallel/decompose.extend_*`` give a rank)."""
    up, vp, pp = (np.pad(a, ring) for a in (u, v, p))
    return (up[gi0: gi0 + nxl + 1 + 2 * ring, gj0: gj0 + nyl + 2 * ring],
            vp[gi0: gi0 + nxl + 2 * ring, gj0: gj0 + nyl + 1 + 2 * ring],
            pp[gi0: gi0 + nxl + 2 * ring, gj0: gj0 + nyl + 2 * ring])


def _check(w_t, w_j, g_t, names, rows, cols, what):
    for name in names:
        got = getattr(w_t, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(w_j, name)), **TOL,
                                   err_msg=f"{what} {name} vs JAX")
        np.testing.assert_allclose(got, getattr(g_t, name).numpy()[rows, cols], **TOL,
                                   err_msg=f"{what} {name} vs the port's global assembly")


@pytest.mark.parametrize("nx,ny,nxl,nyl,gi0,gj0", WINDOWS)
def test_power_law_windows(nx, ny, nxl, nyl, gi0, gj0):
    u, v, p = _fields(nx, ny)
    kw = dict(dx=1.0 / (nx - 1), dy=1.0 / (ny - 1), rho=1.0, mu=0.01)
    ext = _exts(u, v, p, nxl, nyl, gi0, gj0, 1)
    win = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny, **kw)
    gt = [_T(a) for a in (u, v, p)]
    for what, tfn, jfn, gfn, rows, cols in (
            ("u", tw.u_coefficients_window, jw.u_coefficients_window,
             tpl.u_momentum_coefficients, slice(gi0, gi0 + nxl + 1), slice(gj0, gj0 + nyl)),
            ("v", tw.v_coefficients_window, jw.v_coefficients_window,
             tpl.v_momentum_coefficients, slice(gi0, gi0 + nxl), slice(gj0, gj0 + nyl + 1))):
        _check(tfn(*(_T(a) for a in ext), **win), jfn(*(jnp.asarray(a) for a in ext), **win),
               gfn(*gt, **kw), C5, rows, cols, what)


@pytest.mark.parametrize("scheme,nx,ny,nxl,nyl,gi0,gj0", NINE)
def test_nine_point_windows(scheme, nx, ny, nxl, nyl, gi0, gj0):
    u, v, p = _fields(nx, ny, seed=21)
    kw = dict(dx=1.0 / (nx - 1), dy=1.0 / (ny - 1), rho=1.0, mu=0.01)
    ext = _exts(u, v, p, nxl, nyl, gi0, gj0, 2)
    win = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny, scheme=scheme, **kw)
    gt = [_T(a) for a in (u, v, p)]
    for what, tfn, jfn, gfn, rows, cols in (
            ("u", tw.u_coefficients9_window, jw.u_coefficients9_window,
             tho.u_momentum_coefficients9, slice(gi0, gi0 + nxl + 1), slice(gj0, gj0 + nyl)),
            ("v", tw.v_coefficients9_window, jw.v_coefficients9_window,
             tho.v_momentum_coefficients9, slice(gi0, gi0 + nxl), slice(gj0, gj0 + nyl + 1))):
        _check(tfn(*(_T(a) for a in ext), **win), jfn(*(jnp.asarray(a) for a in ext), **win),
               gfn(*gt, scheme=scheme, **kw), C9, rows, cols, what)


@pytest.mark.parametrize("variant", ["reference", "symmetric", "consistent"])
@pytest.mark.parametrize("nx,ny,nxl,nyl,gi0,gj0", WINDOWS)
def test_poisson_windows(variant, nx, ny, nxl, nyl, gi0, gj0):
    rng = np.random.default_rng(5)
    d_u = rng.uniform(0.5, 1.5, (nx + 1, ny))
    d_v = rng.uniform(0.5, 1.5, (nx, ny + 1))
    kw = dict(dx=1.0 / nx, dy=1.0 / ny, rho=1.0, variant=variant)
    du_loc = d_u[gi0: gi0 + nxl + 1, gj0: gj0 + nyl]
    dv_loc = d_v[gi0: gi0 + nxl, gj0: gj0 + nyl + 1]
    win = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny, **kw)
    w_t = tw.poisson_coefficients_window(_T(du_loc), _T(dv_loc), **win)
    w_j = jw.poisson_coefficients_window(jnp.asarray(du_loc), jnp.asarray(dv_loc), **win)
    g_t = tpo.poisson_coefficients(_T(d_u), _T(d_v), **kw)
    g_j = jpo.poisson_coefficients(jnp.asarray(d_u), jnp.asarray(d_v), **kw)
    rows, cols = slice(gi0, gi0 + nxl), slice(gj0, gj0 + nyl)
    _check(w_t, w_j, g_t, ("a_e", "a_w", "a_n", "a_s", "diag"), rows, cols, "poisson")
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):  # the global forms agree too
        np.testing.assert_allclose(getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)),
                                   **TOL)


def _bcs():
    vel = nt.BoundaryType.VELOCITY
    return [nt.lid_driven_cavity(1.0),
            nt.BoundaryConditions().with_condition("left", vel, {"u": 0.5, "v": -0.25})
            .with_condition("bottom", vel, {"u": -1.0, "v": 0.75})
            .with_condition("right", vel, {"v": 2.0})]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("nx,ny,nxl,nyl,gi0,gj0", WINDOWS)
def test_velocity_bcs_window(which, nx, ny, nxl, nyl, gi0, gj0):
    """The window BCs of a block equal the block of the global BCs, and the
    JAX package's window BCs."""
    bc = _bcs()[which]
    jb = jbc.BoundaryConditions()
    for side in ("top", "bottom", "left", "right"):
        s = bc.side(side)
        jb = jb.with_condition(side, s.kind.value, {"u": s.u, "v": s.v})
    assert interop.boundary_conditions(jb) == bc
    rng = np.random.default_rng(3)
    u, v = rng.normal(size=(nx + 1, ny)), rng.normal(size=(nx, ny + 1))
    u_loc = u[gi0: gi0 + nxl + 1, gj0: gj0 + nyl]
    v_loc = v[gi0: gi0 + nxl, gj0: gj0 + nyl + 1]
    win = dict(gi0=gi0, gj0=gj0, nx=nx, ny=ny)
    ut, vt = apply_velocity_bcs_window(_T(u_loc), _T(v_loc), bc, **win)
    uj, vj = jbc.apply_velocity_bcs_window(jnp.asarray(u_loc), jnp.asarray(v_loc), jb, **win)
    ug, vg = apply_velocity_bcs(_T(u), _T(v), bc)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ut.numpy(), ug.numpy()[gi0: gi0 + nxl + 1, gj0: gj0 + nyl])
    np.testing.assert_array_equal(vt.numpy(), vg.numpy()[gi0: gi0 + nxl, gj0: gj0 + nyl + 1])
