"""The PyTorch port's composed operators against the JAX package's, in
float64 on the CPU: the same numpy inputs through both, held to a relative
1e-12 of each output's scale (the two evaluate the same expressions in the
same order; only libm and summation-kernel details may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.core import bc as jbc
from naviflow_tpu.ops import poisson as jpo
from naviflow_tpu.ops import powerlaw as jpl
from naviflow_tpu.ops import stencil9 as js9
from naviflow_tpu.ops import transfer_cc as jtc
from naviflow_tpu.solvers import velocity as jvel

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.core import bc as tbc
from naviflow_tpu_torch.ops import poisson as tpo
from naviflow_tpu_torch.ops import powerlaw as tpl
from naviflow_tpu_torch.ops import stencil9 as ts9
from naviflow_tpu_torch.ops import transfer_cc as ttc
from naviflow_tpu_torch.solvers import velocity as tvel

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-12
NX, NY = 24, 20
KW = dict(dx=1.0 / (NX - 1), dy=1.0 / (NY - 1), rho=1.0, mu=0.01)


def close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) + 1e-300
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, err


def T(x):
    return interop.tensor(x, dtype=torch.float64)


def fields(seed=11, nx=NX, ny=NY):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(nx + 1, ny))
    v = rng.normal(size=(nx, ny + 1))
    p = rng.normal(size=(nx, ny))
    return u, v, p


@pytest.mark.parametrize("lid", [1.0, -0.5])
def test_velocity_bcs_and_initial_state(lid):
    u, v, _ = fields()
    jb = nf.lid_driven_cavity(lid)
    tb = interop.boundary_conditions(jb)
    ju, jv = jbc.apply_velocity_bcs(jnp.asarray(u), jnp.asarray(v), jb)
    tu, tv = tbc.apply_velocity_bcs(T(u), T(v), tb)
    close(tu, ju)
    close(tv, jv)
    mesh = nf.StructuredMesh(nx=NX, ny=NY)
    js = interop.flow_state(nf.initialize_state(mesh, jb, dtype=jnp.float64))
    ts = nt.initialize_state(interop.mesh(mesh), tb, dtype=torch.float64, device="cpu")
    for name in ("u", "v", "p"):
        close(getattr(ts, name), getattr(js, name))


def test_enforce_pressure_bcs():
    _, _, p = fields()
    bc = nf.lid_driven_cavity(1.0)
    close(tbc.enforce_pressure_bcs(T(p), interop.boundary_conditions(bc)),
          jbc.enforce_pressure_bcs(jnp.asarray(p), bc))


@pytest.mark.parametrize("is_u", [True, False])
def test_momentum_coefficients_relax_and_d(is_u):
    u, v, p = fields()
    jfn = jpl.u_momentum_coefficients if is_u else jpl.v_momentum_coefficients
    tfn = tpl.u_momentum_coefficients if is_u else tpl.v_momentum_coefficients
    jc = jfn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), **KW)
    tc = tfn(T(u), T(v), T(p), **KW)
    want = interop.stencil_coeffs(jc)
    for name in ("a_e", "a_w", "a_n", "a_s", "a_p", "src"):
        close(getattr(tc, name), getattr(want, name))
    field = u if is_u else v
    jr = jpl.relax_coefficients(jc, jnp.asarray(field), 0.7)
    tr = tpl.relax_coefficients(tc, T(field), 0.7)
    close(tr.a_p, jr.a_p)
    close(tr.src, jr.src)
    spacing = KW["dy"] if is_u else KW["dx"]
    close(tpl.d_coefficient(tr.a_p, spacing, is_u=is_u),
          jpl.d_coefficient(jr.a_p, spacing, is_u=is_u))


@pytest.mark.parametrize("variant", ["reference", "symmetric", "consistent"])
def test_poisson_coefficients(variant):
    rng = np.random.default_rng(2)
    d_u = rng.uniform(0.5, 1.5, (NX + 1, NY))
    d_v = rng.uniform(0.5, 1.5, (NX, NY + 1))
    kw = dict(dx=KW["dx"], dy=KW["dy"], rho=1.3)
    jc = jpo.poisson_coefficients(jnp.asarray(d_u), jnp.asarray(d_v), variant=variant, **kw)
    tc = tpo.poisson_coefficients(T(d_u), T(d_v), variant=variant, **kw)
    want = interop.poisson_coeffs(jc)
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
        close(getattr(tc, name), getattr(want, name))


@pytest.mark.parametrize("pin", [True, False])
def test_pressure_rhs_and_divergence(pin):
    u, v, _ = fields(5)
    kw = dict(dx=KW["dx"], dy=KW["dy"])
    close(tpo.pressure_rhs(T(u), T(v), rho=1.0, pin=pin, **kw),
          jpo.pressure_rhs(jnp.asarray(u), jnp.asarray(v), rho=1.0, pin=pin, **kw))
    close(tpo.max_interior_divergence(T(u), T(v), **kw),
          jpo.max_interior_divergence(jnp.asarray(u), jnp.asarray(v), **kw))


def test_update_velocity():
    u, v, p = fields(6)
    rng = np.random.default_rng(6)
    d_u = rng.uniform(size=u.shape)
    d_v = rng.uniform(size=v.shape)
    bc = nf.lid_driven_cavity(1.0)
    ju, jv = jvel.update_velocity(*(jnp.asarray(a) for a in (u, v, p, d_u, d_v)), bc)
    tu, tv = tvel.update_velocity(*(T(a) for a in (u, v, p, d_u, d_v)),
                                  interop.boundary_conditions(bc))
    close(tu, ju)
    close(tv, jv)


def _fine_stencil(n, seed=3):
    rng = np.random.default_rng(seed)
    d_u = rng.uniform(0.5, 1.5, (n + 1, n))
    d_v = rng.uniform(0.5, 1.5, (n, n + 1))
    return js9.from_poisson(jpo.poisson_coefficients(
        jnp.asarray(d_u), jnp.asarray(d_v), dx=1.0 / n, dy=1.0 / n, rho=1.0,
        variant="consistent"))


@pytest.mark.parametrize("nine", [False, True])
def test_apply5_apply9(nine):
    n = 32
    jst = _fine_stencil(n)
    rng = np.random.default_rng(4)
    if nine:  # any signed 9-point stencil
        jst = js9.Stencil9(*(jnp.asarray(rng.normal(size=(n, n))) for _ in range(9)))
    x = rng.normal(size=(n, n))
    tst = interop.stencil9(jst, dtype=torch.float64)
    close(ts9.apply9(T(x), tst), js9.apply9(jnp.asarray(x), jst))
    if not nine:
        close(ts9.apply5(T(x), tst), js9.apply5(jnp.asarray(x), jst))


def test_galerkin_coarsen_cell_centred_64_to_32():
    jst = _fine_stencil(64)
    jc = js9.galerkin_coarsen(jst, jtc.restrict_cc, jtc.prolong_cc, 32, 32)
    tc = ts9.galerkin_coarsen(interop.stencil9(jst, dtype=torch.float64),
                              ttc.restrict_cc, ttc.prolong_cc, 32, 32)
    for name in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw"):
        close(getattr(tc, name), getattr(jc, name))


@pytest.mark.parametrize("shape", [(16, 16), (32, 20)])
def test_restrict_and_prolong_cc(shape):
    x = np.random.default_rng(9).normal(size=shape)
    close(ttc.restrict_cc(T(x)), jtc.restrict_cc(jnp.asarray(x)))
    close(ttc.prolong_cc(T(x)), jtc.prolong_cc(jnp.asarray(x)))


def test_gs4_and_rb2_sweeps():
    from naviflow_tpu.solvers.multigrid import _rb2_sweep as j_rb2
    from naviflow_tpu_torch.solvers.multigrid import _rb2_sweep as t_rb2

    n = 32
    rng = np.random.default_rng(8)
    p, b = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    jst = _fine_stencil(n)
    tst = interop.stencil9(jst, dtype=torch.float64)
    close(t_rb2(T(p), T(b), tst, 1.0), j_rb2(jnp.asarray(p), jnp.asarray(b), jst, 1.0))
    jst9 = js9.galerkin_coarsen(_fine_stencil(2 * n), jtc.restrict_cc, jtc.prolong_cc, n, n)
    tst9 = interop.stencil9(jst9, dtype=torch.float64)
    close(ts9.gs4_sweep(T(p), T(b), tst9, 1.0),
          js9.gs4_sweep(jnp.asarray(p), jnp.asarray(b), jst9, 1.0))


def test_lagged_coarse_rebuild_and_carry():
    """The lagged multigrid's coarse hierarchy (algorithms/lagged.py) from
    the same d-fields at 32^2, and its placeholder carry, carried across by
    interop.coarse_tuple."""
    from naviflow_tpu.algorithms.lagged import make_lagged_mg as j_lagged
    from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

    from naviflow_tpu_torch.algorithms.lagged import make_lagged_mg as t_lagged

    n = 32
    rng = np.random.default_rng(12)
    d_u = rng.uniform(0.5, 1.5, (n + 1, n))
    d_v = rng.uniform(0.5, 1.5, (n, n + 1))
    cfg = JMG(coarse_rebuild_every=8)
    kw = dict(dx=1.0 / n, dy=1.0 / n, rho=1.0, variant="consistent")
    jl = j_lagged(cfg, **kw)
    tl = t_lagged(interop.config(cfg), **kw)
    want = interop.coarse_tuple(jl.rebuild(jnp.asarray(d_u), jnp.asarray(d_v)))
    got = tl.rebuild(T(d_u), T(d_v))
    assert len(got) == len(want) == 3  # 16, 8, 4
    for g, w in zip(got, want):
        for name in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw"):
            close(getattr(g, name), getattr(w, name))
    age, coarse = interop.coarse_tuple(jl.extra0(jnp.float64, n, n))
    t_age, t_coarse = tl.extra0(torch.float64, n, n)
    assert age == t_age == 0
    for g, w in zip(t_coarse, coarse):
        close(g.c, w.c)
