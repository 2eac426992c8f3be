"""The port's red-black Gauss-Seidel, GMRES and IDR(s) momentum solves
(``solvers/momentum.py``) against the JAX package on the CPU (f64, the
same inputs): each inner solve on one relaxed cavity system of the
power-law and the QUICK scheme (IDR(s) with the JAX package's shadow
space passed in), 20 SIMPLE steps with each kind and scheme step for
step, the default-generator IDR(s) solve to its tolerance, and the
assembly gate (K8), which admits these kinds as the JAX gate does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import momentum as jm
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve
from naviflow_tpu_torch.ops import _cuda
from naviflow_tpu_torch.solvers import momentum as tm

torch.set_num_threads(2)

N = 15
STEPS = 20
KINDS = ("rbgs", "gmres", "idrs")
SCHEMES = ("power_law", "quick")


def _T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _configs(kind, scheme, idrs_outer=20):
    """The JAX config of ``kind`` and the port's (through ``interop``)."""
    if kind == "rbgs":
        cfg = jm.RBGSMomentumConfig(n_sweeps=3, omega=1.1, scheme=scheme)
    elif kind == "gmres":
        cfg = jm.GMRESMomentumConfig(tolerance=1e-8, max_iterations=40, restart=10,
                                     scheme=scheme)
    else:
        # IDR(s) amplifies rounding from its 7th outer iteration on (the
        # two packages' iterates 5e-15 apart after 6, 1.4e-12 after 8 on the
        # power-law system here): held where it stops on its tolerance (6
        # iterations at 1e-6), and in SIMPLE steps at ``idrs_outer``
        cfg = jm.IDRSMomentumConfig(tolerance=1e-6, max_iterations=idrs_outer, s=4,
                                    scheme=scheme)
    return cfg, interop.config(cfg)


def _jax_shadow(s, shape):
    return jax.random.normal(jax.random.PRNGKey(0), (s,) + tuple(shape), jnp.float64)


def _case(re=400.0):
    mesh = nf.StructuredMesh(nx=N, ny=N)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
    bc = nf.lid_driven_cavity(1.0)
    return mesh, fluid, bc


def _warm_state():
    """A cavity state after 8 JAX SIMPLE steps (f64)."""
    mesh, fluid, bc = _case()
    s0 = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    state, _ = simple_solve(mesh, fluid, bc, s0, SIMPLEConfig(max_iterations=8, tolerance=0.0),
                            momentum=jm.KrylovMomentumConfig(tolerance=1e-10,
                                                             max_iterations=100),
                            pressure=JMG(tolerance=1e-8, max_cycles=30), loop="fused")
    return mesh, fluid, bc, state


def _systems(scheme):
    """The relaxed u-momentum system of the warm state in both packages."""
    mesh, fluid, bc, state = _warm_state()
    dx, dy = mesh.get_cell_sizes()
    kw = dict(dx=dx, dy=dy, rho=1.0, mu=fluid.get_viscosity(), scheme=scheme, is_u=True)
    u, v = nf.core.bc.apply_velocity_bcs(state.u, state.v, bc)
    cj = jm._relax(jm._assemble_coeffs(u, v, state.p, **kw), u, 0.7)
    ut, vt, pt = _T(u), _T(v), _T(state.p)
    ct = tm._relax(tm._assemble_coeffs(ut, vt, pt, **kw), ut, 0.7)
    return (u, cj, jm._u_interior_mask(u.shape)), (ut, ct, tm._u_interior_mask(ut.shape))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", KINDS)
def test_inner_solve_matches_jax(kind, scheme):
    (uj, cj, mj), (ut, ct, mt) = _systems(scheme)
    jcfg, _ = _configs(kind, scheme)
    if kind == "rbgs":
        want = jm._rbgs_sweeps(uj, cj, mj, jcfg.n_sweeps, jcfg.omega)
        got = tm._rbgs_sweeps(ut, ct, mt, jcfg.n_sweeps, jcfg.omega)
    elif kind == "gmres":
        want = jm._gmres_masked(uj, cj, mj, jcfg.tolerance, jcfg.max_iterations, jcfg.restart)
        got = tm._gmres_masked(ut, ct, mt, jcfg.tolerance, jcfg.max_iterations, jcfg.restart)
    else:
        want = jm._idrs_masked(uj, cj, mj, jcfg.tolerance, jcfg.max_iterations, jcfg.s,
                               jcfg.angle)
        got = tm._idrs_masked(ut, ct, mt, jcfg.tolerance, jcfg.max_iterations, jcfg.s,
                              jcfg.angle, shadow=_T(_jax_shadow(jcfg.s, uj.shape)))
    assert _rel(got.numpy(), want) <= 1e-12
    # the solve moved the iterate
    assert _rel(got.numpy(), uj) > 1e-6


def test_idrs_default_shadow_space_solves_to_tolerance():
    """With its own generator the port's IDR(s) takes other iterates than
    the JAX package's, and agrees with it to the solve's tolerance; the
    shadow space is the same on every call."""
    (uj, cj, mj), (ut, ct, mt) = _systems("power_law")
    tol = 1e-8
    want = jm._idrs_masked(uj, cj, mj, tol, 40, 4, 0.7)
    got = tm._idrs_masked(ut, ct, mt, tol, 40, 4, 0.7)
    mask_f = mt.to(torch.float64)
    b = ct.src * mask_f
    res = torch.linalg.vector_norm(b - tm._apply(got, ct) * mask_f)
    assert float(res) < tol * float(torch.linalg.vector_norm(b))
    assert 0.0 < _rel(got.numpy(), want) < 1e-6
    torch.testing.assert_close(tm.idrs_shadow_space(4, ut.shape, torch.float64, "cpu"),
                               tm.idrs_shadow_space(4, ut.shape, torch.float64, "cpu"),
                               rtol=0, atol=0)


def _jax_simple(kind, scheme, perturb=0.0):
    mesh, fluid, bc = _case()
    jcfg, _ = _configs(kind, scheme, idrs_outer=4)
    s0 = nf.initialize_state(mesh, bc, dtype=jnp.float64)
    s0 = s0.replace(u=s0.u.at[5, 5].add(perturb))
    return simple_solve(mesh, fluid, bc, s0, SIMPLE_CFG, momentum=jcfg, pressure=SIMPLE_PRES,
                        loop="fused")


SIMPLE_CFG = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0, alpha_p=0.3, alpha_u=0.7)
SIMPLE_PRES = JMG(tolerance=1e-4, max_cycles=20)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", KINDS)
def test_simple_steps_match_jax(kind, scheme, monkeypatch):
    """20 SIMPLE steps with each kind: every step's u / v / p residual and
    pressure iterations, and the final fields, to rel 1e-10.

    IDR(s) (four outer iterations a solve, the JAX package's shadow space)
    is held to ten times the JAX package's own spread instead, where that
    is larger: its SIMPLE run moves by 2e-11 (power-law) and 3.5e-10
    (QUICK) when one u node of the start moves by 1e-17, below rounding
    (7e-6 with 20 outer iterations), where GMRES's moves by 1e-14."""
    mesh, fluid, bc = _case()
    _, tcfg = _configs(kind, scheme, idrs_outer=4)
    sj, dj = _jax_simple(kind, scheme)
    limit = 1e-10
    if kind == "idrs":
        monkeypatch.setattr(tm, "idrs_shadow_space",
                            lambda s, shape, dtype, device: _T(_jax_shadow(s, shape)))
        _, dp = _jax_simple(kind, scheme, perturb=1e-17)
        spread = max(_rel(dp.u_res_history, dj.u_res_history),
                     _rel(dp.v_res_history, dj.v_res_history))
        assert 0.0 < spread < 1e-8
        limit = max(limit, 10.0 * spread)
    m, b = interop.mesh(mesh), interop.boundary_conditions(bc)
    st, dt = t_simple_solve(m, interop.fluid(fluid), b,
                            nt.initialize_state(m, b, dtype=torch.float64, device="cpu"),
                            interop.config(SIMPLE_CFG), momentum=tcfg,
                            pressure=interop.config(SIMPLE_PRES), loop="fused")
    assert dt.iterations == STEPS
    for name in ("u_res_history", "v_res_history", "p_res_history"):
        assert _rel(getattr(dt, name).numpy(), getattr(dj, name)) <= limit, name
    np.testing.assert_array_equal(dt.inner_iters_history.numpy(),
                                  np.asarray(dj.inner_iters_history))
    for name in ("u", "v", "p"):
        assert _rel(getattr(st, name).numpy(), getattr(sj, name)) <= limit, name
    assert bool(torch.all(dt.u_res_history[1:] < dt.u_res_history[0]))


@pytest.mark.parametrize("kind", KINDS)
def test_assembly_gate_admits_every_kind(kind):
    """The K8 gate does not look at the momentum kind (the JAX gate
    ``supports_fused_assembly`` does not either): on a large power-law
    float32 CUDA grid it admits the new kinds, and refuses QUICK."""
    _, tcfg = _configs(kind, "power_law")
    dev = torch.device("cuda")
    assert tm.supports_fused_assembly(1024, 1024, "power_law", torch.float32, tm._backend(tcfg),
                                      dev)
    assert not tm.supports_fused_assembly(1024, 1024, "quick", torch.float32,
                                          tm._backend(tcfg), dev)
    assert not tm.supports_fused_assembly(1024, 1024, "power_law", torch.float32,
                                          tm._backend(tcfg), torch.device("cpu"))
    assert not _cuda.kernel_device(torch.zeros(1))
