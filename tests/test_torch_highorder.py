"""The port's 9-point QUICK / LUDS / upwind momentum (``ops/highorder.py``
and the 9-point path of ``solvers/momentum.py``) against the JAX package on
the CPU (f64, the same seeded numpy inputs): the coefficient assembly of
each scheme and field, the stencil applies and the relaxation, each inner
solve kind with the plain and the compensated residual, a 64^2 QUICK SIMPLE
run for 20 steps, a LUDS cavity to convergence, and the kernel gates,
which refuse every 9-point system as the JAX package's do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.ops import highorder as jh
from naviflow_tpu.solvers import momentum as jm
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve
from naviflow_tpu_torch.ops import _cuda, asmcheby, assembly, cheby, krylov, mg, step, strip
from naviflow_tpu_torch.ops import highorder as th
from naviflow_tpu_torch.solvers import momentum as tm

torch.set_num_threads(2)

C9 = ("a_e", "a_w", "a_n", "a_s", "a_ee", "a_ww", "a_nn", "a_ss", "a_p", "src")
TOL = dict(rtol=1e-13, atol=1e-15)


def _fields(nx, ny, seed=7):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(nx + 1, ny))
    v = rng.normal(size=(nx, ny + 1))
    u[0, :] = u[nx, :] = 0.0
    u[:, 0] = 0.0
    u[:, ny - 1] = 1.0
    v[0, :] = v[nx - 1, :] = 0.0
    v[:, 0] = v[:, ny] = 0.0
    p = rng.normal(size=(nx, ny))
    return u, v, p


def _T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.mark.parametrize("scheme", ["quick", "luds", "upwind"])
@pytest.mark.parametrize("field", ["u", "v"])
def test_coefficients9_match_jax(scheme, field):
    nx, ny = 14, 11
    u, v, p = _fields(nx, ny)
    kw = dict(dx=1.0 / nx, dy=1.0 / ny, rho=1.0, mu=0.01, scheme=scheme)
    tfn = th.u_momentum_coefficients9 if field == "u" else th.v_momentum_coefficients9
    jfn = jh.u_momentum_coefficients9 if field == "u" else jh.v_momentum_coefficients9
    ct = tfn(_T(u), _T(v), _T(p), **kw)
    cj = jfn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), **kw)
    for name in C9:
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   **TOL, err_msg=name)
    ci = interop.momentum_coeffs9(cj, dtype=torch.float64)
    assert all(torch.equal(getattr(ci, name), _T(getattr(cj, name))) for name in C9)
    # the applies and the relaxation on the same coefficients
    x = np.random.default_rng(9).normal(size=u.shape if field == "u" else v.shape)
    np.testing.assert_allclose(th.apply_momentum9(_T(x), ct).numpy(),
                               np.asarray(jh.apply_momentum9(jnp.asarray(x), cj)), **TOL)
    np.testing.assert_allclose(th.neighbor_sum9(_T(x), ct).numpy(),
                               np.asarray(jh.neighbor_sum9(jnp.asarray(x), cj)), **TOL)
    rt = th.relax_coefficients9(ct, _T(x), 0.7)
    rj = jh.relax_coefficients9(cj, jnp.asarray(x), 0.7)
    for name in ("a_p", "src"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   **TOL)


MOMENTUM = {
    "jacobi": nf.solvers.JacobiMomentumConfig(n_sweeps=3, scheme="quick"),
    "jacobi_compensated": nf.solvers.JacobiMomentumConfig(n_sweeps=3, scheme="quick",
                                                          compensated_residual=True),
    "chebyshev": nf.solvers.ChebyshevMomentumConfig(degree=5, scheme="quick"),
    "bicgstab": nf.solvers.KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                                                scheme="quick"),
    "bicgstab_luds": nf.solvers.KrylovMomentumConfig(tolerance=1e-6, max_iterations=30,
                                                     scheme="luds"),
}


@pytest.mark.parametrize("name", list(MOMENTUM))
def test_momentum_solve9_matches_jax(name):
    """Both predictors of one 9-point momentum pair: the star field, d, the
    unrelaxed residual field and its norm (rel 1e-10)."""
    nx, ny = 16, 16
    u, v, p = _fields(nx, ny, seed=4)
    u, v, p = 0.1 * u, 0.1 * v, p
    jcfg = MOMENTUM[name]
    tcfg = interop.config(jcfg)
    jbc, tbc = nf.lid_driven_cavity(1.0), nt.lid_driven_cavity(1.0)
    kw = dict(dx=1.0 / nx, dy=1.0 / ny, rho=1.0, mu=0.01, alpha=0.7)
    jout = jm.solve_momentum_pair(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), bc=jbc,
                                  cfg=jcfg, **kw)
    tout = tm.solve_momentum_pair(_T(u), _T(v), _T(p), bc=tbc, cfg=tcfg, **kw)
    for (jx, jd, jr, jn), (tx, td, tr, tn) in zip(jout, tout):
        assert _rel(tx.numpy(), jx) < 1e-10
        assert _rel(td.numpy(), jd) < 1e-12
        assert _rel(tr.numpy(), jr) < 1e-8
        assert abs(float(tn) - float(jn)) <= 1e-8 * float(jn)


def _cavity(n):
    return (nf.StructuredMesh(nx=n, ny=n), nf.FluidProperties(density=1.0, reynolds_number=100),
            nf.lid_driven_cavity(1.0))


def _both(n, cfg, mom, pres, loop="fused"):
    mesh, fluid, bc = _cavity(n)
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                          cfg, momentum=mom, pressure=pres, loop="fused")
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    ts, td = t_simple_solve(tmesh, interop.fluid(fluid), tbc,
                            nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu"),
                            interop.config(cfg), momentum=interop.config(mom),
                            pressure=interop.config(pres), loop=loop)
    return (js, jd), (ts, td)


def test_quick_simple_64_matches_jax_20_steps():
    """64^2 SIMPLE with QUICK momentum (Jacobi, 2 sweeps) and multigrid
    pressure, 20 steps: every step's residual and the fields at rel 1e-10,
    the V-cycles of every step equal."""
    steps = 20
    (js, jd), (ts, td) = _both(
        64, SIMPLEConfig(max_iterations=steps, tolerance=0.0),
        nf.solvers.JacobiMomentumConfig(n_sweeps=2, scheme="quick"),
        JMG(tolerance=1e-4, max_cycles=20))
    jh_ = np.asarray(jd.total_res_history)[:steps]
    th_ = td.total_res_history.numpy()[:steps]
    assert np.max(np.abs(th_ - jh_) / jh_) < 1e-10
    for k in ("u", "v", "p"):
        assert _rel(getattr(ts, k).numpy(), getattr(js, k)) < 1e-10, k
    np.testing.assert_array_equal(td.inner_iters_history.numpy()[:steps],
                                  np.asarray(jd.inner_iters_history)[:steps])


def test_luds_cavity_converges_like_jax():
    """15^2 LUDS cavity to 1e-4 (the JAX package's LUDS case, Jacobi
    momentum): the same iteration count, converged, the same fields."""
    (js, jd), (ts, td) = _both(
        15, SIMPLEConfig(max_iterations=4000, tolerance=1e-4),
        nf.solvers.JacobiMomentumConfig(n_sweeps=2, scheme="luds"),
        nf.solvers.RBGSPressureConfig(tolerance=1e-7, max_iterations=5000, omega=1.5))
    assert td.converged and bool(jd.converged)
    assert td.iterations == int(jd.iterations)
    for k in ("u", "v", "p"):
        assert _rel(getattr(ts, k).numpy(), getattr(js, k)) < 1e-8, k


def test_kernel_gate_functions_refuse_nine_point():
    """K1, K8, K9 and the batched pair refuse QUICK / LUDS at sizes where they
    admit power-law (the K6 and K7 gates: ``test_kernel_gates_match_jax_rules``
    and the forced path below)."""
    cuda = torch.device("cuda")
    f32 = torch.float32
    for scheme, want in (("power_law", True), ("quick", False), ("luds", False)):
        assert asmcheby.supports_asmcheby(1024, 1024, scheme, f32, "auto", 4, cuda) is want
        assert assembly.supports_fused_assembly(2048, 2048, scheme, f32, "auto", cuda) is want
        cfg = tm.KrylovMomentumConfig(scheme=scheme)
        assert tm._pair_krylov_applicable(cfg, (2049, 2048), (2048, 2049), f32, scheme,
                                          cuda) is want
    c9 = th.MomentumCoeffs9(*([torch.zeros(1, 1)] * 10))
    c5 = tm.StencilCoeffs(*([torch.zeros(1, 1)] * 6))
    ccfg = tm.ChebyshevMomentumConfig(scheme="quick")
    assert tm._cheby_strips_applicable(ccfg, (2048, 2048), f32, c5, cuda)
    assert not tm._cheby_strips_applicable(ccfg, (2048, 2048), f32, c9, cuda)


@pytest.fixture
def gates_forced(monkeypatch):
    """Treat CPU tensors as kernel-capable and count the plain version of
    every kernel each wrapper would launch."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    calls = {}

    def count(module, name, label):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[label] = calls.get(label, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, name, label in (
            (asmcheby, "fused_asmcheby_pair_plain", "K1"), (strip, "strip_down_plain", "K2a"),
            (strip, "strip_up_plain", "K2b"), (mg, "fused_vcycle_plain", "K3"),
            (mg, "galerkin_levels_plain", "K4"), (mg, "fused_mg_solve_plain", "K5"),
            (step, "fused_outer_step_plain", "K6"), (krylov, "bicgstab_momentum_plain", "K7"),
            (assembly, "fused_assembly_pair_plain", "K8"),
            (cheby, "chebyshev_momentum_strips_plain", "K9")):
        count(module, name, label)
    return calls


@pytest.mark.parametrize("scheme", ["power_law", "quick", "luds"])
def test_forced_kernel_path_of_headline(gates_forced, scheme):
    """The 63^2 headline configuration with the gates forced open: power-law
    runs one whole-step kernel (K6) a step; QUICK and LUDS run no K6 and no
    K7 (9-point momentum is composed), the multigrid solve as one K5 a step
    and the lagged carry's coarse hierarchy from K4 at every rebuild."""
    steps = 10
    mesh, fluid, bc = (nt.StructuredMesh(nx=63, ny=63),
                       nt.FluidProperties(density=1.0, reynolds_number=100),
                       nt.lid_driven_cavity(1.0))
    mom = tm.KrylovMomentumConfig(tolerance=1e-6, max_iterations=20, scheme=scheme)
    pres = nt.solvers.MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2,
                                      coarsest_sweeps=8, coarse_rebuild_every=8)
    _, diag = t_simple_solve(mesh, fluid, bc, nt.initialize_state(mesh, bc, device="cpu"),
                             nt.algorithms.SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                             momentum=mom, pressure=pres)
    assert diag.iterations == steps
    if scheme == "power_law":
        assert gates_forced.get("K6") == steps
        return
    refreshes = 1 + -(-steps // 8)  # the setup build, then steps 0, 8, ...
    assert gates_forced == {"K5": steps, "K4": refreshes}, gates_forced
