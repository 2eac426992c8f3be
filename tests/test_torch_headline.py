"""The 63^2 headline slice of the PyTorch port, at 31^2 on the CPU.

The bench's headline configuration (BiCGSTAB momentum to 1e-6 in at most
20 iterations; multigrid V-cycles to 1e-2, at most 6, checked every 2, 8
coarsest sweeps, coarse operators rebuilt every 8 steps) through the port's
``simple_solve`` against the JAX package's on the same case; the plain
version of the whole-step kernel K6 against the JAX step body it stands
for; the dispatch with the kernel gates forced open (which kernel runs how
often per step, as ``chip_smoke.py`` asserts on the card); the Ghia tables
and error metrics; and ``initialize_state``'s default device.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.algorithms.simple import make_simple_step
from naviflow_tpu.postprocessing import validation as jval
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as port_simple_solve
from naviflow_tpu_torch.ops import _cuda, krylov, mg, step
from naviflow_tpu_torch.postprocessing import validation as tval

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 31
MOM = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
PRES = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="v", check_every=2,
                       coarsest_sweeps=8, coarse_rebuild_every=8)


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _case(n=N):
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    return mesh, fluid, bc


def _port_solve(mesh, fluid, bc, cfg, mom=MOM, pres=PRES):
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    return port_simple_solve(tmesh, interop.fluid(fluid), tbc,
                             nt.initialize_state(tmesh, tbc, device="cpu"),
                             interop.config(cfg), momentum=interop.config(mom),
                             pressure=interop.config(pres))


def test_headline_slice_matches_jax_to_1e3():
    """The headline configuration at 31^2 to 1e-3 in float32: the same
    number of outer iterations (+-1) and u, v, p within 1e-4 of the JAX
    solve's scale (the two differ by summation order only)."""
    mesh, fluid, bc = _case()
    cfg = SIMPLEConfig(max_iterations=500, tolerance=1e-3)
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc), cfg,
                          momentum=MOM, pressure=PRES)
    ts, td = _port_solve(mesh, fluid, bc, cfg)
    assert bool(jd.converged) and td.converged
    assert abs(td.iterations - int(jd.iterations)) <= 1
    for name in ("u", "v", "p"):
        assert rel_err(getattr(ts, name), getattr(js, name)) < 1e-4, name


def test_k6_plain_matches_jax_step_body():
    """K6's plain version (ops/step.fused_simple_step on CPU tensors), three
    chained steps from rest at 31^2, against the JAX make_simple_step body
    with the kernel's own semantics (compensated momentum dots and
    residual, coarse operators rebuilt every step): u, v, p within 2e-4,
    equal multigrid cycle counts (tests/test_pallas.py's K6 tolerances)."""
    mesh, _, bc = _case()
    dx, dy = mesh.get_cell_sizes()
    cfg = SIMPLEConfig()
    mom_k6 = dataclasses.replace(MOM, compensated_dots=True, compensated_residual=True)
    pres_k6 = dataclasses.replace(PRES, coarse_rebuild_every=1)
    jstep = make_simple_step(dx=dx, dy=dy, rho=1.0, mu=0.01, bc=bc, cfg=cfg,
                             mom_cfg=mom_k6, pres_cfg=pres_k6)
    tbc = interop.boundary_conditions(bc)
    s = nf.initialize_state(mesh, bc)
    u, v, p, pm = s.u, s.v, s.p, jnp.asarray(0.0, jnp.float32)
    for it in range(3):
        u1, v1, p1, pm1, info = jstep(u, v, p, pm)
        (u2, v2, p2, pm2, un, vn, pr, cyc, ru, rv, rp) = step.fused_simple_step(
            *(interop.tensor(x, dtype=torch.float32) for x in (u, v, p, pm)),
            dx=dx, dy=dy, rho=1.0, mu=0.01, bc=tbc, simple_cfg=interop.config(cfg),
            mom_cfg=interop.config(MOM), pres_cfg=interop.config(PRES))
        for name, a, b in (("u", u2, u1), ("v", v2, v1), ("p", p2, p1)):
            assert rel_err(a, b) < 2e-4, (it, name, rel_err(a, b))
        assert int(cyc) == int(info.inner_iterations)
        for a, b in ((un, info.u_norm), (vn, info.v_norm), (pm2, pm1)):
            assert abs(float(a) - float(b)) <= 2e-4 * abs(float(b)), it
        u, v, p, pm = u1, v1, p1, pm1
    assert step.LAUNCHES == 0  # CPU tensors never launch


@pytest.fixture
def kernel_gates_open(monkeypatch):
    """Treat CPU tensors as kernel-capable and count each kernel wrapper's
    plain calls: the path a CUDA float32 state takes, on the CPU."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    calls = {}

    def count(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    count(step, "fused_outer_step_plain", "K6")
    count(mg, "galerkin_levels_plain", "K4")
    count(mg, "fused_mg_solve_plain", "K5")
    count(krylov, "bicgstab_momentum_plain", "K7")
    count(mg, "fused_vcycle_plain", "K3")
    return calls


def test_headline_dispatch_is_one_k6_per_step(kernel_gates_open):
    """With the gates open the headline runs one K6 per outer step and K4
    once (the setup rebuild of the lagged carry); nothing else launches.
    The iteration count stays within 2 of the composed run's (K6 rebuilds
    the coarse operators every step and checks with compensated norms)."""
    calls = kernel_gates_open
    mesh, fluid, bc = _case()
    cfg = SIMPLEConfig(max_iterations=500, tolerance=1e-3)
    ts, td = _port_solve(mesh, fluid, bc, cfg)
    assert td.converged
    assert calls == {"K6": td.iterations, "K4": 1}
    calls.clear()
    _, tc = _port_solve(mesh, fluid, bc, cfg, mom=dataclasses.replace(MOM, backend="xla"),
                        pres=dataclasses.replace(PRES, backend="xla"))
    assert abs(td.iterations - tc.iterations) <= 2
    assert calls == {}


def test_fmg_dispatch_runs_k7_k5_k4(kernel_gates_open):
    """cycle_type='fmg' closes the K6 gate: per step two K7 solves and one
    K5 solve (after the composed FMG bootstrap), and K4 at setup plus at
    every coarse refresh (iterations 0, 8, 16)."""
    calls = kernel_gates_open
    mesh, fluid, bc = _case()
    steps = 20
    cfg = SIMPLEConfig(max_iterations=steps, tolerance=0.0)
    pres = dataclasses.replace(PRES, cycle_type="fmg")
    ts, td = _port_solve(mesh, fluid, bc, cfg, pres=pres)
    assert td.iterations == steps
    assert calls == {"K7": 2 * steps, "K5": steps, "K4": 1 + 3}
    hist = td.total_res_history
    assert bool(torch.isfinite(hist).all()) and float(hist[-1]) < float(hist[0])


def test_unported_step_bodies_raise():
    """Every algorithm of the JAX package's step kernel has its body now;
    an unknown algorithm, or a scalar carry of the wrong length, raises."""
    from naviflow_tpu_torch.algorithms import SIMPLECConfig

    mesh, _, bc = _case(15)
    tbc = interop.boundary_conditions(bc)
    tm = interop.mesh(mesh)
    s = nt.initialize_state(tm, tbc, device="cpu")
    kw = dict(dx=tm.dx, dy=tm.dy, rho=1.0, mu=0.01, bc=tbc, cfg=SIMPLECConfig(),
              mom_cfg=interop.config(MOM), pres_cfg=interop.config(PRES))
    with pytest.raises(ValueError, match="Unknown algorithm"):
        step.fused_outer_step("nope", s.u, s.v, s.p, (0.0,), **kw)
    with pytest.raises(ValueError, match="scalar carries"):
        step.fused_outer_step("simplec", s.u, s.v, s.p, (0.2,), **kw)
    out = step.fused_outer_step("simplec", s.u, s.v, s.p, (0.2, float("inf")), **kw)
    assert len(out[3]) == 5 and all(bool(torch.isfinite(x)) for x in out[3])


def test_ghia_tables_and_errors_match_jax():
    """The port's own copy of the Ghia tables equals the JAX package's, and
    its error metrics agree on the same fields."""
    assert tval.AVAILABLE_REYNOLDS == jval.AVAILABLE_REYNOLDS
    np.testing.assert_array_equal(tval.GHIA_X, jval.GHIA_X)
    np.testing.assert_array_equal(tval.GHIA_Y, jval.GHIA_Y)
    for re in jval.AVAILABLE_REYNOLDS:
        for a, b in zip(tval.get_ghia_data(re), jval.get_ghia_data(re)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mesh, _, bc = _case()
    rng = np.random.default_rng(9)
    s = nf.initialize_state(mesh, bc)
    u = np.asarray(s.u) + 0.1 * rng.normal(size=s.u.shape)
    v = np.asarray(s.v) + 0.1 * rng.normal(size=s.v.shape)
    tm = interop.mesh(mesh)
    for tf, jf in ((tval.infinity_norm_error, jval.infinity_norm_error),
                   (tval.l2_norm_error, jval.l2_norm_error)):
        assert tf(torch.as_tensor(u), torch.as_tensor(v), tm, 100) == pytest.approx(
            float(jf(jnp.asarray(u), jnp.asarray(v), mesh, 100)), rel=1e-12)
    for a, b in zip(tval.centerline_profiles(u, v, tm), jval.centerline_profiles(u, v, mesh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    got = tval.validate_against_benchmark(u, v, tm, 100)
    want = jval.validate_against_benchmark(u, v, mesh, 100)
    assert got["passed"] == want["passed"]


def test_initialize_state_defaults_to_the_card():
    """No device given: the card; with no card it raises, never a silent
    CPU state.  device='cpu' asks for the CPU."""
    mesh = nt.StructuredMesh(nx=7, ny=7)
    bc = nt.lid_driven_cavity(1.0)
    if torch.cuda.is_available():
        assert nt.initialize_state(mesh, bc).u.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nt.initialize_state(mesh, bc)
    assert nt.initialize_state(mesh, bc, device="cpu").u.device.type == "cpu"
