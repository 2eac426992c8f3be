"""The PyTorch port's SIMPLE slice against the JAX package's, on the CPU,
and the port's independence from JAX."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as port_simple_solve

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the bench's large-grid configuration (bench.py:_bench_large_grid)
MOM = ChebyshevMomentumConfig(degree=4)
PRES = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v",
                       pre_smoothing=1, post_smoothing=1, coarsest_sweeps=32,
                       coarse_rebuild_every=8)


def _rel(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def test_large_grid_slice_matches_jax_f64():
    """12 outer steps at 64^2 in float64 (the lagged-Galerkin refresh runs at
    steps 0 and 8): final u, v, p and the residual histories agree with the
    JAX package to rel 1e-9."""
    n, steps = 64, 12
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=steps, tolerance=0.0)
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                          cfg, momentum=MOM, pressure=PRES, loop="fused")

    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    state0 = nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu")
    before = [t.clone() for t in (state0.u, state0.v, state0.p)]
    ts, td = port_simple_solve(tmesh, interop.fluid(fluid), tbc, state0,
                               interop.config(cfg), momentum=interop.config(MOM),
                               pressure=interop.config(PRES))
    for name in ("u", "v", "p"):
        assert _rel(getattr(ts, name), getattr(js, name)) < 1e-9, name
    assert td.iterations == int(jd.iterations) == steps
    for name in ("u_res_history", "v_res_history", "p_res_history", "total_res_history"):
        want = np.asarray(getattr(jd, name))
        got = getattr(td, name).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-300)
    np.testing.assert_array_equal(td.inner_iters_history.numpy(),
                                  np.asarray(jd.inner_iters_history))
    # the caller's state is untouched
    for t0, t in zip(before, (state0.u, state0.v, state0.p)):
        assert torch.equal(t0, t)


def test_convergence_stop_matches_jax():
    """The host-side stopping test stops at the same outer iteration as the
    JAX while-loop (default Jacobi momentum + RBGS pressure, 16^2)."""
    n = 16
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=10)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=60, tolerance=2e-3)
    from naviflow_tpu.solvers import JacobiMomentumConfig, RBGSPressureConfig

    mom, pres = JacobiMomentumConfig(n_sweeps=2), RBGSPressureConfig(tolerance=1e-4,
                                                                    max_iterations=200)
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                          cfg, momentum=mom, pressure=pres, loop="fused")
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    ts, td = port_simple_solve(tmesh, interop.fluid(fluid), tbc,
                               nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu"),
                               interop.config(cfg), momentum=interop.config(mom),
                               pressure=interop.config(pres))
    assert td.iterations == int(jd.iterations)
    assert td.converged == bool(jd.converged)
    assert _rel(ts.u, js.u) < 1e-9
    np.testing.assert_array_equal(td.inner_iters_history.numpy(),
                                  np.asarray(jd.inner_iters_history))


def test_port_imports_without_jax():
    """The port never imports JAX: with ``jax`` blocked, importing the whole
    package (every module, the object API, the result, the plots, the
    profiler, Newton and batching, the command line, the checkpoints and
    exporters, the multigrid debug recorder and the examples among them)
    still works; with ``matplotlib`` and ``h5py`` blocked too, as on the
    card's machine, which has neither: the modules that use them import
    them when called."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for blocked in ("jax", "matplotlib", "h5py"):
            sys.modules[blocked] = None
        import naviflow_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(naviflow_tpu_torch.__path__,
                                                       "naviflow_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("api", "algorithms.newton", "algorithms.batch", "postprocessing.result",
                     "postprocessing.visualization", "utils.profiler", "cli", "io.checkpoint",
                     "io.exporters", "utils.mg_debug", "core.unstructured",
                     "postprocessing.cylinder_flow", "examples._common",
                     *("examples." + e for e in (
                         "cavity_basic", "cavity_bicgstab", "cavity_gauss_seidel",
                         "cavity_jacobi", "cavity_mgcg", "cavity_multigrid", "cavity_newton",
                         "cavity_piso", "cavity_quick", "cavity_sequenced",
                         "distributed_cavity", "operator_sanity", "profile_analysis"))):
            assert "naviflow_tpu_torch." + name in names, name
        assert not any(k == "jax" or k.startswith("jax.") or k.startswith("naviflow_tpu.")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
