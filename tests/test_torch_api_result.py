"""The port's object API (``api.py``), ``SimulationResult``
(``postprocessing/result.py``), its plots (``visualization.py``) and the
profiler (``utils/profiler.py``) on the CPU (f64), against the JAX
package's facade: the reference driver pattern and the pressure-solver
zoo of ``tests/test_api_and_io.py`` (iterations equal, fields and
histories to rel 1e-10, Ghia errors), the Ghia tracking of a chunked
loop, the ``.npz`` round trip, the HDF5 profile and the two plots."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu import api as japi

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import api as tapi
from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu_torch.postprocessing.result import SimulationResult

torch.set_num_threads(2)

N = 15
HISTORIES = ("u_rel_norm", "v_rel_norm", "p_rel_norm", "total_rel_norm",
             "pressure_inner_iterations")
ZOO = {
    "jacobi": ("JacobiSolver", dict(tolerance=1e-5)),
    "gauss_seidel": ("GaussSeidelSolver", dict(tolerance=1e-5)),
    "multigrid": ("MultiGridSolver", dict(tolerance=1e-4, cycle_type="v")),
    "mgcg": ("GeoMultigridPrecondCGSolver", dict(tolerance=1e-7)),
    "direct": ("DirectPressureSolver", {}),
}


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _run(pkg, solver, kw, tmp_path, *, tol=1e-3, max_it=1200, **solve_kw):
    """The reference driver pattern through one package's facade, in f64."""
    mesh = pkg.StructuredMesh(nx=N, ny=N)
    fluid = pkg.FluidProperties(density=1.0, reynolds_number=100)
    api = japi if pkg is nf else tapi
    extra = {} if pkg is nf else dict(device="cpu", dtype=torch.float64)
    algo = api.SimpleSolver(mesh, fluid, getattr(api, solver)(**kw), api.AMGMomentumSolver(),
                            api.StandardVelocityUpdater(), alpha_p=0.3, alpha_u=0.7, **extra)
    algo.set_boundary_condition("top", "velocity", {"u": 1.0})
    if pkg is nf:  # the JAX facade has no dtype argument
        algo._state = nf.initialize_state(mesh, algo.bc, dtype=jnp.float64)
    return algo, algo.solve(max_iterations=max_it, tolerance=tol, save_profile=True,
                            profile_dir=str(tmp_path / ("jax" if pkg is nf else "torch")),
                            **solve_kw)


@pytest.mark.parametrize("name", list(ZOO))
def test_facade_matches_jax(name, tmp_path):
    """The driver pattern (Jacobi pressure) and the pressure-solver zoo:
    the same iterations, fields, histories and Ghia errors."""
    solver, kw = ZOO[name]
    ja, jr = _run(nf, solver, kw, tmp_path)
    ta, tr = _run(nt, solver, kw, tmp_path)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations > 0
    for field in ("u", "v", "p"):
        assert isinstance(getattr(ta, field), np.ndarray)
        assert _rel(getattr(ta, field), getattr(ja, field)) <= 1e-10, field
        assert _rel(getattr(tr, field), getattr(jr, field)) <= 1e-10, field
    for h in HISTORIES:
        assert tr.get_history(h).shape == jr.get_history(h).shape == (tr.iterations,)
        if h != "p_rel_norm":
            assert _rel(tr.get_history(h), jr.get_history(h)) <= 1e-10, h
    # the pressure residual of a solve to its tolerance carries the rounding
    # of b - A p relative to itself (2.5e-10 for MGCG to 1e-7); the direct
    # solve's is rounding alone, so its running-max ratio is noise
    if name == "direct":
        assert max(np.max(np.abs(tr.p_residual_field)), np.max(np.abs(jr.p_residual_field))) < 1e-12
    else:
        assert _rel(tr.get_history("p_rel_norm"), jr.get_history("p_rel_norm")) <= 1e-6
    assert tr.history_names == jr.history_names
    assert _rel(tr.residuals, jr.residuals) <= 1e-10
    assert tr.calculate_infinity_norm_error() == pytest.approx(
        jr.calculate_infinity_norm_error(), rel=1e-8)
    assert tr.calculate_l2_norm_error() == pytest.approx(jr.calculate_l2_norm_error(), rel=1e-8)
    assert tr.validate_against_benchmark()["passed"] == jr.validate_against_benchmark()["passed"]
    assert tr.get_max_divergence() == pytest.approx(jr.get_max_divergence(), rel=1e-6, abs=1e-12)
    assert ta.get_max_divergence() < 1e-4
    assert os.path.exists(tmp_path / "torch" / f"SIMPLE_Re100_mesh{N}x{N}_profile.h5")


def test_facade_runs_the_functional_solve(tmp_path):
    """``solve`` is the functional ``simple_solve`` with the same config,
    bit for bit, and with ``track_infinity_norm`` on a chunked loop the
    Ghia error of every chunk (``on_chunk``), as the JAX facade records."""
    kw = dict(track_infinity_norm=True, loop="chunked:40")
    ta, tr = _run(nt, "MultiGridSolver", dict(tolerance=1e-4), tmp_path, **kw)
    _, jr = _run(nf, "MultiGridSolver", dict(tolerance=1e-4), tmp_path, **kw)
    mesh = nt.StructuredMesh(nx=N, ny=N)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=100)
    bc = nt.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(alpha_p=0.3, alpha_u=0.7, max_iterations=1200, tolerance=1e-3)
    state, diag = simple_solve(mesh, fluid, bc,
                               nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu"),
                               cfg, momentum=ta.momentum_solver, pressure=ta.pressure_solver,
                               loop="chunked:40")
    assert diag.iterations == tr.iterations
    for field in ("u", "v", "p"):
        assert torch.equal(getattr(ta.state, field), getattr(state, field))
    hist = tr.get_history("infinity_norm_error")
    assert len(hist) == -(-tr.iterations // 40) + 1
    np.testing.assert_allclose(hist, jr.get_history("infinity_norm_error"), rtol=1e-8)
    assert hist[-1] == tr.calculate_infinity_norm_error()
    assert ta.profiler.iterations == tr.iterations
    assert ta.profiler.convergence_info["residual_history"].shape == (tr.iterations,)
    assert ta.profiler.total_time > 0


def test_result_round_trip_profile_and_plots(tmp_path):
    ta, tr = _run(nt, "MultiGridSolver", dict(tolerance=1e-4), tmp_path)
    path = tr.save_solution(str(tmp_path / "out" / "sol.npz"))
    back = SimulationResult.load_solution(path)
    for field in ("u", "v", "p", "residuals"):
        np.testing.assert_array_equal(getattr(back, field), getattr(tr, field))
    assert back.iterations == tr.iterations and back.reynolds == 100
    assert back.calculate_infinity_norm_error() == tr.calculate_infinity_norm_error()

    ta.profiler.start_section()
    ta.profiler.end_section("post")
    ta.profiler.add_residual_data(1, u=1.0, v=2.0)
    h5 = ta.save_profiling_data(str(tmp_path / "prof.h5"))
    with h5py.File(h5, "r") as f:
        assert f["simulation"].attrs["mesh_nx"] == N
        assert f["performance"].attrs["iterations"] == tr.iterations
        assert "section_post" in f["performance"].attrs
        np.testing.assert_array_equal(f["convergence"]["residual_history"][()],
                                      tr.get_history("total_rel_norm"))
        assert f["pressure_solver"].attrs["name"] == "MultigridConfig"
        assert f["algorithm"].attrs["alpha_p"] == 0.3
        assert f["system"].attrs["torch_version"] == torch.__version__
        assert list(f["residual_history"]["u"][()]) == [1.0]

    for fn in ("plot_combined_results", "plot_final_residuals"):
        out = getattr(tr, fn)(filename=str(tmp_path / f"{fn}.png"))
        assert os.path.getsize(out) > 1000


def test_trace_and_default_device(tmp_path):
    """The profiler's ``torch.profiler`` trace exports a Chrome trace; the
    facade's state is the card's unless the caller asks for the CPU."""
    from naviflow_tpu_torch.utils.profiler import Profiler

    prof = Profiler("SIMPLE")
    prof.start_device_trace(str(tmp_path / "trace"))
    torch.ones(8).sum()
    out = prof.stop_device_trace()
    assert os.path.getsize(out) > 0
    if not torch.cuda.is_available():
        mesh = nt.StructuredMesh(nx=7, ny=7)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.SimpleSolver(mesh, nt.FluidProperties(density=1.0, reynolds_number=100))
