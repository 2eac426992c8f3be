"""User-facing object API mirroring the reference's driver-script surface
(port of ``naviflow_tpu/api.py``).

The reference's usage pattern::

    mesh = StructuredMesh(nx=63, ny=63)
    fluid = FluidProperties(density=1.0, reynolds_number=100)
    pressure_solver = MultiGridSolver(tolerance=1e-2, max_iterations=6)
    momentum_solver = AMGMomentumSolver(tolerance=1e-6, max_iterations=20)
    algorithm = SimpleSolver(mesh, fluid, pressure_solver, momentum_solver,
                             StandardVelocityUpdater(), alpha_p=0.3, alpha_u=0.7)
    algorithm.set_boundary_condition('top', 'velocity', {'u': 1.0})
    result = algorithm.solve(max_iterations=10000, tolerance=1e-5,
                             track_infinity_norm=True, loop='chunked')

Solver "objects" are the port's config dataclasses under the reference's
names; the algorithm classes run the functional ``*_solve`` with the same
config (nothing added, nothing converted) on the device given to them,
the card by default (``device='cpu'`` for the CPU), and return a
:class:`~naviflow_tpu_torch.postprocessing.result.SimulationResult`.

Name mapping for the reference's library-backed solvers: the PyAMG /
PETSc / SuperLU momentum solvers become matrix-free BiCGSTAB
(:class:`KrylovMomentumConfig`), algebraic multigrid becomes geometric
multigrid (or multigrid-preconditioned CG), the SuperLU pressure solve
the dense direct solve.
"""

from __future__ import annotations

import os

import torch

from .core.bc import BoundaryConditions
from .core.fluid import FluidProperties
from .core.mesh import StructuredMesh
from .core.state import initialize_state
from .ops.poisson import max_interior_divergence
from .postprocessing.result import SimulationResult, result_from_solve, to_numpy
from .solvers.krylov import (BiCGSTABPressureConfig, CGPressureConfig, GMRESPressureConfig,
                             MGCGPressureConfig)
from .solvers.momentum import (GMRESMomentumConfig, IDRSMomentumConfig, JacobiMomentumConfig,
                               KrylovMomentumConfig)
from .solvers.multigrid import MultigridConfig
from .solvers.pressure import DirectPressureConfig, JacobiPressureConfig, RBGSPressureConfig
from .utils.profiler import Profiler


# ---------------------------------------------------------------------------
# Reference-named pressure-solver constructors
# ---------------------------------------------------------------------------

def JacobiSolver(tolerance=1e-5, max_iterations=10000, omega=0.8, **_):
    """Weighted-Jacobi pressure solver."""
    return JacobiPressureConfig(tolerance=tolerance, max_iterations=max_iterations, omega=omega)


def GaussSeidelSolver(tolerance=1e-5, max_iterations=10000, omega=1.5,
                      method_type="red_black", **_):
    """Red-black SOR pressure solver (the sequential orderings map to
    red-black)."""
    return RBGSPressureConfig(tolerance=tolerance, max_iterations=max_iterations, omega=omega)


def MultiGridSolver(tolerance=1e-3, max_iterations=100, pre_smoothing=2, post_smoothing=2,
                    cycle_type="v", omega=1.0, coarsest_grid_size=7,
                    restriction_method="restrict_full_weighting", smoother=None, **_):
    """Geometric multigrid."""
    restriction = "full_weighting" if "full" in restriction_method else "inject"
    return MultigridConfig(tolerance=tolerance, max_cycles=max_iterations,
                           pre_smoothing=pre_smoothing, post_smoothing=post_smoothing,
                           cycle_type=cycle_type, omega=omega,
                           coarsest_grid_size=coarsest_grid_size, restriction=restriction)


def GeoMultigridPrecondCGSolver(tolerance=1e-7, max_iterations=200, mg_cycles=1, **_):
    """Multigrid-preconditioned CG."""
    return MGCGPressureConfig(tolerance=tolerance, max_iterations=max_iterations,
                              mg_cycles=mg_cycles)


def MatrixFreeBiCGSTABSolver(tolerance=1e-7, max_iterations=2000, **_):
    return BiCGSTABPressureConfig(tolerance=tolerance, max_iterations=max_iterations)


BiCGSTABSolver = MatrixFreeBiCGSTABSolver  # the explicit-matrix variant maps the same


def GMRESSolver(tolerance=1e-7, max_iterations=2000, restart=20, **_):
    """Restarted GMRES(m) pressure solver."""
    return GMRESPressureConfig(tolerance=tolerance, max_iterations=max_iterations,
                               restart=restart)


def PreconditionedCGSolver(tolerance=1e-7, max_iterations=2000, **_):
    """AMG-preconditioned CG -> multigrid-preconditioned CG."""
    return MGCGPressureConfig(tolerance=tolerance, max_iterations=max_iterations)


def PyAMGSolver(tolerance=1e-7, max_iterations=200, **_):
    """Standalone AMG -> geometric multigrid."""
    return MultigridConfig(tolerance=tolerance, max_cycles=max_iterations)


def DirectPressureSolver(**_):
    return DirectPressureConfig()


# ---------------------------------------------------------------------------
# Reference-named momentum-solver constructors
# ---------------------------------------------------------------------------

def JacobiMomentumSolver(discretization_scheme="power_law", n_jacobi_sweeps=1, **_):
    return JacobiMomentumConfig(n_sweeps=n_jacobi_sweeps, scheme=discretization_scheme)


def AMGMomentumSolver(tolerance=1e-5, max_iterations=100, discretization_scheme="power_law",
                      **_):
    """PyAMG momentum solver -> matrix-free BiCGSTAB."""
    return KrylovMomentumConfig(tolerance=tolerance, max_iterations=min(max_iterations, 200),
                                scheme=discretization_scheme)


def MatrixFreeMomentumSolver(tolerance=1e-7, max_iterations=100, solver_type="bicgstab",
                             discretization_scheme="power_law", **_):
    """``solver_type`` selects bicgstab (default), gmres or idrs."""
    if solver_type == "gmres":
        return GMRESMomentumConfig(tolerance=tolerance, max_iterations=min(max_iterations, 200),
                                   scheme=discretization_scheme)
    if solver_type == "idrs":
        return IDRSMomentumConfig(tolerance=tolerance, max_iterations=min(max_iterations, 100),
                                  scheme=discretization_scheme)
    return KrylovMomentumConfig(tolerance=tolerance, max_iterations=min(max_iterations, 200),
                                scheme=discretization_scheme)


MatrixMomentumSolver = MatrixFreeMomentumSolver
MatrixFreeMomentumSolverPETSc = MatrixFreeMomentumSolver


class StandardVelocityUpdater:
    """Marker for the reference's signature: the velocity corrector is
    built into every algorithm."""


# ---------------------------------------------------------------------------
# Algorithm facade
# ---------------------------------------------------------------------------

class BaseAlgorithm:
    """The object front end with the reference ``BaseAlgorithm`` surface.  The
    state lives on ``device``: the card by default (raises where there is
    none), ``'cpu'`` for the CPU."""

    _solve_fn = None
    _cfg_cls = None
    _name = "BASE"

    def __init__(self, mesh: StructuredMesh, fluid: FluidProperties, pressure_solver=None,
                 momentum_solver=None, velocity_updater=None, boundary_conditions=None,
                 alpha_p=0.3, alpha_u=0.7, device="cuda", dtype=torch.float32, **extra_cfg):
        self.mesh = mesh
        self.fluid = fluid
        self.pressure_solver = pressure_solver or RBGSPressureConfig()
        self.momentum_solver = momentum_solver or KrylovMomentumConfig(tolerance=1e-6,
                                                                       max_iterations=60)
        self.alpha_p = alpha_p
        self.alpha_u = alpha_u
        self.extra_cfg = extra_cfg
        self.device = torch.device(device)
        self.bc = boundary_conditions or BoundaryConditions()
        self.profiler = Profiler(self._name, mesh, fluid, algorithm=self)
        self._state = initialize_state(mesh, self.bc, dtype=dtype, device=self.device)
        self._diag = None

    # -- reference API ------------------------------------------------------
    def set_boundary_condition(self, boundary, condition_type, values=None):
        self.bc = self.bc.with_condition(boundary, condition_type, values)
        self._state = initialize_state(self.mesh, self.bc, self._state.dtype,
                                       device=self.device)

    @property
    def u(self):
        return to_numpy(self._state.u)

    @property
    def v(self):
        return to_numpy(self._state.v)

    @property
    def p(self):
        return to_numpy(self._state.p)

    @property
    def state(self):
        """The last solve's ``FlowState`` (tensors on the algorithm's device)."""
        return self._state

    def get_max_divergence(self) -> float:
        dx, dy = self.mesh.get_cell_sizes()
        return float(max_interior_divergence(self._state.u, self._state.v, dx=dx, dy=dy))

    def solve(self, max_iterations=1000, tolerance=1e-5, save_profile=False,
              profile_dir="results/profiles", track_infinity_norm=False,
              infinity_norm_interval=10, use_l2_norm=False, loop="auto",
              **cfg_kw) -> SimulationResult:
        """Run the functional solve with this configuration from the current
        state.  ``track_infinity_norm`` with a ``'chunked[:K]'`` loop records
        the Ghia error at every chunk boundary (``on_chunk``), and the final
        one at the end."""
        cfg = self._cfg_cls(alpha_p=self.alpha_p, alpha_u=self.alpha_u,
                            max_iterations=max_iterations, tolerance=tolerance,
                            **{**self.extra_cfg, **cfg_kw})
        infinity_history = []
        on_chunk = None
        if track_infinity_norm and str(loop).startswith("chunked"):
            from .postprocessing.validation import infinity_norm_error, l2_norm_error

            err_fn = l2_norm_error if use_l2_norm else infinity_norm_error
            re_num = self.fluid.get_reynolds_number()

            def on_chunk(it, total, carry):
                err = err_fn(carry["u"], carry["v"], self.mesh, re_num)
                infinity_history.append(err)
                print(f"Iteration {it}: residual {total:.3e}, Ghia error = {err:.3e}")

        self.profiler.start()
        state, diag = type(self)._solve_fn(
            self.mesh, self.fluid, self.bc, self._state, cfg,
            momentum=self.momentum_solver, pressure=self.pressure_solver,
            loop=loop, on_chunk=on_chunk)
        self.profiler.end()  # synchronises the card
        self._state = state
        self._diag = diag

        n = int(diag.iterations)
        self.profiler.set_iterations(n)
        self.profiler.set_convergence_info(
            tolerance=tolerance, final_residual=float(diag.final_residual),
            residual_history=to_numpy(diag.total_res_history)[:n],
            converged=bool(diag.converged))
        self.profiler.set_pressure_solver_info(
            solver_name=type(self.pressure_solver).__name__,
            inner_iterations=to_numpy(diag.inner_iters_history)[:n])

        result = result_from_solve(self.mesh, self.fluid, state, diag, algorithm=self._name)
        if track_infinity_norm:
            err = (result.calculate_l2_norm_error() if use_l2_norm
                   else result.calculate_infinity_norm_error())
            result.add_history("infinity_norm_error", infinity_history + [err])
        if save_profile:
            os.makedirs(profile_dir, exist_ok=True)
            nx, ny = self.mesh.get_dimensions()
            self.profiler.save(os.path.join(
                profile_dir, f"{self._name}_Re{int(self.fluid.get_reynolds_number())}"
                f"_mesh{nx}x{ny}_profile.h5"))
        return result

    def save_profiling_data(self, filename=None, profile_dir="results/profiles"):
        return self.profiler.save(filename, profile_dir)


def _bind(name, cfg_cls, solve_fn):
    cls = type(name, (BaseAlgorithm,), {"_name": name.replace("Solver", "").upper()})
    cls._cfg_cls = cfg_cls
    cls._solve_fn = staticmethod(solve_fn)
    return cls


from .algorithms.piso import PISOConfig, piso_solve  # noqa: E402
from .algorithms.simple import SIMPLEConfig, simple_solve  # noqa: E402
from .algorithms.simplec import SIMPLECConfig, simplec_solve  # noqa: E402
from .algorithms.simpler import SIMPLERConfig, simpler_solve  # noqa: E402

SimpleSolver = _bind("SimpleSolver", SIMPLEConfig, simple_solve)
SimpleSolverDict = SimpleSolver  # the reference's back-compat alias
SimplecSolver = _bind("SimplecSolver", SIMPLECConfig, simplec_solve)
SimplerSolver = _bind("SimplerSolver", SIMPLERConfig, simpler_solve)
PisoSolver = _bind("PisoSolver", PISOConfig, piso_solve)
