"""Simulation result container (port of
``naviflow_tpu/postprocessing/result.py``).

Holds the final fields, named residual histories (``add_history`` /
``get_history``), divergence diagnostics, the Ghia validation and ``.npz``
export.  Tensors come off the device once, at construction
(``.detach().cpu().numpy()``); everything after is host-side numpy.
Histories are cut at the iteration count.  The plots import matplotlib
only when called (``visualization.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.mesh import StructuredMesh
from .validation import infinity_norm_error, l2_norm_error, validate_against_benchmark


def to_numpy(x):
    """A tensor on any device, or anything numpy reads, as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _optional(x):
    return to_numpy(x) if x is not None else None


class SimulationResult:
    def __init__(
        self,
        u,
        v,
        p,
        mesh: StructuredMesh,
        iterations: int = 0,
        residuals=None,
        reynolds: Optional[float] = None,
        u_residual_field=None,
        v_residual_field=None,
        p_residual_field=None,
        converged: Optional[bool] = None,
    ):
        self.u = to_numpy(u)
        self.v = to_numpy(v)
        self.p = to_numpy(p)
        self.mesh = mesh
        self.iterations = int(iterations)
        self.residuals = to_numpy(residuals) if residuals is not None else np.zeros(0)
        self.reynolds = reynolds
        self.converged = converged
        self.u_residual_field = _optional(u_residual_field)
        self.v_residual_field = _optional(v_residual_field)
        self.p_residual_field = _optional(p_residual_field)
        self._history: Dict[str, np.ndarray] = {}

    # -- histories ------------------------------------------------------------
    def add_history(self, name: str, values) -> None:
        self._history[name] = to_numpy(values)

    def get_history(self, name: str):
        return self._history.get(name)

    @property
    def history_names(self):
        return sorted(self._history)

    # -- physics diagnostics ------------------------------------------------
    def calculate_divergence(self) -> np.ndarray:
        dx, dy = self.mesh.get_cell_sizes()
        return (self.u[1:, :] - self.u[:-1, :]) / dx + (self.v[:, 1:] - self.v[:, :-1]) / dy

    def get_max_divergence(self) -> float:
        div = self.calculate_divergence()
        return float(np.max(np.abs(div[1:-1, 1:-1])))

    # -- Ghia validation ----------------------------------------------------
    def calculate_infinity_norm_error(self) -> float:
        return infinity_norm_error(self.u, self.v, self.mesh, self.reynolds)

    def calculate_l2_norm_error(self) -> float:
        return l2_norm_error(self.u, self.v, self.mesh, self.reynolds)

    def validate_against_benchmark(self, threshold: float = 0.10) -> dict:
        return validate_against_benchmark(self.u, self.v, self.mesh, self.reynolds, threshold)

    # -- persistence ----------------------------------------------------------
    def save_solution(self, filename: str) -> str:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        np.savez(filename, u=self.u, v=self.v, p=self.p, x=self.mesh.x, y=self.mesh.y,
                 reynolds=self.reynolds, iterations=self.iterations, residuals=self.residuals)
        return filename

    @staticmethod
    def load_solution(filename: str, mesh: Optional[StructuredMesh] = None):
        data = np.load(filename, allow_pickle=True)
        nx, ny = data["p"].shape
        mesh = mesh or StructuredMesh(nx=nx, ny=ny)
        return SimulationResult(data["u"], data["v"], data["p"], mesh,
                                iterations=int(data["iterations"]), residuals=data["residuals"],
                                reynolds=float(data["reynolds"]))

    # -- plots (visualization.py, matplotlib imported when called) ------------
    def plot_combined_results(self, **kw):
        from .visualization import plot_combined_results_matrix

        return plot_combined_results_matrix(self, **kw)

    def plot_final_residuals(self, **kw):
        from .visualization import plot_final_residuals

        return plot_final_residuals(self, **kw)


def result_from_solve(mesh, fluid, state, diag, algorithm: str = "SIMPLE") -> SimulationResult:
    """A :class:`SimulationResult` from ``(FlowState, SolveDiagnostics)``."""
    n = int(diag.iterations)
    res = SimulationResult(
        state.u, state.v, state.p, mesh,
        iterations=n,
        residuals=to_numpy(diag.total_res_history)[:n],
        reynolds=fluid.get_reynolds_number(),
        u_residual_field=diag.u_residual_field,
        v_residual_field=diag.v_residual_field,
        p_residual_field=diag.p_residual_field,
        converged=bool(diag.converged),
    )
    for name, hist in (("u_rel_norm", diag.u_res_history), ("v_rel_norm", diag.v_res_history),
                       ("p_rel_norm", diag.p_res_history),
                       ("total_rel_norm", diag.total_res_history),
                       ("pressure_inner_iterations", diag.inner_iters_history)):
        res.add_history(name, to_numpy(hist)[:n])
    res.algorithm = algorithm
    return res
