"""Profiler with HDF5 export (port of ``naviflow_tpu/utils/profiler.py``).

Wall and CPU timers, named accumulating sections, per-iteration residual
rows, system information and HDF5 export with the reference's group
schema (``simulation`` / ``performance`` / ``convergence`` / ``system`` /
``algorithm`` / ``pressure_solver`` and the residual-history datasets);
files are named ``{ALGO}_Re{re}_mesh{nx}x{ny}_profile.h5``.

Timers synchronise the card (``torch.cuda.synchronize()``) where CUDA is
initialised, so a section times the card's work and not how fast the host
queues it.  ``start_device_trace`` / ``stop_device_trace`` record a
``torch.profiler`` run and export it as a Chrome trace.  ``save`` imports
``h5py`` when called; without it, it raises ``ImportError`` saying what to
install.
"""

from __future__ import annotations

import os
import platform
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def require_h5py(who: str):
    """The ``h5py`` module; without it, an ``ImportError`` saying what to
    install (the card's machine has no h5py)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{who} writes HDF5 and needs h5py: pip install h5py") from e
    return h5py


def _sync():
    """Wait for the card's queued work (a no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    def __init__(self, algorithm_name: str, mesh=None, fluid=None, algorithm=None):
        self.algorithm_name = algorithm_name
        self.mesh = mesh
        self.fluid = fluid
        self.algorithm = algorithm
        self.sections: Dict[str, float] = {}
        self._section_start: Optional[float] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.cpu_start: Optional[float] = None
        self.cpu_end: Optional[float] = None
        self.iterations = 0
        self.residual_rows: List[dict] = []
        self.convergence_info: dict = {}
        self.pressure_solver_info: dict = {}
        self._trace = None
        self._trace_file: Optional[str] = None

    # -- timers -----------------------------------------------------------------
    def start(self):
        _sync()
        self.start_time = time.perf_counter()
        self.cpu_start = time.process_time()

    def end(self):
        _sync()
        self.end_time = time.perf_counter()
        self.cpu_end = time.process_time()

    @property
    def total_time(self) -> float:
        if self.start_time is None:
            return 0.0
        end = self.end_time if self.end_time is not None else time.perf_counter()
        return end - self.start_time

    # -- sections ---------------------------------------------------------------
    def start_section(self):
        _sync()
        self._section_start = time.perf_counter()

    def end_section(self, name: str):
        if self._section_start is None:
            return
        _sync()
        self.sections[name] = self.sections.get(name, 0.0) + (
            time.perf_counter() - self._section_start)
        self._section_start = None

    # -- per-iteration rows -----------------------------------------------------
    def add_residual_data(self, iteration: int, **values):
        row = {"iteration": iteration, "wall_time": self.total_time}
        row.update(values)
        self.residual_rows.append(row)

    def set_iterations(self, n: int):
        self.iterations = int(n)

    def set_convergence_info(self, *, tolerance, final_residual, residual_history, converged):
        self.convergence_info = dict(
            tolerance=float(tolerance),
            final_residual=float(final_residual),
            residual_history=np.asarray(residual_history, dtype=np.float64),
            converged=bool(converged),
        )

    def set_pressure_solver_info(self, *, solver_name, inner_iterations=None,
                                 convergence_rate=None, solver_specific=None):
        self.pressure_solver_info = dict(
            solver_name=str(solver_name),
            inner_iterations=(np.asarray(inner_iterations) if inner_iterations is not None
                              else None),
            convergence_rate=convergence_rate,
            solver_specific=solver_specific or {},
        )

    # -- device tracing -----------------------------------------------------------
    def start_device_trace(self, trace_dir: str):
        """Record the host's and the card's activity (``torch.profiler``)
        until :meth:`stop_device_trace`, which writes a Chrome trace into
        ``trace_dir``."""
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._trace_file = os.path.join(trace_dir, f"{self.algorithm_name}_trace.json")
        self._trace = profile(activities=activities)
        self._trace.__enter__()

    def stop_device_trace(self) -> Optional[str]:
        if self._trace is None:
            return None
        _sync()
        self._trace.__exit__(None, None, None)
        self._trace.export_chrome_trace(self._trace_file)
        out, self._trace = self._trace_file, None
        return out

    # -- system info ----------------------------------------------------------------
    @staticmethod
    def system_info() -> dict:
        info = {
            "platform": platform.platform(),
            "python_version": platform.python_version(),
            "processor": platform.processor() or platform.machine(),
            "cpu_count": os.cpu_count() or 0,
            "torch_version": str(torch.__version__),
            "cuda_version": str(torch.version.cuda or "none"),
        }
        if torch.cuda.is_available():
            info["accelerator"] = f"cuda:{torch.cuda.get_device_name(0)}"
            info["device_count"] = torch.cuda.device_count()
        else:
            info["accelerator"] = "unavailable"
            info["device_count"] = 0
        try:
            import psutil

            info["total_memory_gb"] = psutil.virtual_memory().total / 2**30
        except ImportError:
            pass
        return info

    # -- HDF5 export --------------------------------------------------------------------
    def save(self, filename: Optional[str] = None, profile_dir: str = "results/profiles") -> str:
        h5py = require_h5py("Profiler.save")

        if filename is None:
            nx, ny = (self.mesh.get_dimensions() if self.mesh else (0, 0))
            re = int(self.fluid.get_reynolds_number()) if self.fluid else 0
            os.makedirs(profile_dir, exist_ok=True)
            filename = os.path.join(
                profile_dir, f"{self.algorithm_name}_Re{re}_mesh{nx}x{ny}_profile.h5")
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)

        with h5py.File(filename, "w") as f:
            sim = f.create_group("simulation")
            sim.attrs["algorithm"] = self.algorithm_name
            if self.mesh is not None:
                nx, ny = self.mesh.get_dimensions()
                sim.attrs["mesh_nx"] = nx
                sim.attrs["mesh_ny"] = ny
                sim.attrs["dx"], sim.attrs["dy"] = self.mesh.get_cell_sizes()
            if self.fluid is not None:
                sim.attrs["reynolds_number"] = self.fluid.get_reynolds_number()
                sim.attrs["density"] = self.fluid.get_density()
                sim.attrs["viscosity"] = self.fluid.get_viscosity()

            perf = f.create_group("performance")
            perf.attrs["total_time"] = self.total_time
            if self.cpu_start is not None and self.cpu_end is not None:
                perf.attrs["cpu_time"] = self.cpu_end - self.cpu_start
            perf.attrs["iterations"] = self.iterations
            if self.iterations:
                perf.attrs["time_per_iteration"] = self.total_time / self.iterations
            for name, t in self.sections.items():
                perf.attrs[f"section_{name}"] = t

            conv = f.create_group("convergence")
            for key, val in self.convergence_info.items():
                if key == "residual_history":
                    conv.create_dataset("residual_history", data=val)
                else:
                    conv.attrs[key] = val

            sysg = f.create_group("system")
            for key, val in self.system_info().items():
                sysg.attrs[key] = val

            alg = f.create_group("algorithm")
            if self.algorithm is not None:
                for attr in ("alpha_p", "alpha_u"):
                    if hasattr(self.algorithm, attr):
                        alg.attrs[attr] = getattr(self.algorithm, attr)

            ps = f.create_group("pressure_solver")
            if self.pressure_solver_info:
                ps.attrs["name"] = self.pressure_solver_info["solver_name"]
                inner = self.pressure_solver_info.get("inner_iterations")
                if inner is not None:
                    ps.create_dataset("inner_iterations_history", data=inner)
                rate = self.pressure_solver_info.get("convergence_rate")
                if rate is not None:
                    ps.attrs["convergence_rate"] = rate
                for k, v in (self.pressure_solver_info.get("solver_specific") or {}).items():
                    ps.attrs[k] = v

            if self.residual_rows:
                rh = f.create_group("residual_history")
                keys = sorted({k for row in self.residual_rows for k in row})
                for key in keys:
                    rh.create_dataset(key, data=np.asarray(
                        [row.get(key, np.nan) for row in self.residual_rows]))
        return filename
