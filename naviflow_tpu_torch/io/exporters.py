"""Field exporters: npz, HDF5 and legacy-VTK structured points (port of
``naviflow_tpu/io/exporters.py``).

They write a :class:`~naviflow_tpu_torch.postprocessing.result.SimulationResult`,
whose fields are host numpy arrays already, so nothing here touches the
card.  VTK output is ASCII STRUCTURED_POINTS readable by ParaView, written
with numpy alone; ``export_hdf5`` imports h5py when called.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.profiler import require_h5py


def export_npz(result, filename: str) -> str:
    return result.save_solution(filename)


def export_hdf5(result, filename: str) -> str:
    h5py = require_h5py("export_hdf5")
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with h5py.File(filename, "w") as f:
        f.create_dataset("u", data=result.u)
        f.create_dataset("v", data=result.v)
        f.create_dataset("p", data=result.p)
        f.create_dataset("x", data=result.mesh.x)
        f.create_dataset("y", data=result.mesh.y)
        f.attrs["reynolds"] = result.reynolds or 0.0
        f.attrs["iterations"] = result.iterations
        if result.residuals.size:
            f.create_dataset("residual_history", data=result.residuals)
    return filename


def export_vtk(result, filename: str) -> str:
    """Cell-centered fields as ASCII VTK STRUCTURED_POINTS."""
    mesh = result.mesh
    nx, ny = mesh.get_dimensions()
    dx, dy = mesh.get_cell_sizes()
    uc = 0.5 * (result.u[:-1, :] + result.u[1:, :])
    vc = 0.5 * (result.v[:, :-1] + result.v[:, 1:])
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("naviflow_tpu result\nASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} 1\n")
        f.write(f"ORIGIN {dx / 2} {dy / 2} 0\n")
        f.write(f"SPACING {dx} {dy} 1\n")
        f.write(f"POINT_DATA {nx * ny}\n")
        f.write("SCALARS pressure float 1\nLOOKUP_TABLE default\n")
        np.savetxt(f, result.p.T.reshape(-1), fmt="%.7e")
        f.write("VECTORS velocity float\n")
        vel = np.stack([uc.T.reshape(-1), vc.T.reshape(-1),
                        np.zeros(nx * ny)], axis=1)
        np.savetxt(f, vel, fmt="%.7e")
    return filename
