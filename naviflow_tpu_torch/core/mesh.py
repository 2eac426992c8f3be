"""Structured Cartesian mesh (port of ``naviflow_tpu/core/mesh.py``).

The mesh is a plain frozen value: dimensions and spacings are Python
scalars.  Grid conventions are load-bearing and preserved exactly:

* staggered MAC layout — p at cell centers ``(nx, ny)``, u at vertical faces
  ``(nx+1, ny)``, v at horizontal faces ``(nx, ny+1)``;
* ``dx = length / (nx - 1)`` (NOT ``length/nx``);
* cell centers at ``linspace(dx/2, length - dx/2, nx)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StructuredMesh:
    """Uniform 2-D Cartesian mesh (hashable)."""

    nx: int
    ny: int
    length: float = 1.0
    height: float = 1.0

    @property
    def dx(self) -> float:
        return self.length / (self.nx - 1)

    @property
    def dy(self) -> float:
        return self.height / (self.ny - 1)

    def get_dimensions(self):
        return self.nx, self.ny

    def get_cell_sizes(self):
        return self.dx, self.dy

    @property
    def x(self) -> np.ndarray:
        return np.linspace(self.dx / 2, self.length - self.dx / 2, self.nx)

    @property
    def y(self) -> np.ndarray:
        return np.linspace(self.dy / 2, self.height - self.dy / 2, self.ny)

    def meshgrid(self):
        return np.meshgrid(self.x, self.y, indexing="ij")

    @property
    def p_shape(self):
        return (self.nx, self.ny)

    @property
    def u_shape(self):
        return (self.nx + 1, self.ny)

    @property
    def v_shape(self):
        return (self.nx, self.ny + 1)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny
