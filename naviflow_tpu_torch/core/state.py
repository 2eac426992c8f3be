"""Flow state and field containers (port of ``naviflow_tpu/core/state.py``).

The solver state is a frozen dataclass of tensors.  A solve runs on the
device of the state it is given and never mutates the caller's tensors.
The ``ScalarField`` / ``VectorField`` wrappers mirror the reference's OO
containers (``scalar_field.py``, ``vector_field.py``): their tensors live
on ``device`` and ``set_boundary_value`` writes them in place.
"""

from __future__ import annotations

import dataclasses

import torch

from .bc import BoundaryConditions, apply_velocity_bcs
from .mesh import StructuredMesh


def resolve_device(device, who: str, hint: str = "pass device='cpu'") -> torch.device:
    """``device`` as a ``torch.device``; raises where a CUDA device is asked
    for and none is available (no silent fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; {hint} to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class FlowState:
    """Staggered-grid flow state: u (nx+1, ny), v (nx, ny+1), p (nx, ny)."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor

    @property
    def dtype(self):
        return self.u.dtype

    @property
    def device(self):
        return self.u.device

    def replace(self, **kw) -> "FlowState":
        return dataclasses.replace(self, **kw)


def initialize_state(
    mesh: StructuredMesh,
    bc: BoundaryConditions,
    dtype=torch.float32,
    device="cuda",
) -> FlowState:
    """Zero fields with velocity BCs applied, on ``device``: the card by
    default; pass ``device='cpu'`` for the CPU.  Raises where the device
    does not exist (no silent fall back to the CPU)."""
    device = resolve_device(device, "initialize_state")
    u = torch.zeros(mesh.u_shape, dtype=dtype, device=device)
    v = torch.zeros(mesh.v_shape, dtype=dtype, device=device)
    p = torch.zeros(mesh.p_shape, dtype=dtype, device=device)
    u, v = apply_velocity_bcs(u, v, bc)
    return FlowState(u=u, v=v, p=p)


class ScalarField:
    """Cell-centered scalar field wrapper (reference ``scalar_field.py``)."""

    def __init__(self, mesh: StructuredMesh, initial_value=0.0, dtype=torch.float32,
                 device="cuda"):
        self.mesh = mesh
        self.data = torch.full(mesh.p_shape, initial_value, dtype=dtype,
                               device=resolve_device(device, "ScalarField"))

    def set_boundary_value(self, boundary: str, value: float) -> "ScalarField":
        nx, ny = self.mesh.get_dimensions()
        if boundary == "left":
            self.data[0, :] = value
        elif boundary == "right":
            self.data[nx - 1, :] = value
        elif boundary == "bottom":
            self.data[:, 0] = value
        elif boundary == "top":
            self.data[:, ny - 1] = value
        else:
            raise ValueError(f"Unknown boundary: {boundary}")
        return self


class VectorField:
    """Staggered vector field wrapper (reference ``vector_field.py``).

    ``set_boundary_value`` on a staggered top boundary applies the ghost
    reflection ``v[:, ny] = -v[:, ny-1]`` convention used by the reference
    (``vector_field.py:98-113``) when ``reflect=True``.
    """

    def __init__(self, mesh: StructuredMesh, dtype=torch.float32, device="cuda"):
        self.mesh = mesh
        device = resolve_device(device, "VectorField")
        self.u = torch.zeros(mesh.u_shape, dtype=dtype, device=device)
        self.v = torch.zeros(mesh.v_shape, dtype=dtype, device=device)

    def set_boundary_value(self, boundary: str, u_value=0.0, v_value=0.0, reflect=False):
        nx, ny = self.mesh.get_dimensions()
        if boundary == "top":
            self.u[:, ny - 1] = u_value
            if reflect:
                self.v[:, ny] = -self.v[:, ny - 1]
            else:
                self.v[:, ny] = v_value
        elif boundary == "bottom":
            self.u[:, 0] = u_value
            self.v[:, 0] = v_value
        elif boundary == "left":
            self.u[0, :] = u_value
            self.v[0, :] = v_value
        elif boundary == "right":
            self.u[nx, :] = u_value
            self.v[nx - 1, :] = v_value
        else:
            raise ValueError(f"Unknown boundary: {boundary}")
        return self
