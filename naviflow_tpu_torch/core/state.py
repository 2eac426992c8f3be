"""Flow state (port of ``naviflow_tpu/core/state.py``; the ``ScalarField`` /
``VectorField`` wrappers belong to the object API, ROADMAP §1 item 14).

The solver state is a frozen dataclass of tensors.  A solve runs on the
device of the state it is given and never mutates the caller's tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from .bc import BoundaryConditions, apply_velocity_bcs
from .mesh import StructuredMesh


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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_state: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    u = torch.zeros(mesh.u_shape, dtype=dtype, device=device)
    v = torch.zeros(mesh.v_shape, dtype=dtype, device=device)
    p = torch.zeros(mesh.p_shape, dtype=dtype, device=device)
    u, v = apply_velocity_bcs(u, v, bc)
    return FlowState(u=u, v=v, p=p)
