"""naviflow_tpu_torch — the PyTorch / CUDA port of ``naviflow_tpu``.

It mirrors the JAX package's layout and names (``core/``, ``ops/``,
``solvers/``, ``algorithms/``) and runs on the device of the state it is
given: ``initialize_state`` makes it on the card unless the caller asks
for ``device='cpu'``.  On a CUDA tensor the SIMPLE paths launch
hand-written Hopper kernels (``csrc/``, built by ``nvcc`` at first use):
the 63^2 headline one whole-step kernel per outer step, the large-grid path
its momentum and multigrid kernels; on a CPU tensor every kernel wrapper
runs its plain PyTorch version.  The package never imports JAX.
"""

from .core.mesh import StructuredMesh
from .core.fluid import FluidProperties
from .core.bc import (
    BoundaryConditions,
    BoundaryLocation,
    BoundaryType,
    SideCondition,
    lid_driven_cavity,
)
from .core.state import FlowState, initialize_state

__version__ = "0.1.0"

__all__ = [
    "StructuredMesh",
    "FluidProperties",
    "BoundaryConditions",
    "BoundaryLocation",
    "BoundaryType",
    "SideCondition",
    "lid_driven_cavity",
    "FlowState",
    "initialize_state",
]
