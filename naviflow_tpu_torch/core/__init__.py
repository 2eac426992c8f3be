from .mesh import StructuredMesh
from .fluid import FluidProperties
from .bc import (
    BoundaryConditions,
    BoundaryLocation,
    BoundaryType,
    SideCondition,
    apply_velocity_bcs,
    enforce_pressure_bcs,
    lid_driven_cavity,
)
from .state import FlowState, ScalarField, VectorField, initialize_state
