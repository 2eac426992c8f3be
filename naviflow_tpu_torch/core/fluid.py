"""Fluid properties (port of ``naviflow_tpu/core/fluid.py``).

``mu = rho * U_char * L_char / Re`` when viscosity is not given, and the
inverse relation for Re when viscosity is given.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FluidProperties:
    density: float = 1.0
    viscosity: float = None  # type: ignore[assignment]
    reynolds_number: float = None  # type: ignore[assignment]
    characteristic_velocity: float = 1.0
    characteristic_length: float = 1.0

    def __post_init__(self):
        scale = (self.density * self.characteristic_velocity
                 * self.characteristic_length)
        if self.viscosity is None:
            if self.reynolds_number is None:
                raise ValueError("Either viscosity or Reynolds number must be provided")
            object.__setattr__(self, "viscosity", scale / self.reynolds_number)
        elif self.reynolds_number is None:
            object.__setattr__(self, "reynolds_number", scale / self.viscosity)

    def get_density(self) -> float:
        return self.density

    def get_viscosity(self) -> float:
        return self.viscosity

    def get_reynolds_number(self) -> float:
        return self.reynolds_number
