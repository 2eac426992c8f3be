from .stencil import StencilCoeffs, apply_stencil, neighbor_sum, interior_mask
from .powerlaw import (
    power_law_A,
    u_momentum_coefficients,
    v_momentum_coefficients,
    relax_coefficients,
    d_coefficient,
)
from .poisson import (
    PoissonCoeffs,
    poisson_coefficients,
    apply_poisson,
    poisson_diagonal,
    pressure_rhs,
    divergence,
    max_interior_divergence,
)
