from .momentum import (
    ChebyshevMomentumConfig,
    JacobiMomentumConfig,
    solve_momentum_pair,
    solve_u_momentum,
    solve_v_momentum,
)
from .pressure import PressureSolveInfo, RBGSPressureConfig, rbgs_sweep, solve_pressure
from .velocity import update_velocity
from .multigrid import MultigridConfig, multigrid_solve
from .dispatch import dispatch_pressure_solve
