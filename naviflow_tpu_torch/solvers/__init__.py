from .momentum import (
    ChebyshevMomentumConfig,
    GMRESMomentumConfig,
    IDRSMomentumConfig,
    JacobiMomentumConfig,
    KrylovMomentumConfig,
    RBGSMomentumConfig,
    solve_momentum_pair,
    solve_u_momentum,
    solve_v_momentum,
)
from .pressure import (
    DirectPressureConfig,
    JacobiPressureConfig,
    PressureSolveInfo,
    RBGSPressureConfig,
    jacobi_sweep,
    rbgs_sweep,
    solve_pressure,
)
from .velocity import update_velocity
from .krylov import (
    BiCGSTABPressureConfig,
    CGPressureConfig,
    GMRESPressureConfig,
    MGCGPressureConfig,
    gmres_solve,
    solve_pressure_krylov,
)
from .multigrid import MultigridConfig, multigrid_solve
from .dispatch import dispatch_pressure_solve
