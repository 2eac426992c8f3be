from .base import SolveDiagnostics, StepInfo, run_outer_loop, run_outer_loop_batched
from .batch import batched_cavity_solve
from .newton import NewtonConfig, NewtonDiagnostics, newton_solve
from .piso import PISOConfig, piso_solve
from .sequencing import (
    build_ladder,
    grid_sequence_solve,
    prolong_state,
    reynolds_continuation_solve,
    sequenced_continuation_solve,
)
from .simple import SIMPLEConfig, simple_solve
from .simplec import SIMPLECConfig, simplec_solve
from .simpler import SIMPLERConfig, simpler_solve
