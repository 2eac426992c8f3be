from .base import SolveDiagnostics, StepInfo, run_outer_loop
from .simple import SIMPLEConfig, simple_solve
