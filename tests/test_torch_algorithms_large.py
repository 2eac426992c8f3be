"""SIMPLEC, PISO and SIMPLER in the PyTorch port against the JAX package,
on the CPU, with the bench's large-grid configuration at 64^2 in float64
(``tests/test_torch_algorithms.py``'s second half, a file of its own so
that the test workers share the long runs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

from test_torch_algorithms import ALGOS, _case, _port_solve, rel_err

torch.set_num_threads(2)


# bench.py's large-grid configuration (_bench_large_grid), which the 2048^2
# path runs
LARGE_MOM = ChebyshevMomentumConfig(degree=4)
LARGE_PRES = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                             post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8)


@pytest.mark.parametrize("name", ["simplec", "piso", "simpler"])
def test_composed_large_grid_config_matches_jax_f64(name):
    """10 outer steps at 64^2 in float64 with the large-grid configuration
    (Chebyshev momentum, one fixed V-cycle): u, v, p and the residual
    history agree with the JAX solve to rel 1e-9.  SIMPLER's history falls
    for six steps and then rises, in the JAX package as in the port (its
    pressure p_bar from one V-cycle enters unrelaxed)."""
    module, cfg, _ = ALGOS[name]
    cfg = dataclasses.replace(cfg, max_iterations=10, tolerance=0.0)
    mesh, fluid, bc = _case(64)
    solve = getattr(module, name + "_solve")
    js, jd = solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64), cfg,
                   momentum=LARGE_MOM, pressure=LARGE_PRES)
    ts, td = _port_solve(name, cfg, mom=LARGE_MOM, pres=LARGE_PRES, dtype=torch.float64, n=64)
    for field in ("u", "v", "p"):
        assert rel_err(getattr(ts, field), getattr(js, field)) < 1e-9, field
    hist = td.total_res_history.numpy()
    np.testing.assert_allclose(hist, np.asarray(jd.total_res_history), rtol=1e-9, atol=1e-300)
    turn = int(np.argmin(hist))
    if name == "simpler":
        assert 0 < turn < 9 and hist[-1] > hist[turn]
    else:
        assert turn == 9
