"""The JAX package's QUICK Newton case (``tests/test_newton.py``: 31^2,
Re=400, 60 SIMPLE steps of QUICK warm start, Newton to 1e-9) through the
port's ``newton_solve`` from the same warm start, on the CPU in f64: the
same Newton and GMRES iteration counts, histories to rel 1e-6 above 1e-9,
final fields to 1e-9, and a falling history.  The JAX package's Newton
solve runs in a spawned process beside the port's
(``test_torch_newton.jax_newton_beside``)."""

import numpy as np
import torch

from naviflow_tpu.algorithms import NewtonConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import newton as tn

from test_torch_newton import _port, _warm, jax_newton_beside

torch.set_num_threads(2)


def test_quick_newton_matches_jax():
    mesh, fluid, bc, warm = _warm(re=400.0, steps=60, scheme="quick")
    cfg = NewtonConfig(tolerance=1e-9, scheme="quick", max_newton=25)
    jax_run = jax_newton_beside(31, 400.0, warm, cfg)
    ft, dt = tn.newton_solve(*_port(mesh, fluid, bc, warm), interop.config(cfg))
    dj = jax_run.result()
    assert dj["converged"] and dt.converged
    assert dt.iterations == dj["iterations"] and dt.gmres_iterations == dj["gmres_iterations"]
    hj, ht = dj["residual_history"], np.asarray(dt.residual_history)
    above = hj > 1e-9
    np.testing.assert_allclose(ht[above], hj[above], rtol=1e-6)
    assert ht[-1] < ht[0]
    for name in ("u", "v", "p"):
        assert float(np.max(np.abs(getattr(ft, name).numpy() - dj[name]))) <= 1e-9, name
    assert bool(torch.isfinite(ft.u).all()) and float(np.max(np.abs(dj["u"]))) > 0.5
