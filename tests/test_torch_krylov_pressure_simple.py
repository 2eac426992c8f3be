"""One SIMPLE solve per new pressure kind of the port's pressure-solver
zoo (CG, BiCGSTAB, GMRES, MGCG, Jacobi, direct) against the JAX package on
the CPU (f64): the same outer and inner iterations, fields to 1e-9.  (The
solvers themselves: ``tests/test_torch_krylov_pressure.py``; a file of its
own so that the test workers share the long runs.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import krylov as jk
from naviflow_tpu.solvers import pressure as jp
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve

from test_torch_krylov_pressure import rel_err

torch.set_num_threads(2)


SIMPLE_PRESSURES = {
    "cg": jk.CGPressureConfig(tolerance=1e-6, max_iterations=300),
    "bicgstab": jk.BiCGSTABPressureConfig(tolerance=1e-2, max_iterations=300),
    "gmres": jk.GMRESPressureConfig(tolerance=1e-6, max_iterations=300, restart=10),
    "mgcg": jk.MGCGPressureConfig(tolerance=1e-6, max_iterations=50,
                                  mg=JMG(pre_smoothing=2, post_smoothing=2, coarsest_sweeps=16)),
    "jacobi": jp.JacobiPressureConfig(tolerance=1e-4, max_iterations=5000, check_every=5),
    "direct": jp.DirectPressureConfig(),
}


@pytest.mark.parametrize("kind", list(SIMPLE_PRESSURES))
def test_simple_with_each_new_pressure_kind(kind):
    """SIMPLE at 16^2, Re=10, to 1e-3: the same outer and inner iterations
    as the JAX package, fields to 1e-9."""
    n = 16
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=10)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=400, tolerance=1e-3)
    pres = SIMPLE_PRESSURES[kind]
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                          cfg, pressure=pres)
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    ts, td = t_simple_solve(tmesh, interop.fluid(fluid), tbc,
                            nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu"),
                            interop.config(cfg), pressure=interop.config(pres))
    assert td.iterations == int(jd.iterations) < cfg.max_iterations
    assert bool(td.converged)
    k = td.iterations
    np.testing.assert_array_equal(td.inner_iters_history.numpy()[:k],
                                  np.asarray(jd.inner_iters_history)[:k])
    for name in ("u", "v", "p"):
        assert rel_err(getattr(ts, name), getattr(js, name)) < 1e-9, name
