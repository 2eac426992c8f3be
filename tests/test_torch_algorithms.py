"""SIMPLEC, PISO and SIMPLER in the PyTorch port against the JAX package, on
the CPU: the composed solves in float64 (``test_torch_step_bodies.py``
holds their whole-step kernel bodies).

The configurations are the bench's 63^2 headline one (BiCGSTAB momentum to
1e-6 in at most 20 iterations; multigrid V-cycles to 1e-2, at most 6,
checked every 2, 8 coarsest sweeps, coarse operators rebuilt every 8
steps), at 31^2, and its large-grid one, at 64^2
(``tests/test_torch_algorithms_large.py``, a file of its own so that the
test workers share the long runs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import piso as jpiso
from naviflow_tpu.algorithms import simplec as jsimplec
from naviflow_tpu.algorithms import simpler as jsimpler
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 31
MOM = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
PRES = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="v", check_every=2,
                       coarsest_sweeps=8, coarse_rebuild_every=8)

# algo -> (JAX module, JAX config, port solve)
ALGOS = {
    "simplec": (jsimplec, jsimplec.SIMPLECConfig(), talg.simplec_solve),
    "piso": (jpiso, jpiso.PISOConfig(), talg.piso_solve),
    "piso_exact": (jpiso, jpiso.PISOConfig(corrector="exact"), talg.piso_solve),
    "simpler": (jsimpler, jsimpler.SIMPLERConfig(), talg.simpler_solve),
}


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _case(n=N):
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    return mesh, fluid, bc


def _port_solve(name, cfg, mom=MOM, pres=PRES, dtype=torch.float32, n=N):
    mesh, fluid, bc = _case(n)
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    return ALGOS[name][2](tmesh, interop.fluid(fluid), tbc,
                          nt.initialize_state(tmesh, tbc, dtype=dtype, device="cpu"),
                          interop.config(cfg), momentum=interop.config(mom),
                          pressure=interop.config(pres))


@pytest.mark.parametrize("name", list(ALGOS))
def test_composed_solve_matches_jax_f64(name):
    """10 outer steps at 31^2 in float64 (the lagged coarse refresh runs at
    steps 0 and 8): final u, v, p, the residual histories and the inner
    cycle counts agree with the JAX solve to rel 1e-9.  PISO's exact
    corrector runs 3: its residual grows about tenfold in 10 steps (the
    unstable scheme PISOConfig documents), and with it the two packages'
    summation-order differences, by ~30x a step."""
    module, cfg, _ = ALGOS[name]
    steps = 3 if name == "piso_exact" else 10
    cfg = dataclasses.replace(cfg, max_iterations=steps, tolerance=0.0)
    mesh, fluid, bc = _case()
    solve = getattr(module, name.split("_")[0] + "_solve")
    js, jd = solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64), cfg,
                   momentum=MOM, pressure=PRES)
    ts, td = _port_solve(name, cfg, dtype=torch.float64)
    assert td.iterations == int(jd.iterations) == steps
    for field in ("u", "v", "p"):
        assert rel_err(getattr(ts, field), getattr(js, field)) < 1e-9, field
    for hist in ("u_res_history", "v_res_history", "p_res_history", "total_res_history"):
        np.testing.assert_allclose(getattr(td, hist).numpy(), np.asarray(getattr(jd, hist)),
                                   rtol=1e-9, atol=1e-300, err_msg=hist)
    np.testing.assert_array_equal(td.inner_iters_history.numpy(),
                                  np.asarray(jd.inner_iters_history))
