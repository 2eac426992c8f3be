"""The vmapped lockstep step with the Krylov loops against the JAX
package's ``batched_cavity_solve`` (one ``jax.vmap`` program of its
``lax.while_loop`` s), on the CPU in float64, at 32^2 over Re 100 / 400 /
1000 for 3 fixed lockstep steps from rest.

(a) The command line's ``sweep --vmap --pressure mgcg`` (BiCGSTAB momentum
to 1e-6, MGCG to 1e-3) with the gates forced open and K7's shut
(``torch_batch_gates``: 1024^2's path, K8's coefficients, the pair loop,
a K2 pair above a K3 tail an application of the preconditioner); (b) IDR(s)
momentum (the JAX package's shadow space) with GMRES pressure, composed.
Each takes the vmapped branch with no ``_per_case`` step; every step's
inner iterations equal case by case; u, v, p and every history step to rel
1e-9 (``tests/test_torch_batch.py``'s limit), or, where the JAX ``vmap``
program itself sits a gap ``g`` above 1e-9 from its single solve (a loop
that amplifies rounding), within 4 g of it
(``test_torch_batch_loops_jax.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_batch_gates import (assembly_gates_open, close_k7, gates_open,  # noqa: F401
                               loops_gates_open)

import naviflow_tpu as nf
import naviflow_tpu.algorithms.batch as jbatch
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import (GMRESPressureConfig, IDRSMomentumConfig, KrylovMomentumConfig,
                                  MGCGPressureConfig)

from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.solvers import momentum as tmomentum

torch.set_num_threads(2)

N, STEPS = 32, 3
RES = (100.0, 400.0, 1000.0)
CONFIGS = {
    "mgcg": (KrylovMomentumConfig(tolerance=1e-6, max_iterations=60),
             MGCGPressureConfig(tolerance=1e-3, max_iterations=100)),
    "idrs_gmres": (IDRSMomentumConfig(tolerance=1e-6),
                   GMRESPressureConfig(tolerance=1e-3, max_iterations=5000)),
}


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _gap(ts, td, js, jd):
    return max(*(rel_err(getattr(ts, k).numpy(), getattr(js, k)) for k in ("u", "v", "p")),
               *(rel_err(td.total_res_history[k].numpy(), np.asarray(jd.total_res_history)[k])
                 for k in range(STEPS)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_krylov_batch_matches_jax_vmap_program(loops_gates_open, monkeypatch, name):
    """The port's vmapped branch against the JAX package's
    ``batched_cavity_solve``: inner iterations equal step by step and case
    by case (and not all equal), u, v, p and every history step to rel
    1e-9 or within 4 g; no ``_per_case`` step."""
    calls = loops_gates_open
    close_k7(monkeypatch)
    mom, pres = CONFIGS[name]
    if name == "idrs_gmres":  # the JAX package's shadow spaces (u's, v's), each drawn once
        spaces = {}

        def jax_space(s, shape, dtype, device):
            key = (s,) + tuple(shape)
            if key not in spaces:
                spaces[key] = torch.tensor(np.asarray(
                    jax.random.normal(jax.random.PRNGKey(0), key, jnp.float64)))
            return spaces[key]

        monkeypatch.setattr(tmomentum, "idrs_shadow_space", jax_space)
        monkeypatch.setattr(tbatch, "idrs_shadow_space", jax_space)
    mesh, bc = nf.StructuredMesh(nx=N, ny=N), nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    jout = jbatch.batched_cavity_solve(mesh, list(RES), bc, cfg, mom, pres, dtype=jnp.float64)
    tcfg, tmom, tpres = interop.config(cfg), interop.config(mom), interop.config(pres)
    assert tbatch.vmap_step_ok(torch.zeros(N, N, dtype=torch.float64), tcfg, tmom, tpres,
                               "simple")
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), tcfg, tmom, tpres,
                                     dtype=torch.float64, device="cpu")
    assert "per case" not in calls and calls["K8 batched"] == STEPS
    inner = [[int(td.inner_iters_history[k]) for _, td in tout] for k in range(STEPS)]
    assert len({c for step in inner for c in step}) > 1
    for b, ((js, jd), (ts, td)) in enumerate(zip(jout, tout)):
        assert int(jd.iterations) == td.iterations == STEPS
        assert np.asarray(jd.inner_iters_history)[:STEPS].tolist() == \
            td.inner_iters_history[:STEPS].tolist()
        gap = _gap(ts, td, js, jd)
        if gap <= 1e-9:
            continue
        # the JAX vmap program's case against the JAX single solve
        single, sd = simple_solve(mesh, nf.FluidProperties(density=1.0, reynolds_number=RES[b]),
                                  bc, nf.initialize_state(mesh, bc, dtype=jnp.float64), cfg,
                                  momentum=mom, pressure=pres)
        g = max(*(rel_err(getattr(js, k), getattr(single, k)) for k in ("u", "v", "p")),
                *(rel_err(np.asarray(jd.total_res_history)[k], np.asarray(sd.total_res_history)[k])
                  for k in range(STEPS)))
        assert g > 1e-9, (name, b, gap)
        assert gap <= 4 * g, (name, b, gap, g)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)
