"""The vmapped lockstep step under the command line's remaining ``sweep
--vmap`` configurations, against the JAX package's ``batched_cavity_solve``
(one ``jax.vmap`` program of its composed step), on the CPU in float64, over
Re 100 / 400 / 1000 for 3 fixed lockstep steps from rest.

Both packages take the configurations from their own command line
(``cli._make_solvers``), two flags a run so that the four configurations
cost two JAX programs: ``--momentum rbgs --pressure mgcg`` at 31^2 with
``SCALED_BUDGET_31`` (the odd arm's red-black sweeps, composed with each
case's conductance row, beside MGCG on the path of ``--nx 511``: the 31^2
level coarsened composed, a K4 from 15^2 a solve, a K3 on the 15^2 -> 7^2
tail an application of the preconditioner) and ``--momentum jacobi
--pressure direct`` at 16^2 (the even arm's Jacobi sweeps where K8 refuses,
beside the dense direct solve: no kernel).  The kernel gates are forced
open (``torch_batch_gates.odd_gates_open``, K4's float32 admission widened
to float64).  Each takes the vmapped branch with the exact batched calls
and no ``_per_case`` step; every step's inner iterations equal case by
case; u, v, p and every history step to rel 1e-9
(``tests/test_torch_batch.py``'s limit, as
``test_torch_batch_highorder_jax.py`` states it).  (Each configuration held
bit for bit to the port's single solves in float32, the command line's
multigrid under RBGS and Jacobi and BiCGSTAB under MGCG and direct
pressure: ``test_torch_batch_cli_step.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_batch_gates import (SCALED_BUDGET_31, assembly_gates_open, gates_open,  # noqa: F401
                               loops_gates_open, odd_gates_open)

import naviflow_tpu as nf
import naviflow_tpu.algorithms.batch as jbatch
from naviflow_tpu import cli as jcli
from naviflow_tpu.algorithms import SIMPLEConfig

from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import mg
from naviflow_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(2)

STEPS = 3
RES = (100.0, 400.0, 1000.0)
# name -> (grid, the command line's flags, each kernel's batched calls a
# lockstep step; MGCG's K3 is counted from the cases' CG counts)
CASES = {
    "rbgs_mgcg31": (31, ("--momentum", "rbgs", "--pressure", "mgcg"), {"K4": 1}),
    "jacobi_direct16": (16, ("--momentum", "jacobi", "--pressure", "direct"), {}),
}


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_cli_batch_matches_jax_vmap_program(odd_gates_open, monkeypatch, name):
    """The port's vmapped branch against the JAX package's
    ``batched_cavity_solve``: the batched calls of the path, inner
    iterations equal step by step and case by case, u, v, p and every
    history step to rel 1e-9; no ``_per_case`` step."""
    calls = odd_gates_open
    n, flags, per_step = CASES[name]

    def rap(nx, ny, cfg, dtype):
        return mg.supports_fused_rap(nx, ny, cfg, torch.float32)

    monkeypatch.setattr(tmg, "supports_fused_rap", rap)
    monkeypatch.setattr(tbatch, "supports_fused_rap", rap)
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET_31)
    mom, pres = jcli._make_solvers(jcli._build_parser().parse_args(["sweep", "--vmap", *flags]))
    mesh, bc = nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    jout = jbatch.batched_cavity_solve(mesh, list(RES), bc, cfg, mom, pres, dtype=jnp.float64)
    tcfg, tmom_cfg, tpres = interop.config(cfg), interop.config(mom), interop.config(pres)
    assert tbatch.vmap_step_ok(torch.zeros(n, n, dtype=torch.float64), tcfg, tmom_cfg, tpres,
                               "simple")
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), tcfg, tmom_cfg, tpres,
                                     dtype=torch.float64, device="cpu")
    want = {}
    for k, c in per_step.items():
        want[f"{k} batched"], want[k] = c * STEPS, c * STEPS * len(RES)
    if pres.kind == "mgcg":
        counts = [[int(td.inner_iters_history[k]) + 1 for _, td in tout] for k in range(STEPS)]
        want["K3 batched"], want["K3"] = sum(map(max, counts)), sum(map(sum, counts))
    assert calls == want
    for (js, jd), (ts, td) in zip(jout, tout):
        assert int(jd.iterations) == td.iterations == STEPS
        assert np.asarray(jd.inner_iters_history)[:STEPS].tolist() == \
            td.inner_iters_history[:STEPS].tolist()
        for field in ("u", "v", "p"):
            assert rel_err(getattr(ts, field), getattr(js, field)) <= 1e-9, field
        np.testing.assert_allclose(td.total_res_history.numpy(),
                                   np.asarray(jd.total_res_history), rtol=1e-9)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)
