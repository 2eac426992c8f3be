"""The vmapped lockstep step with 9-point momentum and on odd grids whose
whole pressure solve K5 cannot take, against the JAX package's
``batched_cavity_solve`` (one ``jax.vmap`` program of its composed step), on
the CPU in float64, over Re 100 / 400 / 1000 for 3 fixed lockstep steps from
rest, with the command line's multigrid pressure (to 1e-3 in at most 30
cycles) and QUICK BiCGSTAB momentum to 1e-9 (``MOM``).

The kernel gates are forced open (``torch_batch_gates.loops_gates_open``,
K4's float32 admission widened to float64 and K8's own gate back): (a)
``sweep --vmap --scheme quick`` at 31^2 (the default 63^2's path: the
9-point momentum composed, a batched K4 and K5 a step); (b) the same at
63^2 with the multigrid budget scaled down so that it takes ``sweep
--vmap --nx 511 --scheme quick``'s path (the 63^2 -> 31^2 level composed,
a batched K4 from the 9-point 31^2 level, a batched K3 a cycle of the
slowest case on the tail).  Each takes the vmapped branch with no
``_per_case`` step; every step's inner iterations equal case by case; u, v,
p and every history step to rel 1e-9 (``tests/test_torch_batch.py``'s
limit).  (The batch held bit for bit to the port's single solves in float32:
``test_torch_batch_highorder_step.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_batch_gates import (SCALED_BUDGET, _count, assembly_gates_open,  # noqa: F401
                               gates_open, loops_gates_open)

import naviflow_tpu as nf
import naviflow_tpu.algorithms.batch as jbatch
from naviflow_tpu.algorithms import SIMPLEConfig
from naviflow_tpu.solvers import KrylovMomentumConfig, MultigridConfig

from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import assembly, mg
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(2)

STEPS = 3
RES = (100.0, 400.0, 1000.0)
# QUICK momentum as the JAX package's QUICK tests solve it (BiCGSTAB to
# 1e-9 in at most 150 iterations), the command line's multigrid pressure.
# The command line's BiCGSTAB to 1e-6 stops where a rounding apart moves
# the fields: there the JAX package's own vmap program sits 2.5e-8 (Re 400)
# and 3.5e-7 (Re 1000) from its single solves after 3 steps at 31^2, and the
# port's single solve as far from either
MOM = KrylovMomentumConfig(tolerance=1e-9, max_iterations=150, scheme="quick")
PRES = MultigridConfig(tolerance=1e-3, max_cycles=30)


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


@pytest.fixture
def f64_gates_open(loops_gates_open, monkeypatch):
    """``loops_gates_open`` with K4's gate widened to float64 (the JAX
    package's precision), K8's own gate back and K4's plain calls
    counted."""
    calls = loops_gates_open

    def rap(nx, ny, cfg, dtype):
        return mg.supports_fused_rap(nx, ny, cfg, torch.float32)

    monkeypatch.setattr(tmg, "supports_fused_rap", rap)
    monkeypatch.setattr(tbatch, "supports_fused_rap", rap)
    monkeypatch.setattr(tmom, "supports_fused_assembly", assembly.supports_fused_assembly)
    monkeypatch.setattr(tbatch, "supports_fused_assembly", assembly.supports_fused_assembly)
    for key, fn in (("K4 batched", "galerkin_levels_batched_plain"),
                    ("K4", "galerkin_levels_plain")):
        _count(monkeypatch, calls, mg, fn, key)
    return calls


@pytest.mark.parametrize("n", [31, 63], ids=["quick31_k5", "quick63_without_k5"])
def test_highorder_batch_matches_jax_vmap_program(f64_gates_open, monkeypatch, n):
    """The port's vmapped branch against the JAX package's
    ``batched_cavity_solve``: the batched calls of the path (31^2: K4 and
    K5 a step; 63^2 scaled: K4 a step and K3 a cycle of the slowest case),
    inner iterations equal step by step and case by case, u, v, p and
    every history step to rel 1e-9; no ``_per_case`` step."""
    calls = f64_gates_open
    if n == 63:
        monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    mesh, bc = nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    jout = jbatch.batched_cavity_solve(mesh, list(RES), bc, cfg, MOM, PRES, dtype=jnp.float64)
    tcfg, tmom_cfg, tpres = interop.config(cfg), interop.config(MOM), interop.config(PRES)
    assert tbatch.vmap_step_ok(torch.zeros(n, n, dtype=torch.float64), tcfg, tmom_cfg, tpres,
                               "simple")
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), tcfg, tmom_cfg, tpres,
                                     dtype=torch.float64, device="cpu")
    cycles = [[int(td.inner_iters_history[k]) for _, td in tout] for k in range(STEPS)]
    want = {"K4 batched": STEPS, "K4": 3 * STEPS}
    if n == 31:
        want.update({"K5 batched": STEPS, "K5": 3 * STEPS})
    else:
        want.update({"K3 batched": sum(max(c) for c in cycles), "K3": sum(map(sum, cycles))})
    assert calls == want
    for (js, jd), (ts, td) in zip(jout, tout):
        assert int(jd.iterations) == td.iterations == STEPS
        assert np.asarray(jd.inner_iters_history)[:STEPS].tolist() == \
            td.inner_iters_history[:STEPS].tolist()
        for name in ("u", "v", "p"):
            assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-9, name
        np.testing.assert_allclose(td.total_res_history.numpy(),
                                   np.asarray(jd.total_res_history), rtol=1e-9)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)
