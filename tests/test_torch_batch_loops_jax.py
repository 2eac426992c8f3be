"""The vmapped lockstep step with the loops that read the host
(``ops/while_loop.py``) against the JAX package's ``batched_cavity_solve``
(one ``jax.vmap`` program of its ``lax.while_loop`` s), on the CPU in
float64.

The command line's default solvers (BiCGSTAB momentum to 1e-6, multigrid
pressure to 1e-3) at 32^2 with the gates forced open and K7's shut
(``torch_batch_gates``: the path of 1024^2 on the card, K8's coefficients,
the pair loop, a K2 pair and a K3 tail a cycle until the tolerance) over Re
100 / 400 / 1000 for 4 fixed lockstep steps: each step's pressure cycles
equal case by case, no ``_per_case`` step; u, v, p and every history step
to rel 1e-9 (``tests/test_torch_batch.py``'s limit) at Re 100 and 400.  At
Re 1000 the BiCGSTAB solves of this configuration converge erratically:
the JAX package's own ``vmap`` program sits a gap ``g`` (some 1e-8, above
1e-9) from its single ``simple_solve``, and the port's case is held to 4 g
of the ``vmap`` program (the batch is held bit for bit to the port's
single solves in float32 in ``test_torch_batch_loops_step.py``).
"""

import jax.numpy as jnp
import numpy as np
import torch
from torch_batch_gates import (assembly_gates_open, close_k7, gates_open,  # noqa: F401
                               loops_gates_open)

import naviflow_tpu as nf
import naviflow_tpu.algorithms.batch as jbatch
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import KrylovMomentumConfig, MultigridConfig

from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch

torch.set_num_threads(2)

N, STEPS = 32, 4
RES = (100.0, 400.0, 1000.0)
# the command line's default solvers (naviflow_tpu/cli.py _make_solvers)
MOM = KrylovMomentumConfig(tolerance=1e-6, max_iterations=60)
PRES = MultigridConfig(tolerance=1e-3, max_cycles=30)


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def test_cli_default_batch_matches_jax_vmap_program(loops_gates_open, monkeypatch):
    """The command line's default at 32^2 (1024^2's path), float64, Re 100 /
    400 / 1000: the port's vmapped branch against the JAX package's
    ``batched_cavity_solve``, every step's pressure cycles equal case by
    case (and not all equal), one batched K8 call a step and a batched K2
    pair and K3 a cycle of the slowest case; u, v, p and every history step
    to rel 1e-9 at Re 100 and 400, and at Re 1000 within 4 g, where g
    (> 1e-9) is the JAX ``vmap`` program's gap from the JAX single solve."""
    calls = loops_gates_open
    close_k7(monkeypatch)
    mesh, bc = nf.StructuredMesh(nx=N, ny=N), nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    jout = jbatch.batched_cavity_solve(mesh, list(RES), bc, cfg, MOM, PRES, dtype=jnp.float64)
    tcfg, tmom_cfg, tpres = interop.config(cfg), interop.config(MOM), interop.config(PRES)
    assert tbatch.vmap_step_ok(torch.zeros(N, N, dtype=torch.float64), tcfg, tmom_cfg, tpres,
                               "simple")
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), tcfg, tmom_cfg, tpres,
                                     dtype=torch.float64, device="cpu")
    cycles = [[int(td.inner_iters_history[k]) for _, td in tout] for k in range(STEPS)]
    lock = sum(max(c) for c in cycles)
    assert calls == {"K8 batched": STEPS, "K8": 3 * STEPS, "K2a batched": lock,
                     "K2a": sum(map(sum, cycles)), "K2b batched": lock,
                     "K2b": sum(map(sum, cycles)), "K3 batched": lock,
                     "K3": sum(map(sum, cycles))}
    assert len({c for step in cycles for c in step}) > 1
    # Re 1000: the JAX vmap program's case against the JAX single solve
    single, _ = simple_solve(mesh, nf.FluidProperties(density=1.0, reynolds_number=RES[2]), bc,
                             nf.initialize_state(mesh, bc, dtype=jnp.float64), cfg,
                             momentum=MOM, pressure=PRES)
    gap = max(rel_err(torch.as_tensor(np.asarray(getattr(jout[2][0], k))), getattr(single, k))
              for k in ("u", "v", "p"))
    assert gap > 1e-9
    for k, ((js, jd), (ts, td)) in enumerate(zip(jout, tout)):
        limit = 1e-9 if k < 2 else 4 * gap
        assert int(jd.iterations) == td.iterations == STEPS
        assert np.asarray(jd.inner_iters_history)[:STEPS].tolist() == \
            td.inner_iters_history[:STEPS].tolist()
        for name in ("u", "v", "p"):
            assert rel_err(getattr(ts, name), getattr(js, name)) <= limit, name
        np.testing.assert_allclose(td.total_res_history.numpy(),
                                   np.asarray(jd.total_res_history), rtol=limit)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)
