"""``batched_cavity_solve`` (the lockstep loop of
``algorithms/base.run_outer_loop_batched``) at 31^2 in float64 against the
JAX package's ``jax.vmap`` program and the port's single solves, on the CPU
(``tests/test_torch_batch_fused.py``'s part (b), a file of its own so that
the test workers share the long runs)."""

import jax.numpy as jnp
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, batched_cavity_solve
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop

from test_torch_batch_fused import rel_err

torch.set_num_threads(2)


def test_batched_solve_matches_jax_vmap_and_single_solves():
    """``batched_cavity_solve`` at 31^2, Re 100 / 400 / 1000, to 1e-4 in
    float64 (multigrid pressure to 1e-3): each case's iterations equal the
    JAX package's ``jax.vmap`` program's and the port's single solve's, its
    fields within rel 1e-9 of the JAX package's
    (tests/test_torch_batch.py::test_batched_matches_jax_vmap's limit) and
    bit-equal to the single solve's, and its histories untouched past its
    count."""
    mesh = nf.StructuredMesh(nx=31, ny=31)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=400, tolerance=1e-4)
    mom = KrylovMomentumConfig(tolerance=1e-10, max_iterations=100)
    pres = MultigridConfig(tolerance=1e-3, max_cycles=20)
    res = [100.0, 400.0, 1000.0]
    jout = batched_cavity_solve(mesh, res, bc, cfg, mom, pres, dtype=jnp.float64)
    tm, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    tcfg, tmom, tpres = interop.config(cfg), interop.config(mom), interop.config(pres)
    tout = talg.batched_cavity_solve(tm, res, tbc, tcfg, tmom, tpres, dtype=torch.float64,
                                     device="cpu")
    iters = []
    for re_, (js, jd), (ts, td) in zip(res, jout, tout):
        assert bool(jd.converged) and td.converged
        assert td.iterations == int(jd.iterations)
        for name in ("u", "v", "p"):
            assert rel_err(getattr(ts, name).numpy(), getattr(js, name)) <= 1e-9, name
        ss, sd = talg.simple_solve(tm, nt.FluidProperties(density=1.0, reynolds_number=re_),
                                   tbc, nt.initialize_state(tm, tbc, dtype=torch.float64,
                                                            device="cpu"),
                                   tcfg, momentum=tmom, pressure=tpres, loop="fused")
        assert sd.iterations == td.iterations
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(ts, name), getattr(ss, name)), name
        for name in ("u_res_history", "v_res_history", "p_res_history", "total_res_history",
                     "inner_iters_history", "u_residual_field", "p_residual_field"):
            assert torch.equal(getattr(td, name), getattr(sd, name)), name
            if name.endswith("history"):
                assert not getattr(td, name)[td.iterations:].any(), name
        assert torch.equal(td.final_residual, sd.final_residual)
        iters.append(td.iterations)
    assert len(set(iters)) == 3
