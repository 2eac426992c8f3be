"""The port's case batching (``algorithms/batch.py``) on the CPU (f64):
each case equals its single-device solve bit for bit, and the cases match
the JAX package's ``batched_cavity_solve`` (one ``jax.vmap`` program) at
31^2, Re 100 / 400, as ``tests/test_algorithms.py`` runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, batched_cavity_solve
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop

torch.set_num_threads(2)

MOM = KrylovMomentumConfig(tolerance=1e-10, max_iterations=100)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


@pytest.mark.parametrize("algorithm", ["simple", "simplec"])
def test_batched_equals_individual_bit_for_bit(algorithm):
    mesh = nt.StructuredMesh(nx=15, ny=15)
    bc = nt.lid_driven_cavity(1.0)
    cfg_cls = {"simple": talg.SIMPLEConfig, "simplec": talg.SIMPLECConfig}[algorithm]
    solve = {"simple": talg.simple_solve, "simplec": talg.simplec_solve}[algorithm]
    cfg = cfg_cls(max_iterations=300, tolerance=1e-3)
    mom, pres = interop.config(MOM), nt.solvers.MultigridConfig(tolerance=1e-3, max_cycles=20)
    res = [100.0, 400.0]
    out = talg.batched_cavity_solve(mesh, res, bc, cfg, mom, pres, algorithm=algorithm,
                                    dtype=torch.float64, device="cpu")
    iters = []
    for re, (bs, bd) in zip(res, out):
        fluid = nt.FluidProperties(density=1.0, reynolds_number=re)
        state = nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu")
        ss, sd = solve(mesh, fluid, bc, state, cfg, momentum=mom, pressure=pres, loop="fused")
        assert bd.iterations == sd.iterations and bool(bd.converged)
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), name
        assert torch.equal(bd.total_res_history, sd.total_res_history)
        iters.append(bd.iterations)
    assert iters[0] != iters[1]


def test_batched_matches_jax_vmap():
    """``tests/test_algorithms.py``'s batched case: 31^2, Re 100 and 400 to
    1e-5, multigrid pressure to 1e-3: the same iterations per case, fields
    to rel 1e-9."""
    mesh = nf.StructuredMesh(nx=31, ny=31)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=800, tolerance=1e-5)
    pres = MultigridConfig(tolerance=1e-3, max_cycles=20)
    res = [100.0, 400.0]
    jout = batched_cavity_solve(mesh, res, bc, cfg, MOM, pres, algorithm="simple",
                                dtype=jnp.float64)
    tout = talg.batched_cavity_solve(interop.mesh(mesh), res, interop.boundary_conditions(bc),
                                     interop.config(cfg), interop.config(MOM),
                                     interop.config(pres), dtype=torch.float64, device="cpu")
    for (js, jd), (ts, td) in zip(jout, tout):
        assert bool(jd.converged) and bool(td.converged)
        assert int(jd.iterations) == td.iterations
        for name in ("u", "v", "p"):
            assert _rel(getattr(ts, name).numpy(), getattr(js, name)) <= 1e-9, name
    assert tout[0][1].iterations != tout[1][1].iterations


def test_batch_device_and_algorithm():
    mesh = nt.StructuredMesh(nx=7, ny=7)
    bc = nt.lid_driven_cavity(1.0)
    cfg = talg.SIMPLEConfig(max_iterations=2, tolerance=0.0)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        talg.batched_cavity_solve(mesh, [100.0], bc, cfg, None, None, algorithm="nope",
                                  device="cpu")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            talg.batched_cavity_solve(mesh, [100.0], bc, cfg, nt.solvers.JacobiMomentumConfig(),
                                      nt.solvers.RBGSPressureConfig())
