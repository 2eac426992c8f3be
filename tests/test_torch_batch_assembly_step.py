"""The vmapped step of ``algorithms/batch.py`` through K8, K9 and K10 (its
even arm's SIMPLEC / PISO / SIMPLER, Jacobi-momentum SIMPLE and plane
layout), on the CPU.

The kernel gates are forced open and scaled down
(``torch_batch_gates.assembly_gates_open``) so that a 64^2 grid takes the
path a 2048^2 one takes on the card (K8, K9 where Chebyshev momentum runs,
two strip levels and a K3 tail a pressure solve) and, in the plane
layout, the 4096^2 one (K10 on the 64^2 planes, a strip level and a K3
tail below).  (a) In float32 each case of the batch bit-equal to its
single solve, with the exact batched calls and no per-case step.  (c) A
frozen case in the lockstep step.  (d) The configurations that stay case
by case.  ((b), SIMPLEC and the plane layout in float64 against the JAX
package's ``batched_cavity_solve``: ``test_torch_batch_assembly_jax.py``
and ``test_torch_batch_plane_jax.py``.)
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_batch_gates import (MOM, N, PLANE, PRES, RES, STEPS, assembly_gates_open,  # noqa: F401
                               batched_calls, gates_open)

from naviflow_tpu.solvers import JacobiMomentumConfig as JJacobi

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.algorithms.simplec import make_simplec_step, simplec_carry0
from naviflow_tpu_torch.ops import assembly, cheby, plane_strip
from naviflow_tpu_torch.solvers import momentum as tmom

torch.set_num_threads(2)

# kind -> (algorithm, JAX momentum, JAX pressure, batched calls a lockstep step)
RUNS = {
    "simplec": ("simplec", MOM, PRES, {"K8": 1, "K9": 2, "K2a": 2, "K2b": 2, "K3": 1}),
    "piso": ("piso", MOM, PRES, {"K8": 2, "K9": 2, "K2a": 4, "K2b": 4, "K3": 2}),
    "simpler": ("simpler", MOM, PRES, {"K8": 2, "K9": 4, "K2a": 4, "K2b": 4, "K3": 2}),
    "simple_jacobi": ("simple", JJacobi(n_sweeps=2), PRES, {"K8": 1, "K2a": 2, "K2b": 2,
                                                            "K3": 1}),
    "simple_plane": ("simple", MOM, PLANE, {"K8": 1, "K9": 2, "K10a": 1, "K10b": 1, "K2a": 1,
                                            "K2b": 1, "K3": 1}),
}


def _solve(algo):
    return getattr(talg, f"{algo}_solve")


@pytest.mark.parametrize("kind", list(RUNS))
def test_assembly_batch_cases_bit_equal_to_single_solves(assembly_gates_open, kind):
    """In float32 at 64^2, Re 100 / 400 / 1000, 10 lockstep steps (a
    composed coarse rebuild at step 8): ``vmap_step_ok`` admits the
    configuration, each lockstep step makes exactly its batched K8, K9,
    K10 and K2 / K3 calls (and their plain calls a case) and no per-case
    step; every case bit-equal to its single solve (state, histories,
    residual fields)."""
    calls = assembly_gates_open
    algo, jmom, jpres, per_step = RUNS[kind]
    mesh, bc = nt.StructuredMesh(nx=N, ny=N), nt.lid_driven_cavity(1.0)
    cfg = getattr(talg, f"{algo.upper()}Config")(max_iterations=STEPS, tolerance=0.0)
    mom, pres = interop.config(jmom), interop.config(jpres)
    assert tbatch.vmap_step_ok(torch.zeros(N, N), cfg, mom, pres, algo)
    calls.clear()
    out = talg.batched_cavity_solve(mesh, list(RES), bc, cfg, mom, pres, algorithm=algo,
                                    device="cpu")
    assert calls == batched_calls(per_step, STEPS)
    for re_, (bs, bd) in zip(RES, out):
        calls.clear()
        ss, sd = _solve(algo)(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc,
                              nt.initialize_state(mesh, bc, device="cpu"), cfg, momentum=mom,
                              pressure=pres, loop="fused")
        assert calls == {k: c * STEPS for k, c in per_step.items()}
        assert bd.iterations == sd.iterations == STEPS
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), (re_, name)
        for name in ("total_res_history", "inner_iters_history", "u_residual_field",
                     "p_residual_field"):
            assert torch.equal(getattr(bd, name), getattr(sd, name)), (re_, name)
    assert not torch.equal(out[0][0].u, out[2][0].u)
    assert (assembly.LAUNCHES, assembly.BATCH_LAUNCHES, cheby.LAUNCHES, cheby.BATCH_LAUNCHES,
            plane_strip.DOWN_BATCH_LAUNCHES, plane_strip.UP_BATCH_LAUNCHES) == (0,) * 6


def test_assembly_step_frozen_case(assembly_gates_open):
    """A SIMPLEC lockstep step with a frozen case (``batch._vmapped_step``,
    the K8 / K9 path): the frozen case gets back its state, carry and info,
    its plain calls are skipped (two of three cases in each batched call),
    and each active case is its single step's."""
    calls = assembly_gates_open
    mesh, bc = nt.StructuredMesh(nx=N, ny=N), nt.lid_driven_cavity(1.0)
    cfg, mom, pres = talg.SIMPLECConfig(), interop.config(MOM), interop.config(PRES)
    dx, dy = mesh.get_cell_sizes()
    common = dict(dx=dx, dy=dy, rho=1.0, bc=bc, cfg=cfg, mom_cfg=mom, pres_cfg=pres)
    extra0_fn, _ = talg.simple.lagged_extra0(mesh, pres, cfg, dx, dy, 1.0, simplec_carry0(cfg))
    leaves, build = tbatch._flatten(extra0_fn(torch.float32, "cpu"))
    extra = build([x.expand(3, *x.shape) for x in leaves])
    rng = np.random.default_rng(5)
    s = nt.initialize_state(mesh, bc, device="cpu")
    u, v, p = (torch.stack([x + torch.as_tensor(0.01 * rng.normal(size=x.shape),
                                                dtype=torch.float32) for _ in RES])
               for x in (s.u, s.v, s.p))
    visc = tbatch.case_conductances([1.0 / r for r in RES], dx, dy, torch.float32)
    z = torch.zeros(3)
    info = talg.base.StepInfo(z, z, z, torch.zeros(3, dtype=torch.int32), torch.zeros_like(u),
                              torch.zeros_like(v), torch.zeros_like(p))
    step = tbatch._vmapped_step(make_simplec_step, dict(common, coarse_mode="rebuild"), visc)
    full = step(u, v, p, extra, torch.ones(3, dtype=torch.bool), info)
    calls.clear()
    frozen = step(u, v, p, extra, torch.tensor([True, False, True]), info)
    assert calls["K8 batched"] == 1 and calls["K8"] == 2 and calls["K9"] == 4
    assert calls["K2a"] == 4 and calls["K3"] == 2
    for k in range(3):
        assert torch.equal(frozen[k][1], (u, v, p)[k][1])
        assert torch.equal(frozen[k][0], full[k][0]) and torch.equal(frozen[k][2], full[k][2])
    for g, w in zip(tbatch._flatten(frozen[3])[0], tbatch._flatten(extra)[0]):
        assert torch.equal(g[1], w[1])
    for g, w in zip(frozen[4], info):
        assert torch.equal(g[1], w[1])
    for k in (0, 2):
        one = make_simplec_step(**dict(common, coarse_mode="rebuild"), mu=1.0 / RES[k])
        want = one(u[k], v[k], p[k], extra0_fn(torch.float32, "cpu"))
        for i in range(3):
            assert torch.equal(frozen[i][k], want[i]), (k, i)


def test_per_case_configurations_stay_refused(assembly_gates_open, monkeypatch):
    """With every gate open, the configurations the vmapped branch still
    refuses stay case by case: GMRES momentum (its restart loop reads the
    host), BiCGSTAB with the compensated dots, the compensated residual, W
    cycles (with or without a pressure tolerance); a refused batch takes
    ``_per_case`` and no batched call.  (BiCGSTAB momentum and a pressure
    tolerance run through ``ops/while_loop.py`` since its port:
    ``test_torch_batch_loops_step.py``.)"""
    calls = assembly_gates_open
    cfg = talg.SIMPLECConfig(max_iterations=2, tolerance=0.0)
    mom, pres = interop.config(MOM), interop.config(PRES)
    p = torch.zeros(N, N)
    assert tbatch.vmap_step_ok(p, cfg, mom, pres, "simplec")
    for m, pr in ((tmom.GMRESMomentumConfig(tolerance=1e-6, max_iterations=5), pres),
                  (tmom.KrylovMomentumConfig(tolerance=1e-6, max_iterations=5,
                                             compensated_dots=True), pres),
                  (mom, dataclasses.replace(pres, tolerance=1e-3, cycle_type="w")),
                  (dataclasses.replace(mom, compensated_residual=True), pres),
                  (mom, dataclasses.replace(pres, cycle_type="w"))):
        assert not tbatch.vmap_step_ok(p, cfg, m, pr, "simplec"), (m, pr)
    mesh, bc = nt.StructuredMesh(nx=N, ny=N), nt.lid_driven_cavity(1.0)
    calls.clear()
    talg.batched_cavity_solve(mesh, list(RES), bc, cfg,
                              tmom.GMRESMomentumConfig(tolerance=1e-6, max_iterations=5),
                              pres, algorithm="simplec", device="cpu")
    assert calls["per case"] >= 1 and not any(k.endswith("batched") for k in calls)
