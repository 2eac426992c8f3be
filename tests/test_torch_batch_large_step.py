"""The vmapped large-grid step of ``algorithms/batch.py`` (its even arm: K1,
K2a, K2b and K3 through their batching rules), on the CPU.

The kernel gates are forced open and scaled down (``torch_batch_gates``)
so that a 64^2 grid takes the path a 1024^2 one takes on the card: K1
through the lagged Gershgorin carry, each V-cycle two strip levels (the
64^2 five-point and the 32^2 nine-point one) and a K3 tail from 16^2.  (e)
In float32 each case of the batch bit-equal to its single solve.  (f) The
gate's sides.  (g) A frozen case in the lockstep step.  (The batch against
the JAX package's: ``test_torch_batch_large_jax.py``.)
"""

import numpy as np
import torch
from torch_batch_gates import MOM, N, PRES, RES, STEPS, gates_open  # noqa: F401

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.algorithms import simple as tsimple

torch.set_num_threads(2)


def test_even_batch_cases_bit_equal_to_single_solves(gates_open):
    """In float32 (the card's dtype) at 64^2: every case of the vmapped
    large-grid batch bit-equal to its single ``simple_solve`` (state,
    histories, residual fields), whose own path is one K1, two K2a, two K2b
    and one K3 a step; Re 100 alone runs the same branch."""
    calls = gates_open
    mesh, bc = nt.StructuredMesh(nx=N, ny=N), nt.lid_driven_cavity(1.0)
    cfg = talg.SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    mom, pres = interop.config(MOM), interop.config(PRES)
    for res in (RES[:1], RES):
        calls.clear()
        out = talg.batched_cavity_solve(mesh, list(res), bc, cfg, mom, pres, device="cpu")
        assert calls["K1 batched"] == STEPS and calls["K3 batched"] == STEPS
        assert "per case" not in calls
    for re_, (bs, bd) in zip(RES, out):
        calls.clear()
        ss, sd = talg.simple_solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_),
                                   bc, nt.initialize_state(mesh, bc, device="cpu"), cfg,
                                   momentum=mom, pressure=pres, loop="fused")
        assert calls == {"K1": STEPS, "K2a": 2 * STEPS, "K2b": 2 * STEPS, "K3": STEPS}
        assert bd.iterations == sd.iterations == STEPS
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), (re_, name)
        for name in ("total_res_history", "inner_iters_history", "u_residual_field",
                     "p_residual_field"):
            assert torch.equal(getattr(bd, name), getattr(sd, name)), (re_, name)


def test_even_gate_sides(gates_open):
    """The even arm takes ``bench.py``'s large-grid SIMPLE (K1 + K2 strips +
    a K3 tail), its K1-free sibling algorithms and composed-Chebyshev
    grids below K1's gate, a hierarchy K5 takes whole, the plane layout
    where K10's gate opens, and the K8 / K9 configurations (SIMPLEC, PISO,
    SIMPLER at 2048^2), and a pressure tolerance > 0 (the cycle loop through
    ``ops/while_loop.py``); it refuses a plane layout K10 refuses, other
    cycles, smoothers and
    coarsenings, Chebyshev momentum with the compensated residual, a level
    the strips refuse above the tail, odd or non-square grids, and the CPU
    (closed gates), each of which steps case by case."""
    from dataclasses import replace

    cfg, mom, pres = talg.SIMPLEConfig(), interop.config(MOM), interop.config(PRES)
    p64 = torch.zeros(N, N)

    def ok(p=p64, mom=mom, pres=pres, algo="simple", cfg=cfg):
        return tbatch.vmap_step_ok(p, cfg, mom, pres, algo)

    for algo in ("simple", "simplec", "piso", "simpler"):
        assert ok(algo=algo), algo
    assert ok(p=torch.zeros(16, 16))  # K5 takes the whole 16^2 hierarchy
    assert ok(pres=replace(pres, tolerance=1e-3))
    assert not ok(pres=replace(pres, tolerance=1e-3, cycle_type="w"))
    assert ok(pres=replace(pres, fine_layout="plane"))  # K10 on the 64^2 planes
    assert not ok(pres=replace(pres, fine_layout="plane", omega=1.2))  # K10's gate refuses
    assert not ok(pres=replace(pres, cycle_type="w"))
    assert not ok(pres=replace(pres, smoother="jacobi"))
    assert not ok(pres=replace(pres, backend="composed"))
    assert not ok(mom=replace(mom, compensated_residual=True))
    assert not ok(mom=replace(mom, scheme="quick"))
    assert not ok(p=torch.zeros(N, N - 2)) and not ok(p=torch.zeros(N - 1, N - 1))
    # a 56^2 hierarchy: its 28^2 level is no strip and above the 14^2 tail
    assert not ok(p=torch.zeros(56, 56))
    # 2048^2: SIMPLEC, PISO and SIMPLER take K8 (and K9), SIMPLE takes K1
    big = torch.zeros(2048, 2048)
    for algo in ("simplec", "piso", "simpler"):
        assert ok(p=big, algo=algo), algo
    assert ok(p=big)
    assert ok(p=big, algo="simplec", mom=replace(mom, backend="composed"))  # no K8, no K9
    # float64 takes the kernels only where the dtype gates are widened
    assert not ok(p=torch.zeros(16, 16, dtype=torch.float64))


def test_even_gate_closed_on_cpu_steps_case_by_case(monkeypatch):
    """On the CPU (gates closed) the large-grid batch steps case by case."""
    cfg, mom, pres = talg.SIMPLEConfig(), interop.config(MOM), interop.config(PRES)
    assert not tbatch.vmap_step_ok(torch.zeros(N, N), cfg, mom, pres, "simple")
    seen = []
    real = tbatch._per_case
    monkeypatch.setattr(tbatch, "_per_case", lambda steps: seen.append(len(steps)) or real(steps))
    mesh, bc = nt.StructuredMesh(nx=16, ny=16), nt.lid_driven_cavity(1.0)
    talg.batched_cavity_solve(mesh, [100.0, 400.0], bc, talg.SIMPLEConfig(max_iterations=2),
                              mom, pres, device="cpu")
    assert seen and set(seen) == {2}


def test_even_step_frozen_case(gates_open):
    """A lockstep step with a frozen case (``batch._vmapped_step``, the K1
    path): the frozen case gets back its state, carry and info, its
    clusters' plain calls are skipped (two of three cases in each batched
    call), the active cases are those of the step without it."""
    calls = gates_open
    mesh, bc = nt.StructuredMesh(nx=N, ny=N), nt.lid_driven_cavity(1.0)
    cfg, mom, pres = talg.SIMPLEConfig(), interop.config(MOM), interop.config(PRES)
    dx, dy = mesh.get_cell_sizes()
    common = dict(dx=dx, dy=dy, rho=1.0, bc=bc, cfg=cfg, mom_cfg=mom, pres_cfg=pres,
                  lagged_rho=True)
    extra0_fn, _ = tsimple.lagged_extra0(mesh, pres, cfg, dx, dy, 1.0, tsimple.zero_carry)
    leaves, build = tbatch._flatten(tsimple.rho_extra0(extra0_fn)(torch.float32, "cpu"))
    extra = build([x.expand(3, *x.shape) for x in leaves])
    rng = np.random.default_rng(3)
    s = nt.initialize_state(mesh, bc, device="cpu")
    u, v, p = (torch.stack([x + torch.as_tensor(0.01 * rng.normal(size=x.shape),
                                                dtype=torch.float32) for _ in RES])
               for x in (s.u, s.v, s.p))
    visc = tbatch.case_conductances([1.0 / r for r in RES], dx, dy, torch.float32)
    z = torch.zeros(3)
    info = talg.base.StepInfo(z, z, z, torch.zeros(3, dtype=torch.int32), torch.zeros_like(u),
                              torch.zeros_like(v), torch.zeros_like(p))
    refresh = tbatch._vmapped_step(tsimple.make_simple_step, dict(common, coarse_mode="rebuild"),
                                   visc)
    full = refresh(u, v, p, extra, torch.ones(3, dtype=torch.bool), info)
    calls.clear()
    frozen = refresh(u, v, p, extra, torch.tensor([True, False, True]), info)
    assert calls["K1 batched"] == 1 and calls["K1"] == 2 and calls["K3"] == 2
    assert calls["K2a"] == 4 and calls["K2b"] == 4
    for k in range(3):
        assert torch.equal(frozen[k][1], (u, v, p)[k][1])
        assert torch.equal(frozen[k][0], full[k][0]) and torch.equal(frozen[k][2], full[k][2])
    for g, w in zip(tbatch._flatten(frozen[3])[0], tbatch._flatten(extra)[0]):
        assert torch.equal(g[1], w[1])
    for g, w in zip(frozen[4], info):
        assert torch.equal(g[1], w[1])
    # each active case is its single refresh step's
    for k in (0, 2):
        one = tsimple.make_simple_step(**dict(common, coarse_mode="rebuild"), mu=1.0 / RES[k])
        want = one(u[k], v[k], p[k], tsimple.rho_extra0(extra0_fn)(torch.float32, "cpu"))
        for i in range(3):
            assert torch.equal(frozen[i][k], want[i]), (k, i)
